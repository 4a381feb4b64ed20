// Native runtime kernels for mcrt_tpu (host side).
//
// Equivalents of the reference's performance-critical native
// components:
//   - obj_*:  fast Wavefront OBJ geometry parser — the role of assimp in the
//     reference's import path (AssetImporter over assimp,
//     source/engine/resource/AssetImporter.h:16-46).  San-Miguel-scale OBJ
//     files are tens of MB; Python line parsing is ~50x slower.
//   - sah_build_blocks: top-down binned-SAH partitioner — the role of the
//     reference's CPU SAH builders (RadeonRays Bvh::Build / FindSahSplit,
//     third_party/RadeonRays/RadeonRays/src/accelerator/bvh.h:39-110) —
//     emitting the *block decomposition* consumed by the Pallas blocked
//     intersector: leaves of <= block_size triangles, DFS order (so
//     consecutive blocks share ancestry and super-block unions stay tight).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).
// Build: make -C native   ->  native/libmcrt_native.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parser
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> v;      // (nv, 3)
  std::vector<float> vn;     // (nvn, 3)
  std::vector<float> vt;     // (nvt, 2)
  std::vector<int32_t> f_v;  // (ntri, 3) vertex ids (0-based)
  std::vector<int32_t> f_vt; // (ntri, 3) texcoord ids (-1 = none)
  std::vector<int32_t> f_vn; // (ntri, 3) normal ids (-1 = none)
  std::vector<int32_t> f_m;  // (ntri,) material slot
  std::vector<std::string> mat_names;
  std::vector<std::string> mtl_libs;
};

static const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// OBJ keywords may be followed by spaces OR tabs (the cornell-box fixtures
// use "v\t-0.24 ..."); treating tab-delimited records as unknown silently
// drops vertices and shifts every later face index
static bool is_sp(char c) { return c == ' ' || c == '\t'; }

static const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

static const char* parse_float(const char* p, const char* end, float* out) {
  char* q = nullptr;
  *out = strtof(p, &q);
  return q && q <= end ? q : p;
}

// parse one face corner "v", "v/vt", "v//vn", "v/vt/vn"; ids 1-based or
// negative (relative); returns pointer past the corner
static const char* parse_corner(const char* p, const char* end, int32_t nv,
                                int32_t nvt, int32_t nvn, int32_t* vi,
                                int32_t* ti, int32_t* ni) {
  char* q = nullptr;
  long a = strtol(p, &q, 10);
  *vi = a > 0 ? (int32_t)(a - 1) : (int32_t)(nv + a);
  *ti = -1;
  *ni = -1;
  p = q;
  if (p < end && *p == '/') {
    ++p;
    if (p < end && *p != '/') {
      long b = strtol(p, &q, 10);
      *ti = b > 0 ? (int32_t)(b - 1) : (int32_t)(nvt + b);
      p = q;
    }
    if (p < end && *p == '/') {
      ++p;
      long c = strtol(p, &q, 10);
      *ni = c > 0 ? (int32_t)(c - 1) : (int32_t)(nvn + c);
      p = q;
    }
  }
  return p;
}

void* obj_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize((size_t)size);
  if (size > 0 && fread(&buf[0], 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  ObjData* d = new ObjData();
  const char* p = buf.data();
  const char* end = p + buf.size();
  int32_t cur_mat = -1;
  std::vector<int32_t> cvi, cti, cni;  // polygon corner scratch

  while (p < end) {
    p = skip_ws(p, end);
    const char* eol = p;
    while (eol < end && *eol != '\n') ++eol;
    if (p >= end) break;
    if (p[0] == 'v' && p + 1 < end && is_sp(p[1])) {
      float x = 0, y = 0, z = 0;
      const char* q = p + 2;
      q = parse_float(q, eol, &x);
      q = parse_float(q, eol, &y);
      q = parse_float(q, eol, &z);
      d->v.push_back(x);
      d->v.push_back(y);
      d->v.push_back(z);
    } else if (p[0] == 'v' && p + 1 < end && p[1] == 'n' && p + 2 < end &&
               is_sp(p[2])) {
      float x = 0, y = 0, z = 0;
      const char* q = p + 3;
      q = parse_float(q, eol, &x);
      q = parse_float(q, eol, &y);
      q = parse_float(q, eol, &z);
      d->vn.push_back(x);
      d->vn.push_back(y);
      d->vn.push_back(z);
    } else if (p[0] == 'v' && p + 1 < end && p[1] == 't' && p + 2 < end &&
               is_sp(p[2])) {
      float x = 0, y = 0;
      const char* q = p + 3;
      q = parse_float(q, eol, &x);
      q = parse_float(q, eol, &y);
      d->vt.push_back(x);
      d->vt.push_back(y);
    } else if (p[0] == 'f' && p + 1 < end && is_sp(p[1])) {
      cvi.clear();
      cti.clear();
      cni.clear();
      const char* q = p + 1;
      int32_t nv = (int32_t)(d->v.size() / 3);
      int32_t nvt = (int32_t)(d->vt.size() / 2);
      int32_t nvn = (int32_t)(d->vn.size() / 3);
      while (true) {
        q = skip_ws(q, eol);
        if (q >= eol || *q == '\n' || *q == '#') break;
        int32_t vi, ti, ni;
        const char* q2 = parse_corner(q, eol, nv, nvt, nvn, &vi, &ti, &ni);
        if (q2 == q) break;
        q = q2;
        cvi.push_back(vi);
        cti.push_back(ti);
        cni.push_back(ni);
      }
      // polygon fan triangulation (matches the python loader)
      for (size_t k = 2; k < cvi.size(); ++k) {
        d->f_v.push_back(cvi[0]);
        d->f_v.push_back(cvi[k - 1]);
        d->f_v.push_back(cvi[k]);
        d->f_vt.push_back(cti[0]);
        d->f_vt.push_back(cti[k - 1]);
        d->f_vt.push_back(cti[k]);
        d->f_vn.push_back(cni[0]);
        d->f_vn.push_back(cni[k - 1]);
        d->f_vn.push_back(cni[k]);
        d->f_m.push_back(cur_mat);
      }
    } else if (!strncmp(p, "usemtl", 6)) {
      const char* q = skip_ws(p + 6, eol);
      std::string name(q, eol - q);
      while (!name.empty() &&
             (name.back() == '\r' || name.back() == ' ' ||
              name.back() == '\t')) name.pop_back();
      cur_mat = -1;
      for (size_t i = 0; i < d->mat_names.size(); ++i)
        if (d->mat_names[i] == name) { cur_mat = (int32_t)i; break; }
      if (cur_mat < 0) {
        cur_mat = (int32_t)d->mat_names.size();
        d->mat_names.push_back(name);
      }
    } else if (!strncmp(p, "mtllib", 6)) {
      const char* q = skip_ws(p + 6, eol);
      std::string name(q, eol - q);
      while (!name.empty() &&
             (name.back() == '\r' || name.back() == ' ' ||
              name.back() == '\t')) name.pop_back();
      d->mtl_libs.push_back(name);
    }
    p = next_line(eol, end);
  }
  return d;
}

void obj_counts(void* h, int64_t* nv, int64_t* nvn, int64_t* nvt,
                int64_t* ntri, int64_t* nmat, int64_t* nlib) {
  ObjData* d = (ObjData*)h;
  *nv = (int64_t)(d->v.size() / 3);
  *nvn = (int64_t)(d->vn.size() / 3);
  *nvt = (int64_t)(d->vt.size() / 2);
  *ntri = (int64_t)(d->f_v.size() / 3);
  *nmat = (int64_t)d->mat_names.size();
  *nlib = (int64_t)d->mtl_libs.size();
}

void obj_fill(void* h, float* v, float* vn, float* vt, int32_t* f_v,
              int32_t* f_vt, int32_t* f_vn, int32_t* f_m) {
  ObjData* d = (ObjData*)h;
  memcpy(v, d->v.data(), d->v.size() * sizeof(float));
  memcpy(vn, d->vn.data(), d->vn.size() * sizeof(float));
  memcpy(vt, d->vt.data(), d->vt.size() * sizeof(float));
  memcpy(f_v, d->f_v.data(), d->f_v.size() * sizeof(int32_t));
  memcpy(f_vt, d->f_vt.data(), d->f_vt.size() * sizeof(int32_t));
  memcpy(f_vn, d->f_vn.data(), d->f_vn.size() * sizeof(int32_t));
  memcpy(f_m, d->f_m.data(), d->f_m.size() * sizeof(int32_t));
}

const char* obj_mat_name(void* h, int64_t i) {
  ObjData* d = (ObjData*)h;
  return d->mat_names[(size_t)i].c_str();
}

const char* obj_mtl_lib(void* h, int64_t i) {
  ObjData* d = (ObjData*)h;
  return d->mtl_libs[(size_t)i].c_str();
}

void obj_free(void* h) { delete (ObjData*)h; }

// ---------------------------------------------------------------------------
// Binned-SAH block partitioner
// ---------------------------------------------------------------------------

struct Box {
  float lo[3], hi[3];
  void reset() {
    lo[0] = lo[1] = lo[2] = 3.0e38f;
    hi[0] = hi[1] = hi[2] = -3.0e38f;
  }
  void grow(const float* p) {
    for (int a = 0; a < 3; ++a) {
      if (p[a] < lo[a]) lo[a] = p[a];
      if (p[a] > hi[a]) hi[a] = p[a];
    }
  }
  void grow(const Box& b) {
    for (int a = 0; a < 3; ++a) {
      if (b.lo[a] < lo[a]) lo[a] = b.lo[a];
      if (b.hi[a] > hi[a]) hi[a] = b.hi[a];
    }
  }
  float area() const {
    float dx = hi[0] - lo[0], dy = hi[1] - lo[1], dz = hi[2] - lo[2];
    if (dx < 0 || dy < 0 || dz < 0) return 0.f;
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

// Top-down binned SAH over triangle centroids; recursion splits until a node
// holds <= block_size triangles, then emits the node as a block in DFS order.
// Mirrors Bvh::FindSahSplit's binned cost sweep (bvh.h:39-110) but stops at
// block granularity — the traversal hierarchy itself (block + super AABBs) is
// rebuilt by the Pallas accel packer on top of this ordering.
struct SahCtx {
  const float* cent;   // (n, 3)
  const Box* boxes;    // (n,)
  int32_t* order;      // (n,) permutation being built
  int32_t* block_start;  // capacity n+1
  int32_t n_blocks = 0;
  int32_t emitted = 0;
  int32_t block_size;
  int32_t bins;
};

static void sah_recurse(SahCtx& c, int32_t* ids, int32_t count) {
  if (count <= c.block_size) {
    c.block_start[c.n_blocks++] = c.emitted;
    memcpy(c.order + c.emitted, ids, count * sizeof(int32_t));
    c.emitted += count;
    return;
  }
  // centroid bounds
  Box cb;
  cb.reset();
  for (int32_t i = 0; i < count; ++i) cb.grow(c.cent + 3 * ids[i]);
  int axis = 0;
  float ext[3] = {cb.hi[0] - cb.lo[0], cb.hi[1] - cb.lo[1],
                  cb.hi[2] - cb.lo[2]};
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;

  int32_t mid = count / 2;
  if (ext[axis] < 1e-12f) {
    // degenerate: median split by index
  } else {
    const int B = c.bins;
    std::vector<Box> bin_box(B);
    std::vector<int32_t> bin_cnt(B, 0);
    for (int b = 0; b < B; ++b) bin_box[b].reset();
    float scale = (float)B / ext[axis];
    for (int32_t i = 0; i < count; ++i) {
      int b = (int)((c.cent[3 * ids[i] + axis] - cb.lo[axis]) * scale);
      if (b >= B) b = B - 1;
      if (b < 0) b = 0;
      bin_cnt[b]++;
      bin_box[b].grow(c.boxes[ids[i]]);
    }
    // suffix sweep
    std::vector<float> right_area(B);
    std::vector<int32_t> right_cnt(B);
    Box acc;
    acc.reset();
    int32_t cnt = 0;
    for (int b = B - 1; b >= 1; --b) {
      acc.grow(bin_box[b]);
      cnt += bin_cnt[b];
      right_area[b] = acc.area();
      right_cnt[b] = cnt;
    }
    // prefix sweep: pick min SAH cost split
    float best_cost = 3.0e38f;
    int best_b = -1;
    acc.reset();
    cnt = 0;
    for (int b = 0; b < B - 1; ++b) {
      acc.grow(bin_box[b]);
      cnt += bin_cnt[b];
      if (cnt == 0 || cnt == count) continue;
      float cost = acc.area() * (float)cnt +
                   right_area[b + 1] * (float)right_cnt[b + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best_b = b;
      }
    }
    if (best_b >= 0) {
      // in-place partition by bin id
      float split = cb.lo[axis] + (best_b + 1) * ext[axis] / (float)c.bins;
      int32_t i = 0, j = count - 1;
      while (i <= j) {
        if (c.cent[3 * ids[i] + axis] <= split) {
          ++i;
        } else {
          int32_t t = ids[i];
          ids[i] = ids[j];
          ids[j] = t;
          --j;
        }
      }
      if (i > 0 && i < count) mid = i;
    }
  }
  sah_recurse(c, ids, mid);
  sah_recurse(c, ids + mid, count - mid);
}

// ---------------------------------------------------------------------------
// SBVH block partitioner: binned SAH with spatial splits
// (split_bvh.h:30-45 / Stich et al. 2009).  Works on *references*
// (triangle id + clipped AABB): where the object split's left/right boxes
// overlap badly, a spatial split duplicates straddling references with
// plane-clipped bounds instead — tighter blocks for long skinny triangles.
// ---------------------------------------------------------------------------

struct Ref {
  int32_t tri;
  Box box;
};

// Clip a triangle's AABB contribution to the half-space [axis] <= / >= pos
// by clipping the triangle polygon against the plane (exact SBVH chop).
static Box clip_tri_box(const float* p0, const float* p1, const float* p2,
                        int axis, float pos, bool keep_below,
                        const Box& ref_box) {
  const float* v[3] = {p0, p1, p2};
  // Sutherland-Hodgman against one plane
  float poly[8][3];
  int n = 0;
  for (int i = 0; i < 3; ++i) {
    const float* a = v[i];
    const float* b = v[(i + 1) % 3];
    float da = keep_below ? (pos - a[axis]) : (a[axis] - pos);
    float db = keep_below ? (pos - b[axis]) : (b[axis] - pos);
    if (da >= 0) {
      memcpy(poly[n++], a, 3 * sizeof(float));
    }
    if ((da >= 0) != (db >= 0)) {
      float t = da / (da - db);
      for (int k = 0; k < 3; ++k) poly[n][k] = a[k] + t * (b[k] - a[k]);
      ++n;
    }
  }
  Box out;
  out.reset();
  for (int i = 0; i < n; ++i) out.grow(poly[i]);
  // intersect with the (possibly already clipped) reference box
  for (int a = 0; a < 3; ++a) {
    if (out.lo[a] < ref_box.lo[a]) out.lo[a] = ref_box.lo[a];
    if (out.hi[a] > ref_box.hi[a]) out.hi[a] = ref_box.hi[a];
  }
  return out;
}

struct SbvhCtx {
  const float* pos;
  const int32_t* idx;
  std::vector<Ref> out_refs;   // emitted refs in DFS block order
  std::vector<int32_t> block_start;
  int32_t block_size;
  int32_t bins;
  int32_t max_split_depth;
  float min_overlap_area;  // absolute area threshold (root area * fraction)
  int64_t ref_budget;      // max total refs
  int64_t live_refs = 0;   // current total (for the budget)
};

static void sbvh_recurse(SbvhCtx& c, std::vector<Ref>& refs, int depth) {
  int32_t count = (int32_t)refs.size();
  if (count <= c.block_size) {
    c.block_start.push_back((int32_t)c.out_refs.size());
    for (auto& r : refs) c.out_refs.push_back(r);
    return;
  }
  Box cb;  // centroid bounds
  cb.reset();
  Box nb;  // node bounds
  nb.reset();
  for (auto& r : refs) {
    float cent[3];
    for (int a = 0; a < 3; ++a) cent[a] = 0.5f * (r.box.lo[a] + r.box.hi[a]);
    cb.grow(cent);
    nb.grow(r.box);
  }
  int axis = 0;
  float ext[3] = {cb.hi[0] - cb.lo[0], cb.hi[1] - cb.lo[1],
                  cb.hi[2] - cb.lo[2]};
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;

  const int B = c.bins;
  int32_t mid = count / 2;
  bool use_spatial = false;
  float obj_split = 0.f, spat_split = 0.f;

  if (ext[axis] >= 1e-12f) {
    // ---- object split (binned over centroids)
    std::vector<Box> bin_box(B);
    std::vector<int32_t> bin_cnt(B, 0);
    for (int b = 0; b < B; ++b) bin_box[b].reset();
    float scale = (float)B / ext[axis];
    for (auto& r : refs) {
      float cent = 0.5f * (r.box.lo[axis] + r.box.hi[axis]);
      int b = (int)((cent - cb.lo[axis]) * scale);
      if (b >= B) b = B - 1;
      if (b < 0) b = 0;
      bin_cnt[b]++;
      bin_box[b].grow(r.box);
    }
    std::vector<float> right_area(B);
    std::vector<int32_t> right_cnt(B);
    Box acc;
    acc.reset();
    int32_t cnt = 0;
    for (int b = B - 1; b >= 1; --b) {
      acc.grow(bin_box[b]);
      cnt += bin_cnt[b];
      right_area[b] = acc.area();
      right_cnt[b] = cnt;
    }
    float best_obj = 3.0e38f;
    int best_b = -1;
    Box best_lbox;
    acc.reset();
    cnt = 0;
    for (int b = 0; b < B - 1; ++b) {
      acc.grow(bin_box[b]);
      cnt += bin_cnt[b];
      if (cnt == 0 || cnt == count) continue;
      float cost = acc.area() * (float)cnt +
                   right_area[b + 1] * (float)right_cnt[b + 1];
      if (cost < best_obj) {
        best_obj = cost;
        best_b = b;
        best_lbox = acc;
      }
    }
    if (best_b >= 0) {
      obj_split = cb.lo[axis] + (best_b + 1) * ext[axis] / (float)B;
      // overlap of the object split's child boxes
      Box rbox;
      rbox.reset();
      for (int b = best_b + 1; b < B; ++b) rbox.grow(bin_box[b]);
      Box ov;
      for (int a = 0; a < 3; ++a) {
        ov.lo[a] = best_lbox.lo[a] > rbox.lo[a] ? best_lbox.lo[a] : rbox.lo[a];
        ov.hi[a] = best_lbox.hi[a] < rbox.hi[a] ? best_lbox.hi[a] : rbox.hi[a];
      }
      bool overlapping = ov.hi[0] > ov.lo[0] && ov.hi[1] > ov.lo[1] &&
                         ov.hi[2] > ov.lo[2];
      // ---- spatial split candidate (chopped binning over the node box)
      float next = c.live_refs + count * 0.2f;  // rough growth estimate
      if (overlapping && ov.area() > c.min_overlap_area &&
          depth < c.max_split_depth && next < (float)c.ref_budget) {
        float next_lo = nb.lo[axis], next_hi = nb.hi[axis];
        float sext = next_hi - next_lo;
        if (sext > 1e-12f) {
          float sscale = (float)B / sext;
          std::vector<Box> sb_box(B);
          std::vector<int32_t> entry(B, 0), exit_(B, 0);
          for (int b = 0; b < B; ++b) sb_box[b].reset();
          for (auto& r : refs) {
            int b0 = (int)((r.box.lo[axis] - next_lo) * sscale);
            int b1 = (int)((r.box.hi[axis] - next_lo) * sscale);
            if (b0 < 0) b0 = 0;
            if (b0 >= B) b0 = B - 1;
            if (b1 < 0) b1 = 0;
            if (b1 >= B) b1 = B - 1;
            entry[b0]++;
            exit_[b1]++;
            const int32_t* t = c.idx + 3 * r.tri;
            if (b0 == b1) {
              sb_box[b0].grow(r.box);
            } else {
              // chop the reference across its bin span
              for (int b = b0; b <= b1; ++b) {
                float lo_p = next_lo + b * sext / (float)B;
                float hi_p = next_lo + (b + 1) * sext / (float)B;
                Box piece = r.box;
                if (b > b0) {
                  Box keep = clip_tri_box(c.pos + 3 * t[0], c.pos + 3 * t[1],
                                          c.pos + 3 * t[2], axis, lo_p, false,
                                          r.box);
                  piece = keep;
                }
                if (b < b1) {
                  Box keep = clip_tri_box(c.pos + 3 * t[0], c.pos + 3 * t[1],
                                          c.pos + 3 * t[2], axis, hi_p, true,
                                          piece);
                  piece = keep;
                }
                if (piece.hi[0] >= piece.lo[0]) sb_box[b].grow(piece);
              }
            }
          }
          // sweep: left of plane b collects entries < b, right collects
          // exits >= b
          std::vector<float> r_area(B);
          std::vector<int32_t> r_cnt(B);
          Box racc;
          racc.reset();
          int32_t rc = 0;
          for (int b = B - 1; b >= 1; --b) {
            racc.grow(sb_box[b]);
            rc += exit_[b];
            r_area[b] = racc.area();
            r_cnt[b] = rc;
          }
          Box lacc;
          lacc.reset();
          int32_t lc = 0;
          float best_spat = 3.0e38f;
          int best_sb = -1;
          for (int b = 0; b < B - 1; ++b) {
            lacc.grow(sb_box[b]);
            lc += entry[b];
            if (lc == 0 || r_cnt[b + 1] == 0) continue;
            float cost = lacc.area() * (float)lc +
                         r_area[b + 1] * (float)r_cnt[b + 1];
            if (cost < best_spat) {
              best_spat = cost;
              best_sb = b;
            }
          }
          if (best_sb >= 0 && best_spat < best_obj) {
            use_spatial = true;
            spat_split = next_lo + (best_sb + 1) * sext / (float)B;
          }
        }
      }
    }

    if (use_spatial) {
      std::vector<Ref> left, right;
      left.reserve(count);
      right.reserve(count);
      for (auto& r : refs) {
        if (r.box.hi[axis] <= spat_split) {
          left.push_back(r);
        } else if (r.box.lo[axis] >= spat_split) {
          right.push_back(r);
        } else {
          const int32_t* t = c.idx + 3 * r.tri;
          Ref l = r, rr = r;
          l.box = clip_tri_box(c.pos + 3 * t[0], c.pos + 3 * t[1],
                               c.pos + 3 * t[2], axis, spat_split, true,
                               r.box);
          rr.box = clip_tri_box(c.pos + 3 * t[0], c.pos + 3 * t[1],
                                c.pos + 3 * t[2], axis, spat_split, false,
                                r.box);
          if (l.box.hi[0] >= l.box.lo[0]) left.push_back(l);
          if (rr.box.hi[0] >= rr.box.lo[0]) right.push_back(rr);
          c.live_refs++;
        }
      }
      if (!left.empty() && !right.empty() &&
          (int32_t)left.size() < count + count / 2 &&
          (int32_t)right.size() < count + count / 2) {
        refs.clear();
        refs.shrink_to_fit();
        sbvh_recurse(c, left, depth + 1);
        sbvh_recurse(c, right, depth + 1);
        return;
      }
      // degenerate spatial partition: fall through to object split
      use_spatial = false;
    }

    if (best_b >= 0) {
      // object split partition by centroid
      std::vector<Ref> left, right;
      left.reserve(count);
      right.reserve(count);
      for (auto& r : refs) {
        float cent = 0.5f * (r.box.lo[axis] + r.box.hi[axis]);
        (cent <= obj_split ? left : right).push_back(r);
      }
      if (!left.empty() && !right.empty()) {
        refs.clear();
        refs.shrink_to_fit();
        sbvh_recurse(c, left, depth + 1);
        sbvh_recurse(c, right, depth + 1);
        return;
      }
    }
  }
  // degenerate: median split by index
  std::vector<Ref> left(refs.begin(), refs.begin() + mid);
  std::vector<Ref> right(refs.begin() + mid, refs.end());
  refs.clear();
  refs.shrink_to_fit();
  sbvh_recurse(c, left, depth + 1);
  sbvh_recurse(c, right, depth + 1);
}

static SbvhCtx* g_sbvh_result = nullptr;

// Phase 1: run the SBVH build; returns total ref count (may exceed ntri via
// duplication).  Results are fetched by sbvh_fetch + freed by sbvh_free.
int64_t sbvh_build_blocks(const float* positions, const int32_t* indices,
                          int32_t ntri, int32_t block_size, int32_t bins,
                          int32_t max_split_depth, float min_overlap,
                          float extra_refs_budget) {
  SbvhCtx* c = new SbvhCtx();
  c->pos = positions;
  c->idx = indices;
  c->block_size = block_size;
  c->bins = bins < 2 ? 2 : bins;
  c->max_split_depth = max_split_depth;
  c->ref_budget = (int64_t)(ntri * (1.0f + extra_refs_budget));
  c->live_refs = ntri;

  std::vector<Ref> refs((size_t)ntri);
  Box root;
  root.reset();
  for (int32_t i = 0; i < ntri; ++i) {
    refs[i].tri = i;
    refs[i].box.reset();
    for (int k = 0; k < 3; ++k)
      refs[i].box.grow(positions + 3 * indices[3 * i + k]);
    root.grow(refs[i].box);
  }
  c->min_overlap_area = min_overlap * root.area();
  sbvh_recurse(*c, refs, 0);
  c->block_start.push_back((int32_t)c->out_refs.size());

  delete g_sbvh_result;
  g_sbvh_result = c;
  return (int64_t)c->out_refs.size();
}

// Phase 2: copy out refs (tri ids), per-ref clipped bounds (n_refs, 6), and
// block starts (n_blocks + 1).  Returns n_blocks.
int32_t sbvh_fetch(int32_t* out_tri, float* out_bounds,
                   int32_t* out_block_start) {
  SbvhCtx* c = g_sbvh_result;
  if (!c) return -1;
  for (size_t i = 0; i < c->out_refs.size(); ++i) {
    out_tri[i] = c->out_refs[i].tri;
    for (int a = 0; a < 3; ++a) {
      out_bounds[6 * i + a] = c->out_refs[i].box.lo[a];
      out_bounds[6 * i + 3 + a] = c->out_refs[i].box.hi[a];
    }
  }
  for (size_t i = 0; i < c->block_start.size(); ++i)
    out_block_start[i] = c->block_start[i];
  int32_t nb = (int32_t)c->block_start.size() - 1;
  delete c;
  g_sbvh_result = nullptr;
  return nb;
}

// positions: (nv, 3) f32; indices: (ntri, 3) i32.
// out_order: (ntri,) permutation; out_block_start: (ntri + 1,) block offsets
// (n_blocks + 1 entries used).  Returns n_blocks.
int32_t sah_build_blocks(const float* positions, const int32_t* indices,
                         int32_t ntri, int32_t block_size, int32_t bins,
                         int32_t* out_order, int32_t* out_block_start) {
  std::vector<float> cent((size_t)ntri * 3);
  std::vector<Box> boxes((size_t)ntri);
  for (int32_t i = 0; i < ntri; ++i) {
    Box& b = boxes[i];
    b.reset();
    for (int k = 0; k < 3; ++k) b.grow(positions + 3 * indices[3 * i + k]);
    for (int a = 0; a < 3; ++a) cent[3 * i + a] = 0.5f * (b.lo[a] + b.hi[a]);
  }
  std::vector<int32_t> ids((size_t)ntri);
  for (int32_t i = 0; i < ntri; ++i) ids[i] = i;

  SahCtx c;
  c.cent = cent.data();
  c.boxes = boxes.data();
  c.order = out_order;
  c.block_start = out_block_start;
  c.block_size = block_size;
  c.bins = bins < 2 ? 2 : bins;
  sah_recurse(c, ids.data(), ntri);
  c.block_start[c.n_blocks] = c.emitted;
  return c.n_blocks;
}

}  // extern "C"
