"""Wavefront OBJ/MTL loader (numpy).

Replaces the reference's assimp import path (``AssetImporter`` over assimp,
``engine/resource/AssetImporter.h:16-46``) and the GL-material → uber-material
conversion (``RTScene.cpp:821-846``): OBJ materials map onto the uber material
as  Kd → diffuse, Ks+Ns → glossy/roughness (shininess→roughness like the
reference), Ke → emission, Ni → ior, d/Tr → opacity, illum 5/7 → mirror /
glass.

Supports: v/vn/vt, f with v, v/vt, v//vn, v/vt/vn forms, negative indices,
polygon fan triangulation, per-face material groups (usemtl), mtllib.
Normals are computed (area-weighted) where missing.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .scene import UberMaterial


@dataclass
class ObjMaterial:
    name: str
    kd: tuple = (0.8, 0.8, 0.8)
    ks: tuple = (0.0, 0.0, 0.0)
    ke: tuple = (0.0, 0.0, 0.0)
    ns: float = 0.0  # shininess
    ni: float = 1.5  # ior
    d: float = 1.0  # dissolve (opacity)
    illum: int = 2
    map_kd: str | None = None
    map_bump: str | None = None

    def to_uber(self) -> UberMaterial:
        """GL/OBJ material → uber material (RTScene.cpp:821-846 analogue):
        shininess → microfacet roughness via the reference's Blinn-Phong
        mapping, illum 5 → pure mirror, illum 7 → glass."""
        roughness = max(1e-3, (2.0 / (2.0 + self.ns)) ** 0.5) if self.ns > 0 else 1.0
        diffuse = self.kd
        glossy = self.ks
        kr = (0.0, 0.0, 0.0)
        kt = (0.0, 0.0, 0.0)
        if self.illum == 5:  # mirror
            kr = self.ks if any(self.ks) else (1.0, 1.0, 1.0)
            diffuse = (0.0, 0.0, 0.0)
            glossy = (0.0, 0.0, 0.0)
        if self.illum == 7:  # glass
            kr = (1.0, 1.0, 1.0)
            kt = (1.0, 1.0, 1.0)
            diffuse = (0.0, 0.0, 0.0)
            glossy = (0.0, 0.0, 0.0)
        return UberMaterial(
            diffuse=diffuse, glossy=glossy, kr=kr, kt=kt,
            opacity=(self.d, self.d, self.d), roughness=roughness, ior=self.ni,
        )


@dataclass
class ObjMesh:
    """One loaded OBJ: flattened indexed triangles with per-face material."""

    positions: np.ndarray  # (V, 3)
    normals: np.ndarray  # (V, 3)
    uvs: np.ndarray  # (V, 2)
    indices: np.ndarray  # (F, 3)
    face_material: np.ndarray  # (F,) index into materials
    materials: list[ObjMaterial] = field(default_factory=list)
    emissive_faces: np.ndarray | None = None  # (F,) bool (Ke non-zero)


def parse_mtl(path: str) -> dict[str, ObjMaterial]:
    mats: dict[str, ObjMaterial] = {}
    cur: ObjMaterial | None = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="ignore") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0].lower()
            if key == "newmtl":
                cur = ObjMaterial(name=parts[1] if len(parts) > 1 else "")
                mats[cur.name] = cur
            elif cur is None:
                continue
            elif key == "kd":
                cur.kd = tuple(float(x) for x in parts[1:4])
            elif key == "ks":
                cur.ks = tuple(float(x) for x in parts[1:4])
            elif key == "ke":
                cur.ke = tuple(float(x) for x in parts[1:4])
            elif key == "ns":
                cur.ns = float(parts[1])
            elif key == "ni":
                cur.ni = float(parts[1])
            elif key == "d":
                cur.d = float(parts[1])
            elif key == "tr":
                cur.d = 1.0 - float(parts[1])
            elif key == "illum":
                cur.illum = int(float(parts[1]))
            elif key == "map_kd":
                cur.map_kd = parts[-1]
            elif key in ("map_bump", "bump"):
                cur.map_bump = parts[-1]
    return mats


def _resolve_index(tok: str, count: int) -> int:
    i = int(tok)
    return i - 1 if i > 0 else count + i


def load_obj(path: str) -> ObjMesh:
    """Parse an OBJ file into a single flattened triangle mesh.

    Uses the native C++ parser (``native/mcrt_native.cpp`` via
    ``runtime.native``) for the geometry pass when available — ~10-50x
    faster on large scenes — with vectorized numpy corner dedup; falls back
    to the pure-Python line parser otherwise."""
    native = _load_obj_native(path)
    if native is not None:
        return native
    vs: list[list[float]] = []
    vns: list[list[float]] = []
    vts: list[list[float]] = []
    # corner records: (v, vt, vn) per triangle corner
    tri_corners: list[tuple] = []
    tri_mat: list[int] = []
    materials: list[ObjMaterial] = []
    mat_index: dict[str, int] = {}
    cur_mat = -1
    mtl_lib: dict[str, ObjMaterial] = {}

    base = os.path.dirname(os.path.abspath(path))
    with open(path, "r", errors="ignore") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                vs.append([float(x) for x in parts[1:4]])
            elif key == "vn":
                vns.append([float(x) for x in parts[1:4]])
            elif key == "vt":
                vts.append([float(x) for x in parts[1:3]])
            elif key == "mtllib":
                mtl_lib.update(parse_mtl(os.path.join(base, " ".join(parts[1:]))))
            elif key == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                if name not in mat_index:
                    mat_index[name] = len(materials)
                    materials.append(mtl_lib.get(name, ObjMaterial(name=name)))
                cur_mat = mat_index[name]
            elif key == "f":
                corners = []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    vi = _resolve_index(comp[0], len(vs))
                    ti = (
                        _resolve_index(comp[1], len(vts))
                        if len(comp) > 1 and comp[1]
                        else -1
                    )
                    ni = (
                        _resolve_index(comp[2], len(vns))
                        if len(comp) > 2 and comp[2]
                        else -1
                    )
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # fan triangulation
                    tri_corners.append((corners[0], corners[k], corners[k + 1]))
                    tri_mat.append(cur_mat)

    if not materials:
        materials = [ObjMaterial(name="default")]
    tri_mat_np = np.asarray(
        [m if m >= 0 else 0 for m in tri_mat], np.int32
    )

    v_np = np.asarray(vs, np.float32).reshape(-1, 3)
    vn_np = np.asarray(vns, np.float32).reshape(-1, 3) if vns else np.zeros((0, 3), np.float32)
    vt_np = np.asarray(vts, np.float32).reshape(-1, 2) if vts else np.zeros((0, 2), np.float32)

    # de-duplicate (v, vt, vn) corners into an indexed vertex buffer
    corner_map: dict[tuple, int] = {}
    positions: list = []
    normals: list = []
    uvs: list = []
    indices = np.zeros((len(tri_corners), 3), np.int32)
    need_normals = False
    for t, tri in enumerate(tri_corners):
        for c, (vi, ti, ni) in enumerate(tri):
            keyc = (vi, ti, ni)
            j = corner_map.get(keyc)
            if j is None:
                j = len(positions)
                corner_map[keyc] = j
                positions.append(v_np[vi])
                uvs.append(vt_np[ti] if 0 <= ti < len(vt_np) else (0.0, 0.0))
                if 0 <= ni < len(vn_np):
                    normals.append(vn_np[ni])
                else:
                    normals.append((0.0, 0.0, 0.0))
                    need_normals = True
            indices[t, c] = j

    pos_np = np.asarray(positions, np.float32)
    nrm_np = np.asarray(normals, np.float32)
    uv_np = np.asarray(uvs, np.float32)

    if need_normals or not len(vn_np):
        nrm_np = _area_weighted_normals(pos_np, indices, nrm_np)

    ke = np.asarray([m.ke for m in materials], np.float32)
    emissive = (
        ke[tri_mat_np].sum(-1) > 0 if len(materials) else np.zeros(len(indices), bool)
    )
    return ObjMesh(
        positions=pos_np, normals=nrm_np, uvs=uv_np, indices=indices,
        face_material=tri_mat_np, materials=materials, emissive_faces=emissive,
    )


def _load_obj_native(path: str) -> ObjMesh | None:
    """Native-parser fast path: C++ geometry parse + numpy corner dedup."""
    from ..runtime.native import parse_obj_native

    g = parse_obj_native(path)
    if g is None:
        return None

    base = os.path.dirname(os.path.abspath(path))
    mtl_lib: dict[str, ObjMaterial] = {}
    for lib in g.mtl_libs:
        mtl_lib.update(parse_mtl(os.path.join(base, lib)))
    materials = [mtl_lib.get(n, ObjMaterial(name=n)) for n in g.mat_names]
    if not materials:
        materials = [ObjMaterial(name="default")]
    tri_mat = np.where(g.f_m >= 0, g.f_m, 0).astype(np.int32)

    # vectorized (v, vt, vn) corner dedup -> indexed vertex buffer
    ntri = g.f_v.shape[0]
    corners = np.stack(
        [g.f_v.reshape(-1), g.f_vt.reshape(-1), g.f_vn.reshape(-1)], axis=1
    )
    uniq, inverse = np.unique(corners, axis=0, return_inverse=True)
    indices = inverse.reshape(ntri, 3).astype(np.int32)
    vi, ti, ni = uniq[:, 0], uniq[:, 1], uniq[:, 2]
    pos_np = g.v[np.clip(vi, 0, max(len(g.v) - 1, 0))]
    uv_np = np.where(
        ((ti >= 0) & (ti < len(g.vt)))[:, None],
        g.vt[np.clip(ti, 0, max(len(g.vt) - 1, 0))] if len(g.vt) else np.zeros((len(ti), 2), np.float32),
        0.0,
    ).astype(np.float32)
    has_n = (ni >= 0) & (ni < len(g.vn))
    nrm_np = np.where(
        has_n[:, None],
        g.vn[np.clip(ni, 0, max(len(g.vn) - 1, 0))] if len(g.vn) else np.zeros((len(ni), 3), np.float32),
        0.0,
    ).astype(np.float32)
    if not has_n.all():
        nrm_np = _area_weighted_normals(pos_np, indices, nrm_np)

    ke = np.asarray([m.ke for m in materials], np.float32)
    emissive = ke[tri_mat].sum(-1) > 0
    return ObjMesh(
        positions=pos_np, normals=nrm_np, uvs=uv_np, indices=indices,
        face_material=tri_mat, materials=materials, emissive_faces=emissive,
    )


def _area_weighted_normals(pos, idx, existing):
    out = existing.copy()
    acc = np.zeros_like(pos)
    p = pos[idx]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    for k in range(3):
        np.add.at(acc, idx[:, k], fn)
    lens = np.linalg.norm(acc, axis=-1, keepdims=True)
    acc = acc / np.maximum(lens, 1e-12)
    missing = np.linalg.norm(out, axis=-1) < 1e-6
    out[missing] = acc[missing]
    return out
