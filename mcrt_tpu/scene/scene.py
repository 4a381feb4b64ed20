"""Scene pytree — the device scene as a struct-of-arrays pytree.

Re-design of the reference's scene plumbing: the ``RTDeviceScene``
buffer set (``assets/kernels/kernel_data.h:278-294``), the per-shape records
(``RTShape``, ``kernel_data.h:36-52``), the uber-material SoA
(``RTMaterial``, ``kernel_data.h:87-113``), and the light table (``RTLight``,
``kernel_data.h:137-152``) uploaded by ``RTScene``
(``source/.../raytracing/scene/RTScene.cpp:564-678, 768-809``).

Differences from the reference, by design:
- Geometry is pre-transformed to world space at build (the reference keeps
  object space + per-shape transforms and instances; instancing lands with the
  two-level accel).  Per-shape transforms are retained for dynamic updates.
- Everything is a flat, statically-shaped jnp array: triangle count padded to a
  lane multiple, invalid entries masked.  The scene is a pytree, so it shards
  with ``NamedSharding`` and differentiates with ``jax.grad`` out of the box.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core.pytree import PyTreeNode, field

# light types — matches the reference's component set (engine/rendering/lights/)
LIGHT_DIRECTIONAL = 0
LIGHT_POINT = 1
LIGHT_DISK = 2
LIGHT_MESH = 3  # triangle-mesh area light

# texture slot indices into Materials.tex (8 optional maps,
# cf. getUberMaterialProperties, materials.cl:67-91 + normal map :14-30)
TEX_DIFFUSE = 0
TEX_GLOSSY = 1
TEX_KR = 2
TEX_KT = 3
TEX_OPACITY = 4
TEX_ROUGHNESS = 5
TEX_IOR = 6
TEX_NORMAL = 7
N_TEX_SLOTS = 8


class Geometry(PyTreeNode):
    """Flattened world-space triangle soup (``RTScene::attachMesh`` concatenates
    submeshes the same way, ``RTScene.cpp:564-678``).

    ``face_attrs`` is a denormalized per-face copy of everything the shading
    path needs — vertex positions/normals/uvs plus the face's material and
    light ids (``RTShape`` lookups folded in).  ONE (F, 32) gather by
    primitive id replaces the six distinct-index sweeps of the normalized
    layout (3 vertex-index indirections + shape->material + shape->light),
    at ~128 B/face of extra device memory."""

    positions: jax.Array  # (V, 3) f32 world space
    normals: jax.Array  # (V, 3) f32
    uvs: jax.Array  # (V, 2) f32
    indices: jax.Array  # (F, 3) i32
    face_shape: jax.Array  # (F,) i32 shape id per face
    face_valid: jax.Array  # (F,) bool (False on padding faces)
    face_attrs: jax.Array  # (F, 32) f32 packed shading attributes (FA_* cols)
    # static: scene carries instanced shapes -> shading transforms face
    # attributes by the hit shape's to_world (``RTShape`` transform applied
    # at vertex fetch, ``geometry.cl:30-90``); False compiles the transform
    # away entirely
    instanced: bool = field(pytree_node=False, default=False)

    @property
    def num_faces(self) -> int:
        return self.indices.shape[0]

    def face_vertices(self, prim: jax.Array):
        """Gather the 3 vertices of triangle `prim` ((...,) i32) -> 3x (..., 3)."""
        idx = jnp.take(self.indices, prim, axis=0, mode="clip")
        p0 = jnp.take(self.positions, idx[..., 0], axis=0, mode="clip")
        p1 = jnp.take(self.positions, idx[..., 1], axis=0, mode="clip")
        p2 = jnp.take(self.positions, idx[..., 2], axis=0, mode="clip")
        return p0, p1, p2


# packed face_attrs column layout (f32; ids stored as exact small floats)
FA_P0, FA_P1, FA_P2 = 0, 3, 6       # 3 cols each
FA_N0, FA_N1, FA_N2 = 9, 12, 15     # 3 cols each
FA_UV0, FA_UV1, FA_UV2 = 18, 20, 22  # 2 cols each
FA_MAT, FA_LIGHT = 24, 25
FA_COLS = 32  # padded to a power of two for clean lane tiling


def pack_face_attrs(positions: jax.Array, normals: jax.Array, uvs: jax.Array,
                    indices: jax.Array, face_shape: jax.Array,
                    face_valid: jax.Array, shape_material: jax.Array,
                    shape_light: jax.Array) -> jax.Array:
    """Build the (F, 32) packed per-face shading table (device-side, so
    dynamic updates can rebuild it inside jit)."""
    f = indices.shape[0]
    cols = []
    for k in range(3):
        cols.append(jnp.take(positions, indices[:, k], axis=0, mode="clip"))
    for k in range(3):
        cols.append(jnp.take(normals, indices[:, k], axis=0, mode="clip"))
    for k in range(3):
        cols.append(jnp.take(uvs, indices[:, k], axis=0, mode="clip"))
    shp = jnp.maximum(face_shape, 0)
    mat = jnp.take(shape_material, shp, axis=0, mode="clip")
    lgt = jnp.take(shape_light, shp, axis=0, mode="clip")
    mat = jnp.where(face_valid, mat, -1)
    lgt = jnp.where(face_valid, lgt, -1)
    cols.append(mat.astype(jnp.float32)[:, None])
    cols.append(lgt.astype(jnp.float32)[:, None])
    packed = jnp.concatenate(cols, axis=1)
    pad = FA_COLS - packed.shape[1]
    return jnp.concatenate([packed, jnp.zeros((f, pad), jnp.float32)], axis=1)


class Shapes(PyTreeNode):
    """Per-shape records (``RTShape``, ``kernel_data.h:36-52``)."""

    material: jax.Array  # (S,) i32
    light: jax.Array  # (S,) i32 area light id, -1 if none
    to_world: jax.Array  # (S, 4, 4) f32 (identity for baked shapes;
    #   instanced shapes carry their live transform, RTShape-style)
    normal_mat: jax.Array  # (S, 3, 3) f32 inverse-transpose of to_world[:3,:3]


class Instances(PyTreeNode):
    """Instanced-shape registry (``IntersectionApi::CreateInstance``
    analogue, ``radeon_rays.h:223-227``): each instance is a SHAPE whose
    geometry is the face range of a source mesh held once in the global
    face table, positioned by ``shapes.to_world[shape]``.  Face ranges are
    static (build-time) metadata for the two-level accel builder."""

    shape: jax.Array  # (I,) i32 shape id of each instance
    src_shape: jax.Array  # (I,) i32 source shape id
    face_lo: tuple = field(pytree_node=False, default=())  # per-inst
    face_hi: tuple = field(pytree_node=False, default=())

    @property
    def num(self) -> int:
        return len(self.face_lo)


class Materials(PyTreeNode):
    """Uber-material SoA (``RTMaterial``, ``kernel_data.h:87-113``): every
    material is the PBRT-style uber material; unused lobes are black.

    ``used_slots`` is a STATIC per-slot mask (known at trace time): a texture
    slot no material in the scene binds compiles to zero gathers — the
    static counterpart of the reference's per-hit ``texId >= 0`` branches
    (``materials.cl:67-91``), hoisted from per-lane to per-program."""

    diffuse: jax.Array  # (M, 3)
    glossy: jax.Array  # (M, 3) microfacet reflection tint
    kr: jax.Array  # (M, 3) specular reflection
    kt: jax.Array  # (M, 3) specular transmission
    opacity: jax.Array  # (M, 3) 1 = opaque; <1 adds pass-through transmission
    roughness: jax.Array  # (M,)
    ior: jax.Array  # (M,)
    tex: jax.Array  # (M, 8) i32 texture ids per slot, -1 = none
    # conductor Fresnel for kr (``sampleSpecularReflection_Conductor`` +
    # ``evaluateFresnelConductor``, bxdfs.cl:188-220/272-281): any k > 0
    # switches the mirror lobe from dielectric to per-channel conductor
    conductor_eta: jax.Array  # (M, 3)
    conductor_k: jax.Array  # (M, 3) absorption; zeros = dielectric kr
    # Ashikhmin-Shirley Fresnel-blend (``evaluateFresnelBlend``,
    # bxdfs.cl:590-605): any rs > 0 replaces the Lambertian lobe with the
    # coupled diffuse+Schlick-specular blend
    rs_blend: jax.Array  # (M, 3)
    used_slots: tuple = field(
        pytree_node=False, default=(True,) * N_TEX_SLOTS
    )
    # STATIC per-LOBE mask (diffuse, glossy, spec_refl, spec_trans,
    # passthrough, conductor, fresnel_blend): a lobe no material in the
    # scene carries compiles away from eval/pdf/sample entirely — the
    # per-program hoist of the reference's per-thread lobe-flag branches
    # (``sampleUberBSDF``, bxdfs.cl:892-1053).  Texture modulation only
    # MULTIPLIES constants, so a zero constant keeps its lobe off; opacity
    # is the exception (textures can lower it below 1), handled in stack().
    used_lobes: tuple = field(pytree_node=False, default=(True,) * 7)

    @classmethod
    def stack(cls, mats: list["UberMaterial"]):
        f = np.float32
        tex_np = np.stack([m.tex for m in mats]).astype(np.int32)
        return cls(
            diffuse=jnp.asarray(np.stack([m.diffuse for m in mats]).astype(f)),
            glossy=jnp.asarray(np.stack([m.glossy for m in mats]).astype(f)),
            kr=jnp.asarray(np.stack([m.kr for m in mats]).astype(f)),
            kt=jnp.asarray(np.stack([m.kt for m in mats]).astype(f)),
            opacity=jnp.asarray(np.stack([m.opacity for m in mats]).astype(f)),
            roughness=jnp.asarray(np.array([m.roughness for m in mats], f)),
            ior=jnp.asarray(np.array([m.ior for m in mats], f)),
            tex=jnp.asarray(tex_np),
            conductor_eta=jnp.asarray(
                np.stack([m.conductor_eta for m in mats]).astype(f)
            ),
            conductor_k=jnp.asarray(
                np.stack([m.conductor_k for m in mats]).astype(f)
            ),
            rs_blend=jnp.asarray(
                np.stack([m.rs_blend for m in mats]).astype(f)
            ),
            used_slots=tuple(bool(b) for b in (tex_np >= 0).any(axis=0)),
            used_lobes=(
                bool((np.stack([m.diffuse for m in mats]) > 0).any()),
                bool((np.stack([m.glossy for m in mats]) > 0).any()),
                bool((np.stack([m.kr for m in mats]) > 0).any()),
                bool((np.stack([m.kt for m in mats]) > 0).any()),
                # passthrough: any opacity < 1 OR a texture that can lower
                # it (opacity map, or diffuse alpha) is bound
                bool((np.stack([m.opacity for m in mats]) < 1.0).any()
                     or (tex_np[:, TEX_OPACITY] >= 0).any()
                     or (tex_np[:, TEX_DIFFUSE] >= 0).any()),
                bool((np.stack([m.conductor_k for m in mats]) > 0).any()),
                bool((np.stack([m.rs_blend for m in mats]) > 0).any()),
            ),
        )


class UberMaterial:
    """Host-side material description (mirrors ``RTUberMaterialComponent``)."""

    def __init__(
        self,
        diffuse=(0.0, 0.0, 0.0),
        glossy=(0.0, 0.0, 0.0),
        kr=(0.0, 0.0, 0.0),
        kt=(0.0, 0.0, 0.0),
        opacity=(1.0, 1.0, 1.0),
        roughness=1.0,
        ior=1.5,
        tex=None,
        conductor_eta=(0.2, 0.92, 1.1),  # gold-ish default
        conductor_k=(0.0, 0.0, 0.0),  # any > 0 => kr uses conductor Fresnel
        rs_blend=(0.0, 0.0, 0.0),  # any > 0 => Fresnel-blend diffuse lobe
    ):
        self.diffuse = np.asarray(diffuse, np.float32)
        self.glossy = np.asarray(glossy, np.float32)
        self.kr = np.asarray(kr, np.float32)
        self.kt = np.asarray(kt, np.float32)
        self.opacity = np.asarray(opacity, np.float32)
        self.roughness = float(roughness)
        self.ior = float(ior)
        self.tex = np.full((N_TEX_SLOTS,), -1, np.int32) if tex is None else np.asarray(tex, np.int32)
        self.conductor_eta = np.asarray(conductor_eta, np.float32)
        self.conductor_k = np.asarray(conductor_k, np.float32)
        self.rs_blend = np.asarray(rs_blend, np.float32)


class Lights(PyTreeNode):
    """Light table (``RTLight``, ``kernel_data.h:137-152``) + uniform choice pdf
    (``RTScene::computeChoicePdfsForLights``, ``RTScene.cpp:412-476``).

    Mesh area lights carry a contiguous span [tri_offset, tri_offset+tri_count)
    into ``tri_index``/``tri_cdf``: global triangle ids and the area-weighted
    CDF used for surface sampling.
    """

    type: jax.Array  # (L,) i32
    position: jax.Array  # (L, 3) point/disk center
    direction: jax.Array  # (L, 3) directional dir / disk normal
    intensity: jax.Array  # (L, 3) radiance (area) or intensity (point/dir)
    radius: jax.Array  # (L,) disk radius
    area: jax.Array  # (L,) total surface area (disk/mesh)
    shape: jax.Array  # (L,) i32 owning shape id (mesh lights), -1 otherwise
    tri_offset: jax.Array  # (L,) i32 into tri_index
    tri_count: jax.Array  # (L,) i32
    tri_index: jax.Array  # (LT,) i32 global triangle ids of all mesh lights
    tri_cdf: jax.Array  # (LT,) f32 per-light area CDF (normalized within light)
    tri_light: jax.Array  # (LT,) i32 owning light id per entry
    num: jax.Array  # () i32 number of active lights

    @property
    def capacity(self) -> int:
        return self.type.shape[0]

    @classmethod
    def empty(cls):
        z3 = jnp.zeros((0, 3), jnp.float32)
        z = jnp.zeros((0,), jnp.float32)
        zi = jnp.zeros((0,), jnp.int32)
        return cls(
            type=zi, position=z3, direction=z3, intensity=z3, radius=z,
            area=z, shape=zi, tri_offset=zi, tri_count=zi,
            tri_index=jnp.zeros((0,), jnp.int32), tri_cdf=jnp.zeros((0,), jnp.float32),
            tri_light=jnp.zeros((0,), jnp.int32),
            num=jnp.asarray(0, jnp.int32),
        )


class TextureAtlas(PyTreeNode):
    """All textures in one RGBA8 byte buffer with a descriptor table —
    the reference does exactly this because OpenCL 1.2 lacks bindless images
    (``textures.cl:15-125``, upload in ``RTScene.cpp:680-766``); one flat
    buffer + gathers serves here too.

    Mip chain: level i of texture t starts at ``offset[t] + mip_offset(i)``;
    descriptors store base offset + base w/h + mip count; wrap mode per texture.
    """

    data: jax.Array  # (4, TEXELS) u8 RGBA texels, transposed (lane-gatherable)
    offset: jax.Array  # (MAX_MIPS, T) i32 texel offset per [level, texture]
    width: jax.Array  # (MAX_MIPS, T) i32 width per [level, texture]
    height: jax.Array  # (MAX_MIPS, T) i32
    mips: jax.Array  # (T,) i32 number of mip levels
    wrap: jax.Array  # (T,) i32 wrap mode (0=repeat,1=clamp,2=mirror,3=border)
    # optional float texel override: when present, fetches read (and
    # differentiate through) this (4, TEXELS) f32 array instead of the u8
    # data — the texture-texel gradient path (inverse rendering); u8 stays
    # the storage/serving format like the reference (``textures.cl:15``)
    data_f: jax.Array | None = None

    @classmethod
    def empty(cls):
        return cls(
            data=jnp.zeros((4, 1), jnp.uint8),
            offset=jnp.zeros((1, 0), jnp.int32),
            width=jnp.zeros((1, 0), jnp.int32),
            height=jnp.zeros((1, 0), jnp.int32),
            mips=jnp.zeros((0,), jnp.int32),
            wrap=jnp.zeros((0,), jnp.int32),
        )

    @property
    def num(self) -> int:
        return self.offset.shape[1]


class Scene(PyTreeNode):
    geometry: Geometry
    shapes: Shapes
    materials: Materials
    lights: Lights
    textures: TextureAtlas
    # bounding sphere of the scene (for directional-light shadow rays and
    # BDPT light-path pdfs, cf. sampleLightLi directional case lights.cl:45-146)
    center: jax.Array  # (3,)
    radius: jax.Array  # ()
    # instanced-shape registry (None for fully-baked scenes); presence
    # routes AccelType.AUTO to the two-level intersector, like the
    # reference auto-selecting from world content
    # (calc_intersection_device.cpp:73-150)
    instances: Instances | None = None


def _pad_faces(indices: np.ndarray, face_shape: np.ndarray, multiple: int = 128):
    f = indices.shape[0]
    fp = ((f + multiple - 1) // multiple) * multiple
    pad = fp - f
    if pad:
        indices = np.concatenate([indices, np.zeros((pad, 3), np.int32)], 0)
        face_shape = np.concatenate([face_shape, np.full((pad,), -1, np.int32)], 0)
    valid = np.arange(fp) < f
    return indices, face_shape, valid


def build_scene(
    positions: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    indices: np.ndarray,
    face_shape: np.ndarray,
    shape_material: np.ndarray,
    materials: list[UberMaterial],
    lights: Lights | None = None,
    shape_light: np.ndarray | None = None,
    textures: TextureAtlas | None = None,
    pad_multiple: int = 128,
    shape_to_world: np.ndarray | None = None,
    instances: Instances | None = None,
) -> Scene:
    """Assemble a Scene from host numpy arrays (world-space geometry for
    baked shapes; instanced shapes reference a source mesh's face range and
    position it via ``shape_to_world`` — pass the ``Instances`` registry)."""
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    face_shape = np.asarray(face_shape, np.int32)
    indices_p, face_shape_p, valid = _pad_faces(indices, face_shape, pad_multiple)

    num_shapes = len(shape_material)
    if shape_light is None:
        shape_light = np.full((num_shapes,), -1, np.int32)

    pos = np.asarray(positions, np.float32).reshape(-1, 3)
    lo, hi = pos.min(0), pos.max(0)
    if instances is not None and shape_to_world is not None:
        # scene bounds must cover instanced copies, not just the sources
        tw = np.asarray(shape_to_world, np.float32)
        for k in range(instances.num):
            flo, fhi = instances.face_lo[k], instances.face_hi[k]
            vids = np.unique(np.asarray(indices)[flo:fhi])
            m = tw[int(np.asarray(instances.shape)[k])]
            p = pos[vids] @ m[:3, :3].T + m[:3, 3]
            lo = np.minimum(lo, p.min(0))
            hi = np.maximum(hi, p.max(0))
    center = (lo + hi) * 0.5
    radius = float(np.linalg.norm(hi - center) + 1e-6)

    pos_j = jnp.asarray(pos)
    nrm_j = jnp.asarray(np.asarray(normals, np.float32).reshape(-1, 3))
    uvs_j = jnp.asarray(np.asarray(uvs, np.float32).reshape(-1, 2))
    idx_j = jnp.asarray(indices_p)
    fshape_j = jnp.asarray(face_shape_p)
    fvalid_j = jnp.asarray(valid)
    smat_j = jnp.asarray(np.asarray(shape_material, np.int32))
    slight_j = jnp.asarray(np.asarray(shape_light, np.int32))
    if shape_to_world is None:
        tw_j = jnp.tile(jnp.eye(4, dtype=jnp.float32)[None],
                        (num_shapes, 1, 1))
        nm_j = jnp.tile(jnp.eye(3, dtype=jnp.float32)[None],
                        (num_shapes, 1, 1))
    else:
        tw = np.asarray(shape_to_world, np.float32)
        tw_j = jnp.asarray(tw)
        nm_j = jnp.asarray(np.swapaxes(
            np.linalg.inv(tw[:, :3, :3]), -1, -2).astype(np.float32))
    return Scene(
        geometry=Geometry(
            positions=pos_j,
            normals=nrm_j,
            uvs=uvs_j,
            indices=idx_j,
            face_shape=fshape_j,
            face_valid=fvalid_j,
            face_attrs=pack_face_attrs(
                pos_j, nrm_j, uvs_j, idx_j, fshape_j, fvalid_j, smat_j, slight_j
            ),
            instanced=instances is not None,
        ),
        shapes=Shapes(
            material=smat_j,
            light=slight_j,
            to_world=tw_j,
            normal_mat=nm_j,
        ),
        materials=Materials.stack(materials),
        lights=lights if lights is not None else Lights.empty(),
        textures=textures if textures is not None else TextureAtlas.empty(),
        center=jnp.asarray(center, jnp.float32),
        radius=jnp.asarray(radius, jnp.float32),
        instances=instances,
    )


def triangle_areas(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    p = positions[indices]  # (F, 3, 3)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


def make_lights(host_lights: list[dict], positions: np.ndarray, indices: np.ndarray,
                face_shape: np.ndarray) -> Lights:
    """Build the Lights table from host light descriptions.

    Each dict: {"type": LIGHT_*, "position", "direction", "intensity",
    "radius", "shape" (for mesh lights)}.
    Mesh lights get area-weighted triangle CDFs (the reference samples the
    mesh uniformly with pdf = 1/totalArea, ``lights.cl:45-146``).
    """
    L = len(host_lights)
    typ = np.zeros((L,), np.int32)
    pos = np.zeros((L, 3), np.float32)
    dirn = np.zeros((L, 3), np.float32)
    inten = np.zeros((L, 3), np.float32)
    rad = np.zeros((L,), np.float32)
    area = np.zeros((L,), np.float32)
    shp = np.full((L,), -1, np.int32)
    tri_off = np.zeros((L,), np.int32)
    tri_cnt = np.zeros((L,), np.int32)
    tri_idx_all: list[np.ndarray] = []
    tri_cdf_all: list[np.ndarray] = []
    tri_light_all: list[np.ndarray] = []
    off = 0
    for i, hl in enumerate(host_lights):
        typ[i] = hl["type"]
        pos[i] = np.asarray(hl.get("position", (0, 0, 0)), np.float32)
        d = np.asarray(hl.get("direction", (0, -1, 0)), np.float32)
        n = np.linalg.norm(d)
        dirn[i] = d / (n if n > 0 else 1.0)
        inten[i] = np.asarray(hl.get("intensity", (1, 1, 1)), np.float32)
        rad[i] = float(hl.get("radius", 0.0))
        if typ[i] == LIGHT_DISK:
            area[i] = np.pi * rad[i] * rad[i]
        if typ[i] == LIGHT_MESH:
            s = int(hl["shape"])
            shp[i] = s
            tri_ids = np.nonzero(face_shape == s)[0].astype(np.int32)
            areas = triangle_areas(positions, indices[tri_ids])
            total = float(areas.sum())
            area[i] = total
            cdf = np.cumsum(areas / max(total, 1e-30)).astype(np.float32)
            tri_off[i] = off
            tri_cnt[i] = len(tri_ids)
            off += len(tri_ids)
            tri_idx_all.append(tri_ids)
            tri_cdf_all.append(cdf)
            tri_light_all.append(np.full((len(tri_ids),), i, np.int32))
    tri_index = (
        np.concatenate(tri_idx_all) if tri_idx_all else np.zeros((0,), np.int32)
    )
    tri_cdf = (
        np.concatenate(tri_cdf_all) if tri_cdf_all else np.zeros((0,), np.float32)
    )
    tri_light = (
        np.concatenate(tri_light_all) if tri_light_all else np.zeros((0,), np.int32)
    )
    return Lights(
        type=jnp.asarray(typ), position=jnp.asarray(pos), direction=jnp.asarray(dirn),
        intensity=jnp.asarray(inten), radius=jnp.asarray(rad), area=jnp.asarray(area),
        shape=jnp.asarray(shp), tri_offset=jnp.asarray(tri_off),
        tri_count=jnp.asarray(tri_cnt), tri_index=jnp.asarray(tri_index),
        tri_cdf=jnp.asarray(tri_cdf), tri_light=jnp.asarray(tri_light),
        num=jnp.asarray(L, jnp.int32),
    )
