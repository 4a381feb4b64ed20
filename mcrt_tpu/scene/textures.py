"""Texture atlas: build (host) + sampling (device).

Analogue of the reference's custom texture machinery
(``assets/kernels/textures.cl``): OpenCL 1.2 has no bindless images, so the
reference packs every texture (and its mip chain) into one giant byte buffer
with ``TextureDesc2D`` records and hand-rolls nearest/bilinear/trilinear
fetches with 4 wrap modes (:30-202).  One flat buffer + gathers is kept
here — with two twists:

- texel storage is **transposed** ``(4, TEXELS) uint8`` so a fetch gathers
  along the lane axis (see accel/lbvh.py for the measured rationale);
- every mip level gets its own descriptor row, so LOD selection is a gather
  of (offset, width, height) at [tex, level] — no per-lane loops.

All formats RGBA8, like the reference (``textures.cl:15``).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..core import math as m
from .scene import TextureAtlas

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2
WRAP_BORDER = 3

MAX_MIPS = 12


class AtlasBuilder:
    """Host-side atlas packer (the ``RTScene::uploadTextures`` role,
    ``RTScene.cpp:680-766``, which reads back GL textures + mips into one
    byte buffer)."""

    def __init__(self, build_mips: bool = True):
        self.build_mips = build_mips
        self._texels: list[np.ndarray] = []  # (h*w, 4) u8 chunks
        self._descs: list[tuple] = []  # (offset, w, h, mips, wrap)
        self._mip_table: list[np.ndarray] = []  # (MAX_MIPS, 3) per texture
        self._off = 0

    def add(self, image: np.ndarray, wrap: int = WRAP_REPEAT) -> int:
        """image: (H, W, 3|4) uint8 or float in [0,1]. Returns texture id."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.full(img.shape[:2] + (1,), 255, np.uint8)], axis=-1
            )
        h, w = img.shape[:2]
        levels = [img]
        if self.build_mips:
            cur = img.astype(np.float32)
            while min(cur.shape[0], cur.shape[1]) > 1 and len(levels) < MAX_MIPS:
                hh = max(1, cur.shape[0] // 2)
                ww = max(1, cur.shape[1] // 2)
                cur = cur[: hh * 2, : ww * 2].reshape(hh, 2, ww, 2, 4).mean((1, 3))
                levels.append((cur + 0.5).astype(np.uint8))
        mip_rows = np.zeros((MAX_MIPS, 3), np.int32)
        base_off = self._off
        for li, lv in enumerate(levels):
            lh, lw = lv.shape[:2]
            mip_rows[li] = (self._off, lw, lh)
            self._texels.append(lv.reshape(-1, 4))
            self._off += lh * lw
        for li in range(len(levels), MAX_MIPS):
            mip_rows[li] = mip_rows[len(levels) - 1]  # clamp to last level
        tid = len(self._descs)
        self._descs.append((base_off, w, h, len(levels), wrap))
        self._mip_table.append(mip_rows)
        return tid

    def build(self) -> TextureAtlas:
        if not self._descs:
            return TextureAtlas.empty()
        data = np.concatenate(self._texels, axis=0)  # (TEXELS, 4) u8
        descs = np.asarray(self._descs, np.int32)
        mips = np.stack(self._mip_table)  # (T, MAX_MIPS, 3)
        return TextureAtlas(
            data=jnp.asarray(data.T),  # transposed (4, TEXELS)
            offset=jnp.asarray(mips[:, :, 0].T),  # (MAX_MIPS, T)
            width=jnp.asarray(mips[:, :, 1].T),
            height=jnp.asarray(mips[:, :, 2].T),
            mips=jnp.asarray(descs[:, 3]),
            wrap=jnp.asarray(descs[:, 4]),
        )


def load_texture_image(path: str, srgb: bool = False) -> np.ndarray | None:
    """Decode an image file into an (H, W, 4) uint8 RGBA array for
    ``AtlasBuilder.add`` — the file half of the reference's texture upload
    (``RTScene.cpp:680-766`` reads back GL textures that SOIL decoded from
    disk, ``AssetImporter.h:16-46``).

    ``srgb=True`` linearizes the color channels (MTL ``map_Kd`` color maps
    are authored sRGB; all radiance math is linear).  Rows are flipped so
    OBJ's bottom-up ``vt`` convention lands on row 0.  Returns None when
    the file is missing or cannot be decoded (callers degrade to the
    constant material color, like ``readTexture2Df_ifValid``,
    ``textures.cl:211-241``).  Decoding needs Pillow."""
    if not os.path.exists(path):
        return None
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding the texture {path!r} needs Pillow (PIL), which is "
            "not installed") from e
    try:
        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGBA"), np.uint8)
    except Exception:
        return None
    arr = np.flipud(arr).copy()
    if srgb:
        lin = (arr[..., :3].astype(np.float32) / 255.0) ** 2.2
        arr = np.concatenate(
            [(lin * 255.0 + 0.5).astype(np.uint8), arr[..., 3:]], axis=-1
        )
    return arr


def _wrap_coord(x: jax.Array, n: jax.Array, mode: jax.Array) -> jax.Array:
    """Apply wrap mode to integer texel coords (``textures.cl:30-68``)."""
    rep = jnp.mod(x, n)
    clmp = jnp.clip(x, 0, n - 1)
    period = jnp.maximum(2 * n, 1)
    mx = jnp.mod(x, period)
    mir = jnp.where(mx >= n, period - 1 - mx, mx)
    out = jnp.where(
        mode == WRAP_REPEAT, rep,
        jnp.where(mode == WRAP_CLAMP, clmp, jnp.where(mode == WRAP_MIRROR, mir, clmp)),
    )
    # border handled by caller via in-bounds mask
    return out


def _fetch_texel(atlas: TextureAtlas, off: jax.Array, w: jax.Array,
                 h: jax.Array, x: jax.Array, y: jax.Array,
                 mode: jax.Array) -> jax.Array:
    xin = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xw = _wrap_coord(x, w, mode)
    yw = _wrap_coord(y, h, mode)
    idx = off + yw * w + xw
    if atlas.data_f is not None:
        # differentiable float texels (texture-parameter gradients)
        texel = jnp.take(atlas.data_f, idx, axis=1)  # (4, N)
    else:
        texel = jnp.take(atlas.data, idx, axis=1).astype(jnp.float32) / 255.0
    border = (mode == WRAP_BORDER) & ~xin
    return jnp.where(border[None, :], 0.0, texel)


def _bilinear(atlas: TextureAtlas, tex: jax.Array, level: jax.Array,
              uv: jax.Array) -> jax.Array:
    """(4, N) bilinear fetch at integer mip `level` (``textures.cl:70-125``)."""
    t = jnp.maximum(tex, 0)
    T = atlas.offset.shape[1]
    flat = level * T + t  # linearized [level, tex] gather
    off = jnp.take(atlas.offset.reshape(-1), flat)
    w = jnp.take(atlas.width.reshape(-1), flat)
    h = jnp.take(atlas.height.reshape(-1), flat)
    mode = jnp.take(atlas.wrap, t, axis=0)
    fx = uv[:, 0] * w.astype(jnp.float32) - 0.5
    fy = uv[:, 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    ax = (fx - x0.astype(jnp.float32))[None, :]
    ay = (fy - y0.astype(jnp.float32))[None, :]
    c00 = _fetch_texel(atlas, off, w, h, x0, y0, mode)
    c10 = _fetch_texel(atlas, off, w, h, x0 + 1, y0, mode)
    c01 = _fetch_texel(atlas, off, w, h, x0, y0 + 1, mode)
    c11 = _fetch_texel(atlas, off, w, h, x0 + 1, y0 + 1, mode)
    return (
        c00 * (1 - ax) * (1 - ay)
        + c10 * ax * (1 - ay)
        + c01 * (1 - ax) * ay
        + c11 * ax * ay
    )


def compute_lod(atlas: TextureAtlas, tex: jax.Array, duvdx: jax.Array,
                duvdy: jax.Array) -> jax.Array:
    """Mip LOD from the uv screen footprint (``textures.cl:198-202``)."""
    t = jnp.maximum(tex, 0)
    w = jnp.take(atlas.width[0], t).astype(jnp.float32)
    h = jnp.take(atlas.height[0], t).astype(jnp.float32)
    fx = jnp.maximum(jnp.abs(duvdx[:, 0]) * w, jnp.abs(duvdx[:, 1]) * h)
    fy = jnp.maximum(jnp.abs(duvdy[:, 0]) * w, jnp.abs(duvdy[:, 1]) * h)
    width = jnp.maximum(jnp.maximum(fx, fy), 1e-8)
    return jnp.maximum(jnp.log2(width), 0.0)


def sample_texture(atlas: TextureAtlas, tex: jax.Array, uv: jax.Array,
                   duvdx: jax.Array | None = None,
                   duvdy: jax.Array | None = None) -> jax.Array:
    """(N, 4) trilinear (or bilinear when no differentials) RGBA sample.
    Lanes with tex < 0 return ones (callers mask — the
    ``readTexture2Df*_ifValid`` pattern, ``textures.cl:211-241``)."""
    n = uv.shape[0]
    if atlas.num == 0:
        return jnp.ones((n, 4), jnp.float32)
    t = jnp.maximum(tex, 0)
    num_mips = jnp.take(atlas.mips, t, axis=0)
    if duvdx is None or duvdy is None:
        rgba = _bilinear(atlas, tex, jnp.zeros_like(t), uv).T
    else:
        lod = jnp.minimum(
            compute_lod(atlas, tex, duvdx, duvdy),
            (num_mips - 1).astype(jnp.float32),
        )
        l0 = jnp.floor(lod).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, num_mips - 1)
        fr = (lod - l0.astype(jnp.float32))[None, :]
        c0 = _bilinear(atlas, tex, jnp.clip(l0, 0, MAX_MIPS - 1), uv)
        c1 = _bilinear(atlas, tex, jnp.clip(l1, 0, MAX_MIPS - 1), uv)
        rgba = (c0 * (1 - fr) + c1 * fr).T
    return jnp.where((tex >= 0)[:, None], rgba, 1.0)
