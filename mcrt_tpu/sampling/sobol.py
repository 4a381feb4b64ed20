"""Sobol' low-discrepancy sampler.

Analogue of the reference's Sobol sampler (``samplers.cl:64-72`` using the
Joe-Kuo 1024-dim matrix table vendored as ``sampling/sobol.h``): sample j of
dimension d is the XOR of direction numbers selected by the set bits of j,
then XOR-scrambled.  Instead of vendoring the 8.9-kLoC table we derive the
direction numbers from scipy's Sobol implementation (same Joe-Kuo data,
public) once and cache them as an .npy asset; sampling itself is pure jnp
(bitwise XOR folds over 32 static steps — no gathers beyond a
(32, D) table lookup).

Scrambling: per-(pixel, dimension) random XOR (digit scrambling) seeded from
the stream key — decorrelates pixels like the reference's per-pixel scramble
while keeping the (0,1)-sequence structure per pixel.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

_NUM_DIMS = 256
_CACHE = os.path.join(os.path.dirname(__file__), "_sobol_mats.npy")
_mats_host: np.ndarray | None = None


def _generate_matrices(d: int = _NUM_DIMS) -> np.ndarray:
    from scipy.stats import qmc

    s = qmc.Sobol(d=d, scramble=False, bits=32)
    return np.asarray(s._sv, dtype=np.uint32)  # (d, 32)


def sobol_matrices() -> jax.Array:
    """(D, 32) uint32 direction numbers (cached on disk after first call)."""
    global _mats_host
    if _mats_host is None:
        if os.path.exists(_CACHE):
            _mats_host = np.load(_CACHE)
        else:
            _mats_host = _generate_matrices()
            try:
                np.save(_CACHE, _mats_host)
            except OSError:
                pass
    return jnp.asarray(_mats_host)


def _hash2(a: jax.Array, b: jax.Array) -> jax.Array:
    """Mix two uint32s (public-domain xxhash-style constants)."""
    x = a.astype(jnp.uint32) * jnp.uint32(0x9E3779B1) + b.astype(jnp.uint32)
    x ^= x >> 15
    x *= jnp.uint32(0x85EBCA77)
    x ^= x >> 13
    x *= jnp.uint32(0xC2B2AE3D)
    x ^= x >> 16
    return x


def sobol_sample_scrambled(
    mats: jax.Array,  # (D, 32) uint32
    index: jax.Array,  # () i32 sample index
    dims: jax.Array,  # (k,) i32 dimensions
    pixel: jax.Array,  # (N,) i32 pixel ids
    scramble_seed: jax.Array,  # () u32 frame-independent scramble seed
) -> jax.Array:
    """(N, k) scrambled Sobol samples in [0, 1).

    The digit scramble is a per-(pixel, dim) XOR word constant across sample
    indices — a valid random digital shift that keeps each pixel's sequence a
    (0,1)-sequence while decorrelating pixels."""
    d_mats = jnp.take(
        mats, jnp.clip(dims, 0, mats.shape[0] - 1), axis=0
    )  # (k, 32)
    idx = index.astype(jnp.uint32)
    x = jnp.zeros(dims.shape, jnp.uint32)  # (k,)
    for b in range(32):
        bit = (idx >> b) & jnp.uint32(1)
        x = x ^ jnp.where(bit.astype(bool), d_mats[:, b], jnp.uint32(0))
    scr = _hash2(
        pixel[:, None].astype(jnp.uint32) * jnp.uint32(0x632BE59B)
        + dims[None, :].astype(jnp.uint32),
        scramble_seed.astype(jnp.uint32),
    )  # (N, k)
    v = x[None, :] ^ scr
    # keep in [0, 1)
    return jnp.minimum(
        v.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10),
        jnp.float32(1.0 - 1e-7),
    )
