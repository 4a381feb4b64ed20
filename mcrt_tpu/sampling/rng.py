"""Counter-based sample streams.

Replacement for the reference's xorshift+Wang-hash RNG
(``assets/kernels/rng.cl:27-102``) and its per-pixel/frame/bounce seeding
(``samplers.cl:74-85``): we use JAX's counter-based threefry keys, folded over
(seed, frame, dimension), which gives deterministic, reproducible,
shard-invariant streams — the counterpart of seeding by
``pixel + frame + bounce``.

The stream is functional: ``SampleStream`` carries (key, dim, pixel ids) and
every draw advances the dimension counter, so the same machinery backs both
the pseudo-random sampler and the Sobol sampler (``sobol.py``) behind one
interface — mirroring the reference's compile-time ``RT_SAMPLER`` switch
(``samplers.cl:16-18``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core.pytree import PyTreeNode, field

from ..config import SamplerConfig, SamplerType


class SampleStream(PyTreeNode):
    """Functional per-batch sample stream. ``pixel`` are global pixel indices
    (for pixel-decorrelated low-discrepancy scrambling), ``index`` is the
    per-pixel sample index (spp counter, = frame in progressive rendering)."""

    key: jax.Array  # base threefry key (folded with seed+frame)
    dim: jax.Array  # () i32 next dimension
    pixel: jax.Array  # (N,) i32 global pixel ids
    index: jax.Array  # () i32 sample index (frame)
    scramble: jax.Array  # () u32 frame-INDEPENDENT scramble seed (sobol)
    kind: int = field(pytree_node=False, default=0)  # 0=random, 1=sobol
    sobol_mats: jax.Array | None = None  # (D, 32) u32 direction matrices


def make_stream(cfg: SamplerConfig, frame: jax.Array, pixel_ids: jax.Array,
                sobol_mats: jax.Array | None = None) -> SampleStream:
    key = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), frame)
    kind = 1 if cfg.type == SamplerType.SOBOL else 0
    if kind == 1 and sobol_mats is None:
        from .sobol import sobol_matrices

        sobol_mats = sobol_matrices()
    return SampleStream(
        key=key,
        dim=jnp.asarray(0, jnp.int32),
        pixel=pixel_ids.astype(jnp.int32),
        index=jnp.asarray(frame, jnp.int32),
        # sobol digit-scramble seed: depends on cfg.seed only — it must stay
        # fixed across frames so each pixel walks ONE scrambled sequence
        scramble=jnp.asarray(np.uint32(cfg.seed * 2654435761 % (1 << 32))),
        kind=kind,
        sobol_mats=sobol_mats,
    )


def _hash_u32(x: jax.Array) -> jax.Array:
    """Wang-style integer hash (public-domain mixing constants) for
    per-pixel scramble seeds — same role as ``wangHash`` (``rng.cl``)."""
    x = x.astype(jnp.uint32)
    x = (x ^ jnp.uint32(61)) ^ (x >> 16)
    x = x * jnp.uint32(9)
    x = x ^ (x >> 4)
    x = x * jnp.uint32(0x27D4EB2D)
    x = x ^ (x >> 15)
    return x


def _random_bits(stream: SampleStream, n_dims: int) -> jax.Array:
    """(N, n_dims) uniform [0,1) via threefry."""
    k = jax.random.fold_in(stream.key, stream.dim)
    return jax.random.uniform(k, (stream.pixel.shape[0], n_dims), jnp.float32)


def _sobol_bits(stream: SampleStream, n_dims: int) -> jax.Array:
    from .sobol import sobol_sample_scrambled

    dims = stream.dim + jnp.arange(n_dims, dtype=jnp.int32)
    # per-(pixel, dim) digit scramble seeded frame-independently
    return sobol_sample_scrambled(
        stream.sobol_mats, stream.index, dims, stream.pixel, stream.scramble
    )


def next_1d(stream: SampleStream):
    u = (_random_bits(stream, 1) if stream.kind == 0 else _sobol_bits(stream, 1))[:, 0]
    return u, stream.replace(dim=stream.dim + 1)


def next_2d(stream: SampleStream):
    u = _random_bits(stream, 2) if stream.kind == 0 else _sobol_bits(stream, 2)
    return u, stream.replace(dim=stream.dim + 2)


def next_3d(stream: SampleStream):
    u = _random_bits(stream, 3) if stream.kind == 0 else _sobol_bits(stream, 3)
    return u, stream.replace(dim=stream.dim + 3)
