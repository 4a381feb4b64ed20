"""ctypes bindings for the native runtime library (``native/mcrt_native.cpp``).

Role of the reference's native host layer: where the reference links against
assimp for model import (``engine/resource/AssetImporter.h``) and RadeonRays'
C++ SAH builders (``src/accelerator/bvh.cpp``), this module loads
``libmcrt_native.so`` — built with ``make -C native`` on first use in each
process (make rebuilds it whenever ``mcrt_native.cpp`` changed) — and
exposes:

- ``parse_obj_native(path)``: fast OBJ geometry parse (~50x the Python loader
  on San-Miguel-scale files); material *properties* still come from the
  Python MTL parser (tiny files).
- ``sah_block_order(positions, indices, block_size, bins)``: binned-SAH block
  decomposition for the Pallas blocked intersector (quality alternative to
  Morton blocking, cf. ``Bvh::FindSahSplit``).

A failed build raises: nothing falls back to another builder or parser.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from dataclasses import dataclass

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libmcrt_native.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _build() -> None:
    r = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0 or not os.path.exists(_LIB_PATH):
        raise RuntimeError(
            f"`make -C {_NATIVE_DIR}` failed (rc {r.returncode}):\n"
            f"{r.stdout}{r.stderr}")


def get_lib() -> ctypes.CDLL:
    """Build (if the sources changed) and load the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p]
        lib.obj_counts.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_int64)
        ] * 6
        lib.obj_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
        lib.obj_mat_name.restype = ctypes.c_char_p
        lib.obj_mat_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.obj_mtl_lib.restype = ctypes.c_char_p
        lib.obj_mtl_lib.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.obj_free.argtypes = [ctypes.c_void_p]
        lib.sah_build_blocks.restype = ctypes.c_int32
        lib.sah_build_blocks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.sbvh_build_blocks.restype = ctypes.c_int64
        lib.sbvh_build_blocks.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_float,
        ]
        lib.sbvh_fetch.restype = ctypes.c_int32
        lib.sbvh_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


@dataclass
class ObjGeometry:
    """Raw OBJ geometry from the native parser (pre-material resolution)."""

    v: np.ndarray  # (nv, 3) f32
    vn: np.ndarray  # (nvn, 3) f32
    vt: np.ndarray  # (nvt, 2) f32
    f_v: np.ndarray  # (ntri, 3) i32
    f_vt: np.ndarray  # (ntri, 3) i32, -1 = none
    f_vn: np.ndarray  # (ntri, 3) i32, -1 = none
    f_m: np.ndarray  # (ntri,) i32 material slot, -1 = default
    mat_names: list[str]
    mtl_libs: list[str]


def parse_obj_native(path: str) -> ObjGeometry | None:
    """Parse OBJ geometry via the native library; None if unreadable."""
    lib = get_lib()
    h = lib.obj_parse(path.encode())
    if not h:
        return None
    try:
        c = [ctypes.c_int64(0) for _ in range(6)]
        lib.obj_counts(h, *[ctypes.byref(x) for x in c])
        nv, nvn, nvt, ntri, nmat, nlib = (x.value for x in c)
        v = np.empty((nv, 3), np.float32)
        vn = np.empty((nvn, 3), np.float32)
        vt = np.empty((nvt, 2), np.float32)
        f_v = np.empty((ntri, 3), np.int32)
        f_vt = np.empty((ntri, 3), np.int32)
        f_vn = np.empty((ntri, 3), np.int32)
        f_m = np.empty((ntri,), np.int32)
        lib.obj_fill(
            h, v.ctypes.data, vn.ctypes.data, vt.ctypes.data,
            f_v.ctypes.data, f_vt.ctypes.data, f_vn.ctypes.data,
            f_m.ctypes.data,
        )
        mat_names = [lib.obj_mat_name(h, i).decode() for i in range(nmat)]
        mtl_libs = [lib.obj_mtl_lib(h, i).decode() for i in range(nlib)]
        return ObjGeometry(v, vn, vt, f_v, f_vt, f_vn, f_m, mat_names,
                           mtl_libs)
    finally:
        lib.obj_free(h)


def sah_block_order(
    positions: np.ndarray, indices: np.ndarray, block_size: int = 128,
    bins: int = 16,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Binned-SAH block decomposition: returns (order (ntri,),
    block_start (n_blocks+1,))."""
    lib = get_lib()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    ntri = indices.shape[0]
    order = np.empty((ntri,), np.int32)
    block_start = np.empty((ntri + 1,), np.int32)
    nb = lib.sah_build_blocks(
        positions.ctypes.data, indices.ctypes.data, ntri, block_size, bins,
        order.ctypes.data, block_start.ctypes.data,
    )
    return order, block_start[: nb + 1]


def sbvh_block_refs(
    positions: np.ndarray, indices: np.ndarray, block_size: int = 128,
    bins: int = 16, max_split_depth: int = 16, min_overlap: float = 1e-5,
    extra_refs_budget: float = 0.5,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """SBVH (spatial-split) block decomposition — ``SplitBvh`` analogue
    (``split_bvh.h:30-45``): returns (ref_tri (n_refs,), ref_bounds
    (n_refs, 6) lo/hi clipped boxes, block_start (n_blocks+1,)).  Straddling
    triangles may be referenced from more than one block with plane-clipped
    bounds; n_refs <= ntri * (1 + extra_refs_budget).  None when the
    builder produced no references."""
    lib = get_lib()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    ntri = indices.shape[0]
    with _lock:  # the two-phase fetch uses library-global result state
        n_refs = lib.sbvh_build_blocks(
            positions.ctypes.data, indices.ctypes.data, ntri, block_size,
            bins, max_split_depth, min_overlap, extra_refs_budget,
        )
        if n_refs <= 0:
            return None
        ref_tri = np.empty((n_refs,), np.int32)
        ref_bounds = np.empty((n_refs, 6), np.float32)
        block_start = np.empty((n_refs + 2,), np.int32)
        nb = lib.sbvh_fetch(
            ref_tri.ctypes.data, ref_bounds.ctypes.data,
            block_start.ctypes.data,
        )
    if nb <= 0:
        return None
    return ref_tri, ref_bounds, block_start[: nb + 1]
