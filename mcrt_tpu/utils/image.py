"""Image IO: PNG output (the reference's SOIL screenshot path,
``Engine.cpp:180-204``) and simple comparison metrics for tests/golden
checks."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def to_srgb_u8(img: np.ndarray, flip_vertical: bool = True) -> np.ndarray:
    """Linear HDR (H, W, 3) -> display u8 with gamma 2.2. Rows are stored
    bottom-up (film v=0 at the bottom), so PNGs flip by default."""
    x = np.asarray(img, np.float32)
    if flip_vertical:
        x = x[::-1]
    x = np.clip(x, 0.0, 1.0) ** (1.0 / 2.2)
    return (x * 255.0 + 0.5).astype(np.uint8)


def png_bytes(rgb: np.ndarray) -> bytes:
    """Encode an (H, W, 3) u8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgb.reshape(h, w * 3)], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, flip_vertical: bool = True):
    with open(path, "wb") as f:
        f.write(png_bytes(to_srgb_u8(img, flip_vertical)))


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))


def relative_mse(a: np.ndarray, ref: np.ndarray, eps: float = 1e-2) -> float:
    """MSE normalized by reference brightness (standard renderer metric)."""
    a = np.asarray(a)
    ref = np.asarray(ref)
    return float(np.mean((a - ref) ** 2 / (ref * ref + eps)))
