"""In-repo support code: the dataclass pytree base and the PNG writer."""
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcrt_tpu.core.pytree import PyTreeNode, field
from mcrt_tpu.utils.image import png_bytes, to_srgb_u8, write_png


class _Node(PyTreeNode):
    a: jax.Array
    b: jax.Array
    size: int = field(pytree_node=False, default=3)


def test_pytree_children_and_static_fields():
    n = _Node(a=jnp.ones(2), b=jnp.zeros(3), size=7)
    leaves, tree = jax.tree.flatten(n)
    assert len(leaves) == 2
    back = jax.tree.unflatten(tree, leaves)
    assert back.size == 7
    doubled = jax.jit(lambda x: jax.tree.map(lambda v: v * 2, x))(n)
    np.testing.assert_array_equal(np.asarray(doubled.a), [2.0, 2.0])
    assert doubled.size == 7


def test_pytree_replace_and_frozen():
    n = _Node(a=jnp.ones(2), b=jnp.zeros(3))
    m = n.replace(size=5, a=jnp.zeros(2))
    assert (m.size, n.size) == (5, 3)
    np.testing.assert_array_equal(np.asarray(m.a), [0.0, 0.0])
    with pytest.raises(Exception):
        n.a = jnp.zeros(2)


def _decode_png(data: bytes) -> np.ndarray:
    """Minimal decoder for the writer's output: 8-bit RGB, filter 0."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            assert (depth, color) == (8, 2)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7), (64, 33)])
def test_png_round_trip(shape):
    rgb = np.random.RandomState(0).randint(0, 256, shape + (3,), np.uint8)
    np.testing.assert_array_equal(_decode_png(png_bytes(rgb)), rgb)


def test_write_png_flips_and_gamma(tmp_path):
    img = np.zeros((4, 2, 3), np.float32)
    img[0] = 1.0  # bottom row of the film
    path = tmp_path / "out.png"
    write_png(str(path), img)
    got = _decode_png(path.read_bytes())
    np.testing.assert_array_equal(got, to_srgb_u8(img))
    assert (got[-1] == 255).all() and (got[0] == 0).all()
