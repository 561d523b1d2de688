"""The split form of the attention dropout hash that the bf16 kernels of
visitron_torch (csrc/attention.cu) evaluate: the row term
mix16(r * 0x9E3779B1 ^ seed) once per query row, the column term
mix16(c * 0x85EBCA77) once per key, and keep_tail of their xor.  mix16
(x ^ x >> 16) distributes over ^, so this is the JAX package's one-piece
hash; here, in numpy uint32, it must equal visitron_tpu's ``_keep_mask``
(plain jnp, on the CPU as that package's tests run it) and the port's
``_keep_mask``, bit for bit, at offsets past 2^16 too."""

import jax.numpy as jnp
import numpy as np
import pytest

from visitron_torch.ops import attention as tatt
from visitron_tpu.ops import attention as jatt

_M32 = 0xFFFFFFFF
SHAPE = (48, 80)


def _mix16(x):
    return x ^ (x >> np.uint32(16))


def _keep_tail(x, thr: int):
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    x = x ^ (x >> np.uint32(16))
    return x >= np.uint32(thr)


def split_keep_mask(hseed: int, row0: int, col0: int, shape, thr: int):
    """The kernels' form, uint32 arithmetic wrapping as on the card."""
    r = np.arange(shape[0], dtype=np.uint32) + np.uint32(row0)
    c = np.arange(shape[1], dtype=np.uint32) + np.uint32(col0)
    row_term = _mix16((r * np.uint32(0x9E3779B1)) ^ np.uint32(hseed))
    col_term = _mix16(c * np.uint32(0x85EBCA77))
    return _keep_tail(row_term[:, None] ^ col_term[None, :], thr)


@pytest.mark.parametrize("row0,col0", [(0, 0), (64, 960), (65536 - 24, 65536 - 40),
                                       (70000, 3 << 17)])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("head", [0, 191])
@pytest.mark.parametrize("seed", [0, 2468, 0x9E3779B9])
def test_split_hash_equals_both_keep_masks(seed, head, rate, row0, col0):
    hseed = (seed ^ (head * 0xC2B2AE3D)) & _M32
    assert int(tatt._mix_seed(seed, head)) == hseed
    thr = tatt._threshold(rate)
    assert thr == jatt._threshold(rate)
    got = split_keep_mask(hseed, row0, col0, SHAPE, thr)
    want_jax = np.asarray(jatt._keep_mask(jnp.uint32(hseed), row0, col0, SHAPE, thr))
    want_torch = tatt._keep_mask(hseed, row0, col0, SHAPE, thr).numpy()
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_torch)
    # A mask, not a constant: about 1 - rate of the values are kept.
    assert abs(got.mean() - (1.0 - rate)) < 0.1
