"""The port's Rice parameter search (linne_tpu_torch.ops.rice_search)
against the JAX reference on the CPU: bit-equal orders and parameters,
including the uint32 wrap of the code-length total."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linne_tpu.ops import rice_search as J
from linne_tpu_torch.ops import rice_search as T


def _search_both(data):
    got = T.rice_search(torch.from_numpy(data))
    want = jax.jit(J.rice_search)(jnp.asarray(data))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("n", [2048, 2560, 1000, 96, 10240])
def test_max_porder_for(n):
    assert T.max_porder_for(n) == J.max_porder_for(n)


@pytest.mark.parametrize("n,scale", [(2048, 300), (2560, 20), (1000, 4000),
                                     (160, 2)])
def test_rice_search_bit_equal(n, scale):
    rng = np.random.default_rng(n)
    data = np.round(rng.laplace(0, scale, (3, 2, n))).astype(np.int32)
    data[0, 0] = 0                                 # all-zero plane
    data[0, 1, : n // 2] = 0                       # quiet first half
    data[1, 0] *= (np.arange(n) % 64 == 0) * 40 + 1  # sparse spikes
    (porder_t, k2_t), (porder_j, k2_j) = _search_both(data)
    assert porder_t.dtype == porder_j.dtype and k2_t.dtype == k2_j.dtype
    assert np.array_equal(porder_t, porder_j)
    assert np.array_equal(k2_t, k2_j)
    assert len(set(porder_t.ravel().tolist())) > 1


def test_rice_search_extreme_residuals():
    """Full-range int32 residuals (zigzag codes up to 2^32 - 1), held in
    int64 by the port and in uint32 by the reference: equal selections."""
    rng = np.random.default_rng(7)
    n = 512
    data = rng.integers(-2**31, 2**31, (4, 2, n)).astype(np.int32)
    data[1] = np.where(np.arange(n) % 2, 2**31 - 1, -2**31).astype(np.int32)
    data[2, :, : n // 2] = 1
    (porder_t, k2_t), (porder_j, k2_j) = _search_both(data)
    assert np.array_equal(porder_t, porder_j)
    assert np.array_equal(k2_t, k2_j)


def test_zigzag_and_clz_match():
    x = np.asarray([0, 1, -1, 2, -2, 2**31 - 1, -2**31, 12345, -98765],
                   np.int32)
    zz_t = T._zigzag_u32(torch.from_numpy(x)).numpy()
    zz_j = np.asarray(J._zigzag_u32(jnp.asarray(x))).astype(np.int64)
    assert np.array_equal(zz_t, zz_j)
    u = np.asarray([0, 1, 2, 3, 255, 256, 2**31 - 1, 2**31, 2**32 - 1],
                   np.int64)
    clz_t = T._clz32(torch.from_numpy(u)).numpy()
    clz_j = np.asarray(J._clz32(jnp.asarray(u.astype(np.uint32))))
    assert np.array_equal(clz_t, clz_j)
    gb_t = T._gamma_bits(torch.from_numpy(u)).numpy()
    gb_j = np.asarray(J._gamma_bits(jnp.asarray(u.astype(np.uint32))))
    assert np.array_equal(gb_t, gb_j.astype(np.int64))
