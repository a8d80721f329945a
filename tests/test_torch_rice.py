"""The port's Rice parameter search (linne_tpu_torch.ops.rice_search)
against the JAX reference on the CPU: bit-equal orders and parameters,
including the uint32 wrap of the code-length total. Then the kernel's
steps (tests/torch_rice_model.py) against the plain version, its plan, and
the dispatch of a CPU tensor to the plain version; the kernel itself runs
only on a card (tests/test_torch_cuda.py, `-k rice`)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rice_model as RM
from conftest import REPO_ROOT
from linne_tpu.ops import rice_search as J
from linne_tpu_torch.ops import analysis_scans as AS
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


# -- the kernel's steps (tests/torch_rice_model.py) and the dispatch ----------


def _rice_rows(n, seed):
    """Seeded rows of Laplacian residuals at a spread of scales, a silent
    row, a quiet start, sparse spikes and a full-range row (zigzag codes
    near 2^32, whose code-length totals wrap)."""
    rng = np.random.default_rng(seed)
    scales = (1, 30, 3000, 60000)
    data = np.stack([np.round(rng.laplace(0, s, n)) for s in scales]
                    ).astype(np.int32)
    data[1, : n // 2] = 0
    data[2] *= ((np.arange(n) % 64 == 0) * 40 + 1).astype(np.int32)
    extreme = rng.choice(np.asarray([-2**31, 2**31 - 1, -1, 0], np.int32), n)
    return np.concatenate([data, np.zeros((1, n), np.int32),
                           extreme[None]]).reshape(2, 3, n)


@pytest.mark.parametrize("n", [1, 3, 96, 1000, 4410, 8192, 10239, 10240])
def test_kernel_model_matches_plain_version(n):
    """The kernel's steps (plan, item sums, tree, headers at each
    partition's first item, one pass for every order, uint32 wrap, first
    minimum) give the plain version's orders and parameters."""
    data = _rice_rows(n, n)
    best, k2 = RM.model(data)
    want_best, want_k2 = T._rice_search_plain(torch.from_numpy(data))
    assert np.array_equal(best, want_best.numpy())
    assert np.array_equal(k2, want_k2.numpy())


def test_kernel_model_first_minimum_on_ties():
    """Rows whose lowest total two orders share: the model's totals tie
    there, and the model and the plain version both pick the lower order."""
    plane = RM.tie_plane()
    want_best, want_k2 = T._rice_search_plain(torch.from_numpy(plane))
    for row, wb, wk in zip(plane, want_best.numpy(), want_k2.numpy()):
        best, k2, totals = RM.row_model(row)
        tied = np.nonzero(totals == totals.min())[0]
        assert len(tied) == 2 and best == tied[0] == wb
        assert np.array_equal(k2, wk)


def test_kernel_model_at_the_fit_edges():
    """Finest partitions whose means lie within 0.3 of each edge of the
    parameter fit: the finest order wins, every fitted parameter is in the
    output, and the model's are the plain version's."""
    plane = RM.edge_plane()
    best, k2 = RM.model(plane)
    want_best, want_k2 = T._rice_search_plain(torch.from_numpy(plane))
    assert np.all(best == 10) and np.array_equal(best, want_best.numpy())
    assert np.array_equal(k2, want_k2.numpy())
    assert set(np.unique(k2).tolist()) == set(range(32))


@pytest.mark.parametrize("n,max_porder,threads,lcpp,chunk", [
    (10240, 10, 512, 0, 10), (8192, 10, 512, 0, 8), (10239, 0, 512, 9, 20),
    (4410, 1, 288, 8, 9), (1, 0, 32, 0, 1), (3, 0, 32, 1, 2)])
def test_kernel_plan(n, max_porder, threads, lcpp, chunk):
    """linne_rice_search's plan: a thread for every ~16 samples up to 512,
    each finest partition in the fewest power-of-two chunks (none empty)
    that give every thread an item."""
    assert T.max_porder_for(n) == max_porder
    assert RM.plan(n, max_porder) == (threads, lcpp, chunk)


def test_cpu_tensor_takes_the_plain_search():
    """rice_search on a CPU tensor is the plain version's, at any
    compute_dtype, and launches nothing."""
    before = dict(AS.KERNEL_LAUNCHES)
    for n in (3, 4410, 10240):
        x = torch.from_numpy(_rice_rows(n, 1))
        for dtype in (torch.float64, torch.float32):
            got = T.rice_search(x, dtype)
            want = T._rice_search_plain(x, dtype)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert AS.KERNEL_LAUNCHES == before


def test_kernel_log_optx_is_the_plain_versions():
    """The kernel's _LOG_OPTX literal is the plain version's bits."""
    src = (REPO_ROOT / "linne_tpu_torch" / "csrc" / "analysis_scans.cu"
           ).read_text()
    m = re.search(r"kRsLogOptx = (-0x[0-9a-f.]+p-?\d+);", src)
    assert m and float.fromhex(m.group(1)) == T._LOG_OPTX
