"""The work that `rice_search_roofline` counts: against a plain loop over
the rows, orders and samples at small shapes, the count of one 128-block
batch of each encode cell, and the reader's silence where the trace has
no such kernel (the program before the kernel)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import roofline, run


def _metric():
    return run.reader("metrics", "rice_search_roofline")


def _plain_ops(blocks, channels, n):
    """The operations as a loop: a row's samples each take a load, a code
    and an add to the finest sum, and a shift, a clamp and an add at every
    order."""
    m = _metric()
    orders = m.max_porder(n) + 1
    count = 0
    for _row in range(blocks * channels):
        for _t in range(n):
            count += 3
            for _order in range(orders):
                count += 3
    return count


@pytest.mark.parametrize("n,mp", [(1, 0), (3, 0), (96, 5), (1000, 3),
                                  (4410, 1), (8192, 10), (10240, 10),
                                  (10239, 0)])
def test_max_porder(n, mp):
    assert _metric().max_porder(n) == mp


@pytest.mark.parametrize("blocks,channels,n", [(2, 2, 96), (3, 1, 1000),
                                               (1, 2, 4410)])
def test_operations_against_a_loop(blocks, channels, n):
    ops, nbytes = _metric().work(blocks, channels, n)
    assert ops == _plain_ops(blocks, channels, n)
    parts = 1 << _metric().max_porder(n)
    assert nbytes == 4 * blocks * channels * (n + 1 + parts)


def test_a_batch_of_each_encode_cell():
    # 256 rows of 10240 at 11 orders: 36 operations a sample, 94.4 M, and
    # 10.5 MB read: bound by the operations at either preset (the search
    # does not depend on the layers)
    ops, nbytes = _metric().work(128, 2, 10240)
    assert ops == 256 * 10240 * 36
    assert nbytes == 4 * 256 * (10240 + 1 + 1024)
    assert ops / roofline.INT32_MAD_PER_S > nbytes / roofline.HBM_BYTES_PER_S


def _ctx(kernel_s):
    config = {"format": {"num_channels": 2, "num_samples_per_block": 10240}}
    return {"trace": SimpleNamespace(kernel_s=kernel_s), "config": config,
            "full_blocks": 688}


def test_share_and_silence():
    m = _metric()
    ops, _ = m.work(688, 2, 10240)
    secs = 4 * ops / roofline.INT32_MAD_PER_S
    assert m.read(_ctx({"rice_search_kernel": secs})) == pytest.approx(25)
    # the byte-exact framing's search runs on the host: no kernel
    assert m.read(_ctx({"lpc_autocorr_kernel": 1.0,
                        "unit_residual_kernel": 1.0})) is None
    assert m.read(dict(_ctx({}), trace=None)) is None
