"""The work that `lpc_autocorr_roofline` counts: against a hand count at a
small shape, a plain loop over the products, and the multiply-adds of one
128-block batch of each encode cell; and the reader's silence where the
trace has no such kernel (the program before the kernel)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import roofline, run


def _metric():
    return run.reader("metrics", "lpc_autocorr_roofline")


def _plain_mads(blocks, channels, n, orders, ridges):
    """The multiply-adds as a loop over the rows, units, lags and products:
    the estimate and the first layer once a row, later layers once a ridge
    term and row."""
    count = 0
    rows = blocks * channels
    for _row in range(rows):
        for t in range(n):
            for lag in range(orders[0] + 1):
                count += t + lag < n
    for li, order in enumerate(orders):
        for _copy in range(rows * (1 if li == 0 else ridges)):
            for u in roofline.unit_counts(order, n):
                ns = n // u
                for _unit in range(u):
                    for t in range(ns):
                        for lag in range(order // u + 1):
                            count += t + lag < ns
    return count


def test_hand_count():
    # one block, two channels, 16 samples, layers of order 2 (units 1, 2)
    # and 4 (units 1, 2, 4), three ridge terms
    ops, nbytes = _metric().work(1, 2, 16, (2, 4), 3)
    est = 16 + 15 + 14  # lags 0..2 over 16 samples
    first = est + 2 * (8 + 7)  # u = 1: lags 0..2; u = 2: two units, 0..1
    second = (16 + 15 + 14 + 13 + 12) + 2 * (8 + 7 + 6) + 4 * (4 + 3)
    assert ops == 2 * (2 * est + 2 * first + 3 * 2 * second)
    inputs = 8 * (2 * 16 + 2 * 16 + 3 * 2 * 16)
    windows = 8 * (16 + (16 + 8) + (16 + 8 + 4))
    acs = 8 * (2 * 3 + 2 * (3 + 2 * 2) + 3 * 2 * (5 + 2 * 3 + 4 * 2))
    assert nbytes == inputs + windows + acs


@pytest.mark.parametrize("orders,n,ridges", [((4, 128, 16), 256, 4),
                                             ((2, 32), 64, 1),
                                             ((4, 128), 96, 2)])
def test_operations_against_a_loop(orders, n, ridges):
    ops, _ = _metric().work(2, 2, n, orders, ridges)
    assert ops == 2 * _plain_mads(2, 2, n, orders, ridges)


# 3.157 G and 0.202 G multiply-adds a batch: the estimate and the first
# layer on 256 rows, the later layers on 256 rows a ridge term; preset 7
# bound by its operations, preset 0 by its 63.8 MB
@pytest.mark.parametrize("orders,ridges,mads,by_ops", [
    ((4, 128, 16), 4, 256 * (51190 + 102380) + 1024 * (2676288 + 368352),
     True),
    ((2, 32), 1, 256 * (30717 + 51195 + 705456), False)])
def test_a_batch_of_each_encode_cell(orders, ridges, mads, by_ops):
    ops, nbytes = _metric().work(128, 2, 10240, orders, ridges)
    assert ops == 2 * mads
    assert (ops / roofline.FP64_FLOPS
            > nbytes / roofline.HBM_BYTES_PER_S) == by_ops


def _ctx(kernel_s):
    config = {"format": {"num_channels": 2, "num_samples_per_block": 10240},
              "layer_num_params": [4, 128, 16],
              "ridge_terms": [0.0, 0.1, 0.2, 0.3]}
    return {"trace": SimpleNamespace(kernel_s=kernel_s), "config": config,
            "full_blocks": 688}


def test_share_and_silence():
    m = _metric()
    ops, nbytes = m.work(688, 2, 10240, (4, 128, 16), 4)
    secs = 2 * ops / roofline.FP64_FLOPS
    assert m.read(_ctx({"lpc_autocorr_kernel": secs})) == pytest.approx(50)
    # the byte-exact fit's kernel and the residual pass are not this one
    assert m.read(_ctx({"autocorr_kernel": 1.0,
                        "unit_residual_kernel": 1.0})) is None
    assert m.read(dict(_ctx({}), trace=None)) is None
