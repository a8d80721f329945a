"""The work that `unit_residual_select_roofline` counts, against a hand
count at a small shape and a count of the multiply-adds of a plain loop;
and the reader's silence where the trace has no such kernel (the
program before the kernel)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import roofline, run


def _metric():
    return run.reader("metrics", "unit_residual_select_roofline")


def _plain_mads(blocks, channels, n, orders, ridges):
    """The residual pass's multiply-adds as a plain loop over ridges,
    layers, candidates, rows, samples and taps."""
    count = 0
    for _r in range(ridges):
        for order in orders:
            for u in roofline.unit_counts(order, n):
                for _row in range(blocks * channels):
                    for _t in range(n):
                        count += order // u
    return count


def test_hand_count():
    # one block, two channels, 16 samples, layers of order 2 (units 1, 2)
    # and 4 (units 1, 2, 4), three ridge terms
    ops, nbytes = _metric().work(1, 2, 16, (2, 4), 3)
    mads = 3 * 2 * 16 * ((2 + 1) + (4 + 2 + 1))
    assert ops == 2 * mads
    inputs = 8 * 2 * 16 * (1 + 3)
    coefs = 8 * 3 * 2 * (2 * 2 + 4 * 3)
    winners = 3 * 2 * (2 * (8 * 16 + 8 + 4) + 8 * (2 + 4))
    assert nbytes == inputs + coefs + winners


@pytest.mark.parametrize("orders,n,ridges", [((4, 128, 16), 256, 4),
                                             ((2, 32), 64, 1)])
def test_operations_against_a_loop(orders, n, ridges):
    ops, _ = _metric().work(2, 2, n, orders, ridges)
    assert ops == 2 * _plain_mads(2, 2, n, orders, ridges)


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
    assert ops / roofline.FP64_FLOPS > nbytes / roofline.HBM_BYTES_PER_S
    assert m.read(_ctx({"unit_residual_kernel": secs})) == pytest.approx(50)
    assert m.read(_ctx({"levinson_kernel": 1.0})) is None
    assert m.read(dict(_ctx({}), trace=None)) is None
