"""The roofline module's work functions against hand counts at small
shapes, and against a count of the multiply-adds of a plain loop."""

from __future__ import annotations

import pytest

from benchmark import roofline


def test_levinson_durbin_hand_count():
    # one block, one channel, 16 samples, one layer of order 2, one ridge:
    # the estimate's recursion of order 2 (with reflection coefficients),
    # the layer's at 1 unit (order 2) and 2 units (order 1 each)
    ops, nbytes = roofline.levinson_durbin_work(1, 1, 16, (2,), 1)
    est = (2 * 2 * 3 + 2, 8 * (3 + 4))
    one = (2 * 2 * 3 + 2, 8 * (3 + 2))
    two = (2 * (2 * 1 * 2 + 1), 2 * 8 * (2 + 1))
    assert (ops, nbytes) == (est[0] + one[0] + two[0],
                             est[1] + one[1] + two[1])


def _plain_predict_mads(n: int, order: int, u: int) -> int:
    """Multiply-adds of the unit-split prediction as a plain loop."""
    npu, ns = order // u, n // u
    count = 0
    for unit in range(u):
        for t in range(npu, ns):
            for _j in range(npu):
                count += 1
    return count


@pytest.mark.parametrize("n,order,u", [(16, 4, 1), (16, 4, 2), (16, 4, 4),
                                       (64, 32, 8), (40, 2, 2)])
def test_predict_rows_against_a_loop(n, order, u):
    ops, nbytes = roofline.predict_rows_work([(n, order, u)])
    assert ops == _plain_predict_mads(n, order, u)
    assert nbytes == 4 * (2 * n + order + 2)


def test_share_pct():
    # 1e12 multiply-adds a second of 16.73e12: the bound is the larger
    assert roofline.share_pct(roofline.INT32_MAD_PER_S, roofline
                              .INT32_MAD_PER_S, 0, 2.0) == pytest.approx(50)
    assert roofline.share_pct(0, 1, roofline.HBM_BYTES_PER_S,
                              4.0) == pytest.approx(25)
    assert roofline.share_pct(1, 1, 1, 0) is None


def test_other_kernels_hand_counts():
    assert roofline.quantize_coefficients_work(1, 2, (4, 8)) == (
        2 * 5 * 12, 2 * (8 * 12 + 4 * 12 + 4 * 2))
    assert roofline.levinson_serial_work(3, 4) == (3 * (2 * 4 * 5 + 4),
                                                   3 * 8 * 9)
    assert roofline.serial_abs_mean_work(2, 10) == (40, 2 * 8 * 11)
    assert roofline.chain_predict_work(1, 10, 3) == (2 * 3 * 7,
                                                     8 * (20 + 3))
    assert roofline.autocorr_serial_work(1, 10, 3) == (2 * 3 * 9, 8 * 13)
    assert roofline.quantize_layer_work(2, 4) == (40, 2 * (32 + 16 + 4))
