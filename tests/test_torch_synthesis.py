"""The port's synthesis recurrence (linne_tpu_torch.ops.synthesis).

On the CPU the plain torch version is held bit-equal to the JAX reference's
lax.scan formulation and to its Pallas kernel in interpret mode. The CUDA
kernel itself is compared with the plain version in test_torch_cuda.py,
which skips without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linne_tpu.ops.synthesis import synthesize_rows_tpu, synthesize_rows_xla
from linne_tpu_torch.ops import synthesis as S


def _inputs(seed, rows, ns, npu, coef_bits=14):
    rng = np.random.default_rng(seed)
    x = rng.integers(-30000, 30000, (rows, ns)).astype(np.int32)
    # coefficients up to 2^14 make the int32 accumulator wrap
    c = rng.integers(-(1 << coef_bits), 1 << coef_bits,
                     (rows, npu)).astype(np.int32)
    rs = rng.integers(8, 15, rows).astype(np.int32)
    rs[::7] = 0        # corrupt-stream guard: half = 0, no shift
    return x, c, rs


def _ref(x, c, rs):
    return S.synthesize_rows_ref(torch.from_numpy(x), torch.from_numpy(c),
                                 torch.from_numpy(rs)).numpy()


@pytest.mark.parametrize("rows,ns,npu", [(8, 256, 4), (130, 300, 8)])
def test_ref_matches_xla_and_pallas_interpret(rows, ns, npu):
    x, c, rs = _inputs(rows + ns, rows, ns, npu)
    got = _ref(x, c, rs)
    args = (jnp.asarray(x), jnp.asarray(c), jnp.asarray(rs))
    assert np.array_equal(got, np.asarray(synthesize_rows_xla(*args)))
    assert np.array_equal(got, np.asarray(synthesize_rows_tpu(*args)))


@pytest.mark.parametrize("rows,ns,npu", [(5, 600, 32), (3, 200, 128),
                                         (4, 64, 1)])
def test_ref_matches_xla_wide_taps(rows, ns, npu):
    x, c, rs = _inputs(npu, rows, ns, npu)
    want = synthesize_rows_xla(jnp.asarray(x), jnp.asarray(c),
                               jnp.asarray(rs))
    assert np.array_equal(_ref(x, c, rs), np.asarray(want))


def test_short_rows_pass_through():
    x, c, rs = _inputs(1, 4, 8, 8)
    assert np.array_equal(_ref(x, c, rs), x)


def test_wrapper_takes_plain_version_on_cpu():
    x, c, rs = _inputs(2, 6, 100, 4)
    before = S.KERNEL_LAUNCHES
    out = S.synthesize_rows(torch.from_numpy(x), torch.from_numpy(c),
                            torch.from_numpy(rs))
    assert np.array_equal(out.numpy(), _ref(x, c, rs))
    assert S.KERNEL_LAUNCHES == before  # no kernel on CPU tensors


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows", "contig"])
def test_wrapper_rejects_bad_inputs(bad):
    x, c, rs = (torch.from_numpy(a) for a in _inputs(3, 4, 50, 4))
    if bad == "dtype":
        x = x.to(torch.int64)
    elif bad == "shape":
        x = x[None]
    elif bad == "rows":
        rs = rs[:3]
    else:
        x = x.t().contiguous().t()
    with pytest.raises((TypeError, ValueError)):
        S.synthesize_rows(x, c, rs)
