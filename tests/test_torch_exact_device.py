"""The port's byte-exact device fit (linne_tpu_torch/ops/exact_device.py and
its serial chains, ops/exact_serial.py) against the JAX package's strict
graph on the same seeded inputs.

Both run IEEE float64 on the CPU with every operation rounded on its own,
so every comparison of the strict graph is bit for bit (float64 compared as
int64 bits, so that -0.0 and +0.0 differ too). The JAX side runs on XLA:CPU
as tests/test_exact_device.py runs it; its compile time dominates, so its
results are shared through module-scoped fixtures. N = 2048 keeps the full
unit-level sweep and a fast compile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from linne_tpu.ops import exact_device as J
from linne_tpu_torch.ops import exact_device as T
from linne_tpu_torch.ops import exact_serial as S
from linne_tpu_torch.presets import PRESETS

BPS = 16
CB = 8  # LPC_COEF_BITWIDTH
N = 2048


def _signal(B, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    rows = [np.round(rng.uniform(1500, 24000)
                     * np.sin(2 * np.pi * rng.uniform(60, 6000) * t / 44100)
                     + rng.normal(0, rng.uniform(15, 2500), n))
            for _ in range(B)]
    return np.clip(np.stack(rows), -32768, 32767).astype(np.int32)


@pytest.fixture
def _one_torch_thread():
    """One intra-op thread per test: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fit_input(preset_idx):
    """Three rows and an all-zero row (the zero-signal early-out lane)."""
    sig = _signal(4, N, seed=10 + preset_idx)
    sig[2] = 0
    return sig


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype == np.float64 or b.dtype == np.float64:
        return (a.dtype == b.dtype
                and np.array_equal(a.view(np.int64), b.view(np.int64)))
    return np.array_equal(a, b)


def _assert_same(ours: dict, theirs: dict):
    assert set(ours) == set(theirs)
    for k in theirs:
        assert _bits_equal(ours[k], theirs[k]), k


def _np(tree):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_fits():
    """linne_tpu's strict fit outputs per preset (0: one ridge term, 1: two)."""
    out = {}
    for pi in (0, 1):
        p = PRESETS[pi]
        fit = J.build_fit_fn(p.layer_num_params, p.ridge_terms, N, BPS, CB,
                             strict=True)
        out[pi] = _np(fit(jnp.asarray(_fit_input(pi))))
    return out


@pytest.mark.parametrize("preset_idx", [0, 1])
def test_strict_fit_bit_equal_to_jax(jax_fits, preset_idx):
    """Every output of the fit, the guard margins and the arena arrays
    included."""
    p = PRESETS[preset_idx]
    fit = T.build_fit_fn(p.layer_num_params, p.ridge_terms, N, BPS, CB,
                         strict=True)
    _assert_same(_np(fit(torch.from_numpy(_fit_input(preset_idx)))),
                 jax_fits[preset_idx])


@pytest.mark.parametrize("n", [2560, 10240])
def test_abs_mean_divides_where_the_jitted_jax_graph_multiplies(n):
    """The strict mean's last step, sum / n. The port divides, as the host
    oracle does (linne_tpu/exact/network.py: _serial_sum(|x|) / n). XLA
    rewrites the jitted JAX graph's division by the constant n into a
    multiply by the rounded reciprocal 1/n (linne_tpu/ops/exact_device.py
    :_serial_abs_mean, `acc / n`): at an n that is not a power of two, a
    share of its means sit one ulp from the quotient. Eager JAX, as
    test_serial_abs_mean_bit_equal_to_jax calls it, divides."""
    from linne_tpu.exact.lpc import _serial_sum

    rows = np.random.default_rng(n).normal(0, 0.3, (64, n))
    acc = np.array([_serial_sum(np.abs(r[1:n])) for r in rows])
    got = S.serial_abs_mean(torch.from_numpy(rows), 1, n).numpy()
    assert _bits_equal(got, acc / n)
    # the two roundings differ at this n, so the check below tells them
    # apart
    assert np.any(acc * (1.0 / n) != acc / n)
    jitted = np.asarray(jax.jit(lambda r: J._serial_abs_mean(r, 1, n))(
        jnp.asarray(rows)))
    # the reciprocal multiply, or the quotient where an XLA build keeps
    # the division
    assert (_bits_equal(jitted, acc * (1.0 / n))
            or _bits_equal(jitted, acc / n))


def _preset7_flagged_row():
    """The one row the byte-exact guard flags on the bench's preset-7
    corpus (96 tracks of 4 blocks of bench.make_signal; chip_smoke.py's
    guard phase): track 27, block 2, channel 1, after MS and
    pre-emphasis."""
    from linne_tpu_torch import bench
    from linne_tpu_torch.exact.device_encoder import preemph_plane

    spb, tlen = 10240, 4 * 10240
    sig = bench.make_signal(96 * tlen)[:, 27 * tlen + 2 * spb:
                                       27 * tlen + 3 * spb]
    plane = preemph_plane(bench.stereo_param(44100, spb, 7),
                          [sig[0], sig[1]], spb)
    return np.ascontiguousarray(plane[1:2])


def _preset7_fit_parts(row):
    """The port's strict preset-7 fit of `row`, with every level argmin's
    losses and gap, every layer's zc_margin and every level-loss mean's
    serial sum recorded, in call order (terms x layers)."""
    from linne_tpu.exact.lpc import _serial_sum

    p = PRESETS[7]
    rec = {"losses": [], "gap": [], "zc": [], "acc": []}
    real_min, real_fits, real_mean = (T._first_strict_min,
                                      T._layer_level_fits,
                                      T._serial_abs_mean)

    def first_strict_min(losses):
        best, gap = real_min(losses)
        rec["losses"].append(losses.numpy().copy())
        rec["gap"].append(gap.numpy().copy())
        return best, gap

    def layer_level_fits(*args, **kw):
        out = real_fits(*args, **kw)
        rec["zc"].append(out[6].numpy().copy())
        return out

    def serial_abs_mean(rows, start, n, strict=True):
        if rows.dim() == 3:  # the level losses [B, L, n]
            a = rows.numpy()
            rec["acc"].append(np.array(
                [[_serial_sum(np.abs(a[b, li, start:n]))
                  for li in range(a.shape[1])] for b in range(a.shape[0])]))
        return real_mean(rows, start, n, strict)

    T._first_strict_min = first_strict_min
    T._layer_level_fits = layer_level_fits
    T._serial_abs_mean = serial_abs_mean
    try:
        fit = T.build_fit_fn(p.layer_num_params, p.ridge_terms, 10240, BPS,
                             CB, strict=True)
        out = _np(fit(torch.from_numpy(row)))
    finally:
        T._first_strict_min = real_min
        T._layer_level_fits = real_fits
        T._serial_abs_mean = real_mean
    return out, rec


def _jit_first_strict_min(losses):
    return jax.jit(J._first_strict_min)(jnp.asarray(losses))


@pytest.mark.usefixtures("_one_torch_thread")
def test_preset7_selection_margin_is_a_level_gap_of_ieee_means():
    """margins[:, 0] of the preset-7 row the guard flags is the level
    argmin gap of layer 3 (order 16) at ridge term 0, not a zc_margin or
    the ridge-term gap. The gap formula rounds alike on both sides (the
    jitted JAX _first_strict_min gives the port's gaps bit for bit on the
    port's losses); the losses are the port's IEEE means, sum / n. With
    the JAX graph's reciprocal multiply the same sums give losses that
    differ in their last bit and a gap that differs in its last ~14 bits
    (the runner-up is 3.6e-5 from the winner, so the subtraction cancels
    most of the bits). That is the divergence in margins[:, 0] against
    the JAX package's preset-7 strict graph: the JAX side's rounding, not
    the port's."""
    row = _preset7_flagged_row()
    out, rec = _preset7_fit_parts(row)
    n = 10240
    # one fit pass over the 4 ridge terms' rows (row t is term t), three
    # layers
    assert len(rec["gap"]) == len(rec["zc"]) == len(rec["acc"]) == 3
    margin = out["margins"][0, 0]
    gaps = np.stack(rec["gap"])  # [L, T]
    zcs = np.stack(rec["zc"])
    assert np.min(zcs) > margin
    assert margin == gaps.min()
    assert np.argwhere(gaps == margin).tolist() == [[2, 0]]
    for losses, gap, acc in zip(rec["losses"], rec["gap"], rec["acc"]):
        assert _bits_equal(losses, acc / n)
        _best, jgap = _jit_first_strict_min(losses)
        assert _bits_equal(np.asarray(jgap), gap)
    recip = [_jit_first_strict_min(acc * (1.0 / n))[1]
             for acc in rec["acc"]]
    recip_margin = np.min(np.stack([np.asarray(g) for g in recip]))
    assert recip_margin != margin
    assert abs(recip_margin - margin) < 1e-11 * margin


@pytest.mark.usefixtures("_one_torch_thread")
def test_preset7_flagged_row_against_the_jax_strict_graph():
    """The JAX package's preset-7 strict graph (~20 s of XLA compile on
    the CPU) on the flagged row: every output bit-equal to the port's but
    margins[:, 0], which is the level gap the JAX graph's reciprocal
    multiply gives (see the test above), or the port's where an XLA build
    keeps the division."""
    row = _preset7_flagged_row()
    out, rec = _preset7_fit_parts(row)
    p = PRESETS[7]
    want = _np(J.build_fit_fn(p.layer_num_params, p.ridge_terms, 10240,
                              BPS, CB, strict=True)(jnp.asarray(row)))
    for k in want:
        if k != "margins":
            assert _bits_equal(out[k], want[k]), k
    assert _bits_equal(out["margins"][:, 1:], want["margins"][:, 1:])
    # the JAX graph's margins[:, 0] is the gap of the reciprocal-multiplied
    # means, or the port's where an XLA build keeps the division
    recip = min(np.asarray(_jit_first_strict_min(acc * (1.0 / 10240))[1]
                           ).min() for acc in rec["acc"])
    assert (_bits_equal(want["margins"][:, 0], np.array([recip]))
            or _bits_equal(want["margins"][:, 0], out["margins"][:, 0]))


def test_strict_is_the_default(monkeypatch):
    monkeypatch.delenv("LINNE_EXACT_DEVICE_STRICT", raising=False)
    assert T._resolve_strict(None) is True
    monkeypatch.setenv("LINNE_EXACT_DEVICE_STRICT", "0")
    assert T._resolve_strict(None) is False
    assert T._resolve_strict(True) is True


def test_packed_fit_matches_dict():
    """build_packed_fit_fn is a re-layout of build_fit_fn: two buffers,
    bit-equal entries after unpack."""
    p = PRESETS[1]  # two ridge terms: exercises best_term packing
    sig = torch.from_numpy(_signal(3, N, seed=77))
    want = _np(T.build_fit_fn(p.layer_num_params, p.ridge_terms, N, BPS,
                              CB)(sig))
    pfit, unpack = T.build_packed_fit_fn(p.layer_num_params, p.ridge_terms,
                                         N, BPS, CB)
    f64, i32 = pfit(sig)
    assert f64.dtype == torch.float64 and i32.dtype == torch.int32
    got = unpack(f64.numpy(), i32.numpy())
    assert set(got) == set(want)
    for k in want:
        assert _bits_equal(np.asarray(got[k], want[k].dtype), want[k]), k


@pytest.fixture(scope="module")
def final_pass_case():
    """Inputs of the -a N final pass and linne_tpu's stage outputs, layer
    by layer: rows at two ridge terms, and forward params made from the
    search's winner (a seeded perturbation of zero, like a host refit)."""
    p = PRESETS[1]
    lps = p.layer_num_params
    sig = _signal(3, N, seed=81)
    terms = np.array([0.0, p.ridge_terms[1], 0.0])
    rng = np.random.default_rng(82)
    params = [rng.normal(0, 0.05, (3, P)) for P in lps]
    to_f64, searches, forwards = J.build_final_pass_fns(lps, N, BPS,
                                                        strict=True)
    buf = to_f64(jnp.asarray(sig))
    want = []
    for li in range(len(lps)):
        s = searches[li](buf, jnp.asarray(terms))
        buf = forwards[li](buf, jnp.asarray(params[li]), s["best"])
        want.append((_np(s), np.asarray(buf)))
    return lps, sig, terms, params, want


def test_final_pass_stages_bit_equal_to_jax(final_pass_case):
    lps, sig, terms, params, want = final_pass_case
    to_f64, searches, forwards = T.build_final_pass_fns(lps, N, BPS,
                                                        strict=True)
    buf = to_f64(torch.from_numpy(sig))
    t = torch.from_numpy(terms)
    for li in range(len(lps)):
        s = searches[li](buf, t)
        buf = forwards[li](buf, torch.from_numpy(params[li]), s["best"])
        _assert_same(_np(s), want[li][0])
        assert _bits_equal(buf.numpy(), want[li][1])


def test_fast_mode_decisions_match_strict():
    """Fast mode (plain torch reductions, another summation order): the
    same decisions as the strict graph. Floats: 1e-12 relative, with a
    1e-11 absolute floor, because a coefficient near zero carries the same
    ~1e-13 absolute rounding difference as the large ones (the JAX
    package's own fast-mode test allows 1e-9 absolute)."""
    p = PRESETS[1]
    sig = torch.from_numpy(_signal(4, N, seed=606))
    a = _np(T.build_fit_fn(p.layer_num_params, p.ridge_terms, N, BPS, CB,
                           strict=True)(sig))
    b = _np(T.build_fit_fn(p.layer_num_params, p.ridge_terms, N, BPS, CB,
                           strict=False)(sig))
    for key in ("units", "int_coefs", "rshifts", "best_term", "arena_best",
                "arena_zc"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_allclose(b["params"], a["params"], rtol=1e-12,
                               atol=1e-11)
    np.testing.assert_allclose(b["arena_parcor"], a["arena_parcor"],
                               rtol=1e-12, atol=1e-11)


# -- the serial building blocks (the kernels' plain versions) ----------------


def _special_segments(kind, ns, rng):
    """[4, 2, ns] segments for the edge values of the NaN shield (`mulsh`):
    NaN and +-Inf samples (NaN products, 0 * Inf, and Inf - Inf sums),
    -0.0 and +0.0 runs, or subnormals beside tiny normals. XLA:CPU runs
    with subnormals flushed to zero, so the subnormal case keeps every
    product that meets a subnormal below the subnormal range, where IEEE
    rounding and the flush agree (+-0.0)."""
    seg = rng.normal(0, 0.3, (4, 2, ns))
    if kind == "nonfinite":
        seg[0, 0, 3] = np.nan
        seg[0, 1, 5] = np.inf
        seg[1, 0, [2, 9]] = [np.inf, -np.inf]
        seg[1, 1, :] = np.nan
        seg[2, 0, ::2] = np.inf
        seg[2, 0, 1::2] = 0.0
        seg[3, 1, ns // 2] = -np.inf
    elif kind == "signed_zero":
        seg[0, 0] = -0.0
        seg[1, 0, ::3] = -0.0
        seg[1, 1, 1::2] = 0.0
        seg[2, 1] = np.where(rng.random(ns) < 0.5, -0.0, 0.0)
    else:  # subnormal
        tiny = rng.normal(0, 1e-22, (4, 2, ns))
        sub = rng.uniform(-1.0, 1.0, (4, 2, ns)) * 2.0 ** -1030
        seg = np.where(rng.random((4, 2, ns)) < 0.5, sub, tiny)
        seg[3, 0] = sub[3, 0]
    return seg


@pytest.mark.parametrize("ns,nlags,special", [
    pytest.param(64, 1, None, id="64-1"),
    pytest.param(64, 33, None, id="64-33"),
    pytest.param(81, 9, None, id="81-9"),
    pytest.param(2048, 3, None, id="2048-3"),
    pytest.param(130, 129, None, id="130-129"),
    pytest.param(16, 16, None, id="16-16"),
    pytest.param(37, 9, "nonfinite", id="37-9-nonfinite"),
    pytest.param(16, 16, "nonfinite", id="16-16-nonfinite"),
    pytest.param(37, 9, "signed_zero", id="37-9-signed_zero"),
    pytest.param(37, 9, "subnormal", id="37-9-subnormal"),
])
def test_autocorr_serial_bit_equal_to_jax(ns, nlags, special):
    """Odd and even lengths, one lag up to 129 lags, nlags == ns; NaN,
    +-Inf, -0.0 and subnormal samples."""
    rng = np.random.default_rng(ns + nlags)
    if special is None:
        seg = rng.normal(0, 0.3, (3, 2, ns))
        seg[1, 0] = 0.0
    else:
        seg = _special_segments(special, ns, rng)
    want = np.asarray(J._autocorr_serial(jnp.asarray(seg), nlags))
    got = S.autocorr_serial(torch.from_numpy(seg), nlags)
    assert _bits_equal(got.numpy(), want)


def test_autocorr_serial_keeps_subnormals_like_the_host_oracle():
    """Subnormal samples and products, which XLA:CPU flushes to zero: the
    plain version keeps them as the JAX package's host oracle does
    (linne_tpu.native.exact_autocorr, the reference C encoder's serial
    sum), bit for bit."""
    from linne_tpu import native

    rng = np.random.default_rng(7)
    ns, nlags = 53, 9
    seg = np.concatenate([
        rng.normal(0, 1, (2, ns)) * 2.0 ** -1040,  # subnormal samples
        rng.normal(0, 1, (2, ns)) * 2.0 ** -530,   # subnormal products
        rng.normal(0, 1, (2, ns)) * 2.0 ** -1000,  # normal beside subnormal
    ])
    seg[4, ::2] *= 2.0 ** -40
    got = S.autocorr_serial(torch.from_numpy(seg), nlags).numpy()
    want = np.stack([native.exact_autocorr(row, nlags) for row in seg])
    assert np.any((want != 0) & (np.abs(want) < np.finfo(np.float64).tiny))
    assert _bits_equal(got, want)


def _ac_rows(order, seed):
    """Autocorrelation rows of windowed noise-plus-tone segments, with a
    zero-signal row (|r0| < FLT_EPSILON) and a tiny one."""
    rng = np.random.default_rng(seed)
    ns = 4 * order + 16
    t = np.arange(ns)
    seg = (rng.normal(0, 0.05, (5, ns))
           + 0.4 * np.sin(2 * np.pi * rng.uniform(0.01, 0.2, (5, 1)) * t))
    seg[1] = 0.0
    seg[3] *= 1e-6
    return np.array(J._autocorr_serial(jnp.asarray(seg[:, None]),
                                       order + 1))[:, 0]


@pytest.mark.parametrize("order", [1, 2, 31, 32, 33, 64])
def test_levinson_serial_bit_equal_to_jax(order):
    """The unrolled recursion (order <= 32) and the scan tail (above)."""
    ac = _ac_rows(order, order)
    want = [np.asarray(a) for a in J._levinson_serial(jnp.asarray(ac),
                                                      order)]
    got = [a.numpy() for a in S.levinson_serial(torch.from_numpy(ac), order)]
    assert want[2][1] and not want[2][0]  # the zero row took the early-out
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


def _special_ac_rows(order, seed):
    """Autocorrelation rows at the recursion's edges: a constant signal
    (ek exactly 0 after the first step, then 0 / -0), a pure tone (ek near
    0), a NaN lag, +-Inf lags, r0 = +Inf, a zero row (|r0| < FLT_EPSILON)
    and an ordinary row."""
    ac = np.repeat(_ac_rows(order, seed)[:1], 8, axis=0)
    lags = np.arange(order + 1)
    ac[1] = 1.0
    ac[2] = np.cos(0.3 * lags)
    ac[3, min(order, 3)] = np.nan
    ac[4, 1] = np.inf
    ac[5, order] = -np.inf
    ac[6, 0] = np.inf
    ac[7] = 0.0
    return ac


@pytest.mark.usefixtures("_one_torch_thread")
@pytest.mark.parametrize("order", [2, 8, 33])
def test_levinson_serial_special_rows_bit_equal_to_jax(order):
    """NaN and +-Inf lags, ek reaching 0, a tone, the zero case; the
    unrolled recursion (order <= 32) and the scan tail."""
    ac = _special_ac_rows(order, 40 + order)
    want = [np.asarray(a) for a in J._levinson_serial(jnp.asarray(ac),
                                                      order)]
    got = [a.numpy() for a in S.levinson_serial(torch.from_numpy(ac), order)]
    assert want[2][7] and not want[2][1]
    assert np.isnan(want[1][1]).any()  # 0 / -0 at the step after ek = 0
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


@pytest.mark.usefixtures("_one_torch_thread")
@pytest.mark.parametrize("order", [4, 40])
def test_levinson_serial_keeps_subnormals_like_the_host_oracle(order):
    """Lags whose products and coefficients fall in the subnormal range,
    which XLA:CPU flushes to zero: the plain version keeps them as the JAX
    package's host oracle (linne_tpu.native.exact_levinson, the reference
    C encoder's recursion) does, bit for bit."""
    from linne_tpu import native
    from linne_tpu.constants import FLT_EPSILON

    rng = np.random.default_rng(order)
    ac = np.empty((3, order + 1))
    ac[:, 0] = 1.0 + rng.uniform(0, 1, 3)
    ac[:, 1:] = rng.normal(0, 1, (3, order)) * 2.0 ** -530
    ac[1, 1:] *= 2.0 ** -500
    ac[2, 2::2] = rng.normal(0, 0.2, order // 2)
    got = [a.numpy() for a in S.levinson_serial(torch.from_numpy(ac), order)]
    tiny = np.finfo(np.float64).tiny
    for row, coef, parcor in zip(ac, got[0], got[1]):
        want_coef = np.zeros(order + 1)
        want_parcor = np.zeros(order + 1)
        native.exact_levinson(row.copy(), order, FLT_EPSILON, want_coef,
                              want_parcor)
        assert _bits_equal(coef, want_coef[:order])
        assert _bits_equal(parcor, want_parcor[:order])
    assert np.any((got[0] != 0) & (np.abs(got[0]) < tiny))


@pytest.mark.parametrize("units,npu", [(1, 32), (4, 8), (32, 1), (2, 3)])
def test_chain_predict_bit_equal_to_jax(units, npu):
    rng = np.random.default_rng(units * 100 + npu)
    n = 96 * units
    x = rng.normal(0, 0.3, (3, n))
    params = rng.normal(0, 0.5, (3, units, npu))
    want = J._chain_predict(jnp.asarray(x), jnp.asarray(params), units)
    got = S.chain_predict(torch.from_numpy(x), torch.from_numpy(params))
    for g, w in zip(got, want):
        assert _bits_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("start,n", [(0, 2048), (1, 2048), (1, 77)])
def test_serial_abs_mean_bit_equal_to_jax(start, n):
    rng = np.random.default_rng(start + n)
    rows = rng.normal(0, 0.3, (3, 4, n))
    want = np.asarray(J._serial_abs_mean(jnp.asarray(rows), start, n))
    got = S.serial_abs_mean(torch.from_numpy(rows), start, n)
    assert _bits_equal(got.numpy(), want)


@pytest.mark.usefixtures("_one_torch_thread")
@pytest.mark.parametrize("start,n,kind", [
    pytest.param(0, 77, "nonfinite", id="0-77-nonfinite"),
    pytest.param(1, 77, "nonfinite", id="1-77-nonfinite"),
    pytest.param(0, 64, "signed_zero", id="0-64-signed_zero"),
    pytest.param(1, 64, "signed_zero", id="1-64-signed_zero"),
    pytest.param(64, 64, None, id="64-64-empty"),
    pytest.param(1, 1, None, id="1-1-empty"),
    pytest.param(0, 1, None, id="0-1"),
    pytest.param(1, 61, None, id="1-61-short"),
])
def test_serial_abs_mean_special_values_bit_equal_to_jax(start, n, kind):
    """NaN, +-Inf and -0.0 samples, an empty range (start == n), one
    sample, and n short of the row's length."""
    rng = np.random.default_rng(start + 3 * n)
    rows = rng.normal(0, 0.3, (3, 4, max(n, 64) + 3))
    if kind == "nonfinite":
        rows[0, 0, 3] = np.nan
        rows[0, 1, n - 1] = np.inf
        rows[1, 0, [1, 5]] = [np.inf, -np.inf]
        rows[1, 1, 0] = np.nan
        rows[2, 2, :] = -np.inf
    elif kind == "signed_zero":
        rows[0, 0] = -0.0
        rows[1, 1, ::2] = -0.0
        rows[2, 3] = 0.0
    want = np.asarray(J._serial_abs_mean(jnp.asarray(rows), start, n))
    got = S.serial_abs_mean(torch.from_numpy(rows), start, n)
    assert _bits_equal(got.numpy(), want)


@pytest.mark.usefixtures("_one_torch_thread")
def test_serial_abs_mean_keeps_subnormals_like_the_host_oracle():
    """Subnormal samples, which XLA:CPU flushes to zero: the plain version
    keeps them as the JAX package's host oracle does (the loss of
    linne_tpu/exact/network.py: _serial_sum(|x[start:n]|) / n)."""
    from linne_tpu.exact.lpc import _serial_sum

    rng = np.random.default_rng(5)
    rows = rng.normal(0, 1, (4, 53)) * 2.0 ** -1060
    rows[1, ::3] *= 2.0 ** 40
    rows[2] *= 2.0 ** 100  # normal beside subnormal
    rows[3, 1::2] = -0.0
    for start in (0, 1):
        got = S.serial_abs_mean(torch.from_numpy(rows), start, 53).numpy()
        want = np.array([_serial_sum(np.abs(r[start:53])) / 53 for r in rows])
        assert np.any((want != 0) & (np.abs(want) < np.finfo(np.float64).tiny))
        assert _bits_equal(got, want)


def test_quantize_layer_bit_equal_to_jax():
    """Ordinary rows, a low row (max |coef| under the threshold: zero
    coefficients, rshift = nbits), saturating rows and an exact power of
    two."""
    rng = np.random.default_rng(9)
    coefs = rng.normal(0, 0.4, (6, 32))
    coefs[1] = rng.normal(0, 1e-3, 32)
    coefs[2] *= 300.0
    coefs[3, 5] = 0.5
    coefs[4] = 0.0
    want = [np.asarray(a) for a in J._quantize_layer(jnp.asarray(coefs), CB)]
    got = [a.numpy() for a in T._quantize_layer_plain(torch.from_numpy(coefs),
                                                      CB)]
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


def _arena_rows(orders, seed):
    """[12, sum(orders)] final params, the layers side by side: seeded rows
    at three scales; NaN coefficients (a NaN product counts as 0); max |c|
    exactly 2^-1 and 2^3 (a frexp bin edge: scale margin 0); max |c| at
    the 2^-7 threshold and under it (the low path); all zero; exact .5
    ties of the error feedback at rshift 7 and 12; the +-128 clamp."""
    rng = np.random.default_rng(seed)
    parts = []
    for P in orders:
        c = rng.normal(0, 0.4, (12, P)) * np.array(
            [1.0, 1e-2, 30.0] + [1.0] * 9)[:, None]
        c[3, ::3] = np.nan
        c[4] = np.clip(c[4], -0.49, 0.49)
        c[4, P // 2] = -0.5
        c[5, 0] = 8.0
        c[6] = 2.0 ** -7 * np.where(np.arange(P) % 2, -1, 1)
        c[7] = rng.normal(0, 1e-4, P)
        c[8] = 0.0
        for row, shift in ((9, 7), (10, 12)):
            step = 2.0 ** -shift
            c[row] = (rng.integers(-64, 64, P)
                      + 0.5 * rng.integers(0, 2, P)) * step
            c[row, 0] = 96 * step
        c[11] = np.where(np.arange(P) % 3, 127.49, -127.87) * 2.0 ** -7
        parts.append(c)
    return np.concatenate(parts, axis=1)


@pytest.mark.parametrize("orders", [(4, 128, 16), (2, 32), (32,),
                                    (1, 2, 3, 4)])
def test_quantize_layers_plain_bit_equal_to_jax(orders):
    """_quantize_layers_plain over an arena's layers (the grouped kernel's
    plain version) bit for bit the JAX package's _quantize_layer a layer:
    int coefficients, rshifts, and both margins after their minimum over
    the layers, at NaN coefficients, max |c| at 2^k and at the 2^-7
    threshold, the low path and .5 ties."""
    arena = _arena_rows(orders, sum(orders))
    got = [a.numpy() for a in T._quantize_layers_plain(
        torch.from_numpy(arena), orders, CB)]
    ics, rss = [], []
    rm = sm = np.full(arena.shape[0], np.inf)
    col = 0
    for P in orders:
        ic, rs, lrm, lsm = (np.asarray(a) for a in J._quantize_layer(
            jnp.asarray(arena[:, col:col + P]), CB))
        ics.append(ic)
        rss.append(rs)
        rm, sm = np.minimum(rm, lrm), np.minimum(sm, lsm)
        col += P
    want = [np.concatenate(ics, axis=1), np.stack(rss, axis=1), rm, sm]
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    ic, rs, rm, sm = got
    assert (rs[6] == CB).all() and (rs[7] == CB).all() and not ic[6:9].any()
    assert sm[5] == 0.0 and sm[6] == 0.0  # a bin edge; the threshold
    assert np.isinf(rm[6:9]).all()  # the low path
    if max(orders) >= 16:  # enough taps for the feedback to meet a tie
        assert rm[9] == 0.0 and rm[10] == 0.0


# -- the host (numpy) helpers -----------------------------------------------


def test_level_helpers_equal():
    for lps in ((2, 32), (4, 64, 8), (4, 128, 16)):
        for n in (10240, 2048, 2047, 16, 96):
            assert T.supported(lps, n) == J.supported(lps, n)
            for P in lps:
                assert T._valid_levels(P, n) == J._valid_levels(P, n)
                assert T.final_level_layout(P, n) == J.final_level_layout(P, n)
        terms = (0.0, 1e-5, 1e-4)
        assert T.arena_layout(lps, terms, 10240) == J.arena_layout(
            lps, terms, 10240)


def test_fold_helpers_equal():
    """fold_parcor_state and fold_final_pass leave the same arena as the
    JAX package's on seeded random deposits, zero flags and winners."""
    lps = (4, 128, 16)
    terms = (0.0, 1e-5, 1e-4, 1e-3)
    n = 10240
    entries, L = J.arena_layout(lps, terms, n)
    aw = max(off + w for off, w, _ in entries.values())
    az = max(z for _, _, z in entries.values()) + 1
    nlev = [len(J._valid_levels(P, n)) for P in lps]
    rng = np.random.default_rng(123)
    for _ in range(20):
        out = {
            "arena_parcor": rng.normal(size=(2, aw)),
            "arena_zc": rng.random((2, az)) < 0.3,
            "arena_best": np.array([[rng.integers(0, nlev[li])
                                     for _t in terms for li in range(L)]
                                    for _ in range(2)]),
            "best_term": rng.integers(0, len(terms), size=(2,)),
        }
        for include_final in (True, False):
            a = rng.normal(size=160)
            b = a.copy()
            T.fold_parcor_state(a, out, 2, lps, terms, n, include_final)
            J.fold_parcor_state(b, out, 2, lps, terms, n, include_final)
            assert np.array_equal(a, b)
        finals = [{"parcor": rng.normal(size=sum(
                       npu for _o, npu in J.final_level_layout(P, n))),
                   "zc": rng.random(nlev[li]) < 0.3,
                   "best": int(rng.integers(0, nlev[li]))}
                  for li, P in enumerate(lps)]
        a = rng.normal(size=160)
        b = a.copy()
        T.fold_final_pass(a, finals, lps, n)
        J.fold_final_pass(b, finals, lps, n)
        assert np.array_equal(a, b)


def test_quantize_margins_np_equal():
    rng = np.random.default_rng(31)
    for scale in (1e-3, 0.05, 0.4, 3.0):
        coefs = rng.normal(0, scale, 32)
        assert T.quantize_margins_np(coefs, CB) == J.quantize_margins_np(
            coefs, CB)


def test_jax_side_ran_on_cpu():
    """The reference graph ran on XLA:CPU, where its f64 is IEEE."""
    assert jax.default_backend() == "cpu"
