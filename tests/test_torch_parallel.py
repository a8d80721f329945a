"""Block data parallelism over a device list (linne_tpu_torch/parallel/
mesh.py, `devices=` on TorchEncoder, TorchDecoder and DeviceExactEncoder)
on the CPU, against the one-device port and the JAX package's mesh over
the 8-device CPU mesh (tests/conftest.py).

Rows are independent through every path, so a split over two or three
entries must give the one-device bytes exactly; three entries leave
shards of unequal size and padding rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from linne_tpu import ops as _jax_ops  # noqa: F401  (enables x64)
from linne_tpu.codec import params as jax_params
from linne_tpu.codec.encoder import TpuEncoder
from linne_tpu.codec.tpu_decoder import TpuDecoder
from linne_tpu.parallel import mesh as jax_mesh
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.codec.torch_decoder import TorchDecoder
from linne_tpu_torch.constants import CH_PROCESS_MS
from linne_tpu_torch.exact.device_encoder import DeviceExactEncoder
from linne_tpu_torch.exact.encoder import ExactEncoder
from linne_tpu_torch.parallel import mesh

from conftest import WAVEFORMS
from test_torch_codec import _signal

_SPB = 2560


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the stages dispatch many small ops,
    which slow down when the threads of several test workers oversubscribe
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _param(preset=0, spb=_SPB, cls=EncodeParameter, **kw):
    return cls(num_channels=2, bits_per_sample=16, sampling_rate=44100,
               num_samples_per_block=spb, preset=preset,
               ch_process_method=CH_PROCESS_MS, **kw)


@pytest.fixture(scope="module")
def corpus():
    """tests/test_parallel.py's corpus: three tracks, mixed tails."""
    tracks, lengths = [], []
    for i, name in enumerate(["gauss", "sine", "noise"]):
        ns = _SPB * (3 + i) + (0 if i == 0 else 700 + 13 * i)
        sig = WAVEFORMS[name](ns, 2, 16)
        tracks.append([sig[0], sig[1]])
        lengths.append(ns)
    return tracks, lengths


@pytest.fixture(scope="module")
def one_device_streams(corpus):
    enc = TorchEncoder(batch_blocks=8, device="cpu")
    enc.set_encode_parameter(_param())
    return enc.encode_many(*corpus)


@pytest.mark.parametrize("k", [2, 3])
def test_encode_many_device_list_bytes(corpus, one_device_streams, k):
    enc = TorchEncoder(batch_blocks=8, devices=["cpu"] * k)
    enc.set_encode_parameter(_param())
    got = enc.encode_many(*corpus)
    assert got == one_device_streams

    ref = TpuEncoder(batch_blocks=8,
                     mesh=jax_mesh.make_block_mesh(jax.devices()[:k]))
    ref.set_encode_parameter(_param(cls=jax_params.EncodeParameter))
    assert got == ref.encode_many(*corpus)
    for data, track in zip(got, corpus[0]):
        assert np.array_equal(np.stack(Decoder().decode_whole(data)),
                              np.stack(track))


def test_af_learning_device_list_bytes():
    """-a 1 -l at preset 1: five full blocks in batches of four, the
    second padded, each batch over two entries."""
    spb = 2048
    tracks = [_signal(3 * spb + 1500, 1), _signal(2 * spb, 2)]
    chans = [[t[0], t[1]] for t in tracks]
    lengths = [t.shape[1] for t in tracks]
    streams = []
    for kw in ({"device": "cpu"}, {"devices": ["cpu", "cpu"]}):
        enc = TorchEncoder(batch_blocks=4, **kw)
        enc.set_encode_parameter(_param(1, spb, num_afmethod_iterations=1,
                                        enable_learning=True))
        streams.append(enc.encode_many(chans, lengths))
    assert streams[1] == streams[0]
    for data, t in zip(streams[1], tracks):
        assert np.array_equal(np.stack(Decoder().decode_whole(data)), t)


@pytest.mark.parametrize("k,asked,want", [(2, 7, 8), (3, 8, 9), (1, 7, 7)])
def test_batch_blocks_rounds_up_to_device_count(k, asked, want):
    assert TorchEncoder(batch_blocks=asked,
                        devices=["cpu"] * k).batch_blocks == want


def test_decode_many_device_list(corpus, one_device_streams):
    """Five copies of a stream with a tail block: two block-length groups,
    15 and 5 blocks, over three entries."""
    data = one_device_streams[1]
    datas = [data] * 5
    plain = TorchDecoder(device="cpu").decode_many(datas)
    split = TorchDecoder(devices=["cpu"] * 3).decode_many(datas)
    ref = TpuDecoder(mesh=jax_mesh.make_block_mesh(jax.devices()[:3])
                     ).decode_many(datas)
    sig = np.stack(corpus[0][1])
    for a, b, c in zip(plain, split, ref):
        assert np.array_equal(np.stack(b), np.stack(a))
        assert np.array_equal(np.stack(b), np.stack(c))
        assert np.array_equal(np.stack(b), sig)


def test_decoder_launches_once_per_group_and_shard(one_device_streams,
                                                   monkeypatch):
    """Each shard runs the layer loop on its own rows: one
    synthesize_rows call per (layer group, shard)."""
    from linne_tpu_torch.codec import torch_decoder

    calls = []
    real = torch_decoder.synthesize_rows

    def recording(x, c, rs):
        calls.append(x.shape[0])
        return real(x, c, rs)

    monkeypatch.setattr(torch_decoder, "synthesize_rows", recording)
    datas = [one_device_streams[1]] * 4
    TorchDecoder(device="cpu").decode_many(datas)
    plain = list(calls)
    calls.clear()
    TorchDecoder(devices=["cpu"] * 2).decode_many(datas)
    assert sum(calls) == sum(plain)
    assert len(calls) > len(plain)


def test_device_exact_encoder_device_list(corpus):
    tracks, lengths = corpus
    host = ExactEncoder()
    host.set_encode_parameter(_param())
    refs = [host.encode_whole(t, n) for t, n in zip(tracks[:2], lengths[:2])]
    enc = DeviceExactEncoder(devices=["cpu", "cpu"])
    enc.set_encode_parameter(_param())
    assert enc.encode_many(tracks[:2], lengths[:2]) == refs
    assert enc.guard_rows_flagged == 0
    solo = DeviceExactEncoder(devices=["cpu", "cpu"])
    solo.set_encode_parameter(_param())
    assert solo.encode_whole(tracks[1], lengths[1]) == refs[1]


def test_device_list_refusals():
    with pytest.raises(ValueError):
        DeviceExactEncoder(devices=["cpu"] * 3)  # 128 rows over 3
    for cls in (DeviceExactEncoder, TorchEncoder, TorchDecoder):
        with pytest.raises(ValueError):
            cls(device="cpu", devices=["cpu", "cpu"])


def test_make_block_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        mesh.make_block_mesh()
    with pytest.raises(RuntimeError):
        mesh.make_block_mesh(["cpu", "cuda:0"])
    with pytest.raises(RuntimeError):
        TorchEncoder(devices=["cuda:0"])
    assert mesh.make_block_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2


@pytest.mark.parametrize("rows,k,want", [
    (6, 3, [(0, 2), (2, 4), (4, 6)]),
    (5, 3, [(0, 2), (2, 4), (4, 5)]),
    (1, 3, [(0, 1)]),
    (4, 1, [(0, 4)])])
def test_shards_are_contiguous_and_ordered(rows, k, want):
    got = mesh.shards([torch.device("cpu")] * k, rows)
    assert [(a, b) for _d, a, b in got] == want
    blocks = np.arange(rows * 3).reshape(rows, 3)
    parts = mesh.shard_blocks([torch.device("cpu")] * k, blocks)
    assert np.array_equal(torch.cat(parts).numpy(), blocks)


def _as_port_layout(ref, out, n):
    """The JAX analysis output in the port's packed layout: the JAX side
    tensor carries a residual-width flag and byte-packed coefficient and
    k2 planes, and the residual rides beside it unpacked."""
    packed = np.asarray(out["packed"])
    _ol, _op, off_coefw, off_k2w, side_k, max_parts = ref._side_layout(n)
    total = sum(ref.preset.layer_num_params)
    coefs = TpuEncoder._unpack_bytes(packed[..., off_coefw:off_k2w], total,
                                     signed=True)
    k2s = TpuEncoder._unpack_bytes(packed[..., off_k2w:side_k], max_parts,
                                   signed=False)
    res = np.asarray(out["residual"]).astype(np.int32)
    return np.concatenate([packed[..., :2], packed[..., 3:off_coefw], coefs,
                           k2s, res], axis=-1)


def test_sharded_analyze_matches_jax():
    """The port's sharded_analyze over two and three entries against the
    JAX package's over a two-device mesh, bit for bit (every field of the
    packed result)."""
    samples = WAVEFORMS["gauss"](_SPB * 8, 2, 16)
    blocks = samples.reshape(2, 8, _SPB).transpose(1, 0, 2).copy()

    enc = TorchEncoder(device="cpu")
    enc.set_encode_parameter(_param())
    plain = enc._analyze_fn(_SPB)[0](torch.from_numpy(blocks))
    ref = TpuEncoder(batch_blocks=8)
    ref.set_encode_parameter(_param(cls=jax_params.EncodeParameter))
    want = _as_port_layout(ref, jax_mesh.sharded_analyze(
        ref, jax_mesh.make_block_mesh(jax.devices()[:2]), blocks, _SPB),
        _SPB)
    for k in (2, 3):
        got = mesh.sharded_analyze(enc, ["cpu"] * k, blocks, _SPB)
        assert torch.equal(got, plain)
        assert np.array_equal(got.numpy(), want)


def test_sharded_train_step_matches_jax():
    """One momentum step on the single-unit cascade's L1 loss over two
    entries, float64, against the JAX step over a two-device mesh."""
    orders, n, B = (2, 32), 512, 8
    rng = np.random.default_rng(0)
    params = [rng.normal(0, 0.05, (B, 2, o)) for o in orders]
    momentum = [rng.normal(0, 0.01, (B, 2, o)) for o in orders]
    signal = rng.normal(0, 0.1, (B, 2, n))

    jmesh = jax_mesh.make_block_mesh(jax.devices()[:2])
    jstep = jax_mesh.make_sharded_train_step(jmesh, orders, n, jnp.float64)
    with jmesh:
        jp, jm, jloss = jstep(
            tuple(jax_mesh.shard_blocks(jmesh, jnp.asarray(p))
                  for p in params),
            jax_mesh.shard_blocks(jmesh, jnp.asarray(signal)),
            tuple(jax_mesh.shard_blocks(jmesh, jnp.asarray(m))
                  for m in momentum))

    step = mesh.make_sharded_train_step(mesh.make_block_mesh(["cpu"] * 2),
                                        orders, n, torch.float64)
    tp, tm, tloss = step(tuple(torch.from_numpy(p) for p in params),
                         torch.from_numpy(signal),
                         tuple(torch.from_numpy(m) for m in momentum))
    for got, want in zip(tp + tm, tuple(jp) + tuple(jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=0)
    assert abs(float(tloss) - float(jloss)) <= 1e-12
    assert any(not np.array_equal(got.numpy(), p)
               for got, p in zip(tp, params))
    with pytest.raises(ValueError):  # 9 rows over 2 entries
        step(tuple(torch.from_numpy(p[:1].repeat(9, 0)) for p in params),
             torch.from_numpy(signal[:1].repeat(9, 0)),
             tuple(torch.from_numpy(m[:1].repeat(9, 0)) for m in momentum))
