"""The batched encoder's stage graphs (linne_tpu_torch/codec/graphs.py) on
the CPU, where no CUDA graph can be captured: the stages G1 and G2 hold no
op that a capture refuses (a host read, a data-dependent shape, a tensor
made from host data); the graph wrapper's buffer logic, with a stand-in
for the capture that re-runs the stage on the static buffers, gives the
JAX package's TpuEncoder bytes (and the eager port's) through the
dispatch-ahead pipeline, around the `-a`/`-l` middle and over two shards;
a shape's graphs are captured once and a corpus run again captures
nothing; every tensor a capture reads from outside stays alive with the
encoder; and a CPU device has no StageGraphs. The capture itself is held
to the eager card encode on the card (chip_smoke.py phase 17).
"""

import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from linne_tpu.codec import params as jax_params
from linne_tpu.codec.encoder import TpuEncoder
from linne_tpu.parallel import mesh as jax_mesh
from linne_tpu_torch.codec import encoder as E
from linne_tpu_torch.codec import graphs as G
from linne_tpu_torch.codec.decoder import Decoder
from linne_tpu_torch.codec.encoder import TorchEncoder
from linne_tpu_torch.codec.graphs import StageGraphs
from linne_tpu_torch.codec.params import EncodeParameter
from linne_tpu_torch.constants import CH_PROCESS_MS
from linne_tpu_torch.ops import analysis as A
from linne_tpu_torch.parallel import mesh

SPB = 1024

# what .item() and bool(tensor) dispatch, the data-dependent shapes, and
# what torch.tensor(list) or torch.as_tensor(ndarray) dispatches
_REFUSED = {"aten::_local_scalar_dense", "aten::nonzero",
            "aten::masked_select", "aten::lift_fresh"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the stages run many small ops, which slow down
    when several test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _param(preset, spb=SPB, cls=EncodeParameter, **kw):
    return cls(
        num_channels=2, bits_per_sample=16, sampling_rate=44100,
        num_samples_per_block=spb, preset=preset,
        ch_process_method=CH_PROCESS_MS, **kw)


def _track(n, seed):
    """A tone under noise at one level throughout, stereo 16-bit."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    left = 6000 * np.sin(2 * np.pi * 440 * t / 44100) + rng.normal(0, 900, n)
    right = 0.6 * left + rng.normal(0, 700, n)
    return np.clip(np.round(np.stack([left, right])), -32768,
                   32767).astype(np.int32)


def _rerun(fn, args, pool, stream):
    """Stand-in for the CUDA capture: the outputs are tensors of their own
    that every replay overwrites with fn's new results, as a graph's static
    outputs are."""
    outputs = tuple(t.clone() for t in fn(*args))

    def replay():
        for o, t in zip(outputs, fn(*args)):
            o.copy_(t)
    return outputs, replay


def _with_graphs(enc, capture=_rerun):
    """enc with the stand-in graphs on its CPU device(s), one StageGraphs a
    device as on the card. Each packed result is copied as soon as the
    stages return it, as the card's path copies it to the host before the
    next replay (TorchEncoder._dispatch_batch, mesh.sharded_analyze)."""
    graphs = {}

    def stage_graphs(device):
        if device not in graphs:
            graphs[device] = StageGraphs(device, capture=capture)
        return graphs[device]

    run_stages = enc._run_stages

    def run_and_copy(*args, **kw):
        packed, residual = run_stages(*args, **kw)
        return packed.clone(), residual

    enc._stage_graphs = stage_graphs
    enc._run_stages = run_and_copy
    return graphs


class _Guard(TorchDispatchMode):
    """Fails on an op a CUDA graph capture refuses."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        assert name not in _REFUSED, f"{name} inside a stage"
        if name in ("aten::index", "aten::index_put_", "aten::index_put"):
            for t in args[1]:
                assert t is None or t.dtype not in (torch.bool, torch.uint8), \
                    f"{name} with a boolean mask inside a stage"
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("matmul", [False, True], ids=["lag-fft", "matmul"])
@pytest.mark.parametrize("preset,n", [(0, SPB), (1, SPB), (7, 2048),
                                      (7, 2045)],
                         ids=["p0", "p1", "p7", "p7-mixed-units"])
def test_stages_hold_no_host_work(monkeypatch, preset, n, matmul):
    """A warm G1 and G2 call dispatch no op that a CUDA graph capture
    refuses, on both analysis routes (the card's default is the matrix-unit
    one) and at a tail length that not every unit count divides (the
    predict cascade's mixed-unit branch)."""
    monkeypatch.setattr(A, "_MATMUL_ROUTES_OVERRIDE", matmul)
    enc = TorchEncoder(device="cpu", tail_mode="device")
    enc.set_encode_parameter(_param(preset, spb=2048 if preset == 7 else SPB))
    chain = enc._stage_chain(n)
    if n == 2045:
        assert any(n % u for u in _chain_units(enc, chain))
    width = max(n, chain.num_analyze)
    sig = _track(2 * width, preset)[:, :2 * width].reshape(2, 2, width)
    blocks = torch.from_numpy(sig.transpose(1, 0, 2).astype(np.int16))
    out = chain.g1(blocks)  # warm: the windows
    chain.g2(out, out.params, 14)
    with _Guard():
        out = chain.g1(blocks)
        packed, residual = chain.g2(out, out.params, 14)
    eager = chain.analyze(blocks, 14)
    assert torch.equal(packed, eager["packed"])
    assert torch.equal(residual, eager["residual"])


def _chain_units(enc, chain):
    return [u for o in enc.preset.layer_num_params
            for u in A.candidate_units(o, chain.num_analyze)]


def _corpus():
    """Two tracks: 41 full blocks in six 8-row batches of one shape (the
    last one padded), and a tail."""
    tracks = [_track(20 * SPB, 1), _track(21 * SPB + 300, 2)]
    return [[t[0], t[1]] for t in tracks], [t.shape[1] for t in tracks]


def _jax_streams(preset, chans, lengths, batch_blocks, **flags):
    """The JAX package's TpuEncoder on the CPU: the reference bytes."""
    ref = TpuEncoder(batch_blocks=batch_blocks)
    ref.set_encode_parameter(
        _param(preset, cls=jax_params.EncodeParameter, **flags))
    return ref.encode_many(chans, lengths)


@pytest.fixture(scope="module")
def jax_corpus():
    chans, lengths = _corpus()
    return _jax_streams(1, chans, lengths, 8)


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]],
                         ids=["one", "two-shards"])
def test_replayed_stages_keep_residual_per_dispatch(monkeypatch, devices,
                                                    jax_corpus):
    """encode_many through the pipeline (three batches dispatched ahead)
    with the stages run as stand-in graphs gives the JAX TpuEncoder's
    bytes, and the eager encode's, under a 6-bit residual class, where
    every live block fetches its int32 rows at drain time, after later
    batches were dispatched (the width class changes no byte). A wrapper
    that does not keep `residual` per dispatch hands those rows the last
    replay's residual, and the bytes differ (a mutation run with
    TorchEncoder._run_stages returning the static residual fails here)."""
    monkeypatch.setattr(E, "_res_width_classes", lambda bps: (6,))
    chans, lengths = _corpus()
    kw = {"device": "cpu"} if devices is None else {"devices": devices}
    eager = TorchEncoder(batch_blocks=8, **kw)
    eager.set_encode_parameter(_param(1))
    want = eager.encode_many(chans, lengths)
    enc = TorchEncoder(batch_blocks=8, **kw)
    enc.set_encode_parameter(_param(1))
    graphs = _with_graphs(enc)
    got = enc.encode_many(chans, lengths)
    assert enc.overflow_rows > 0 and enc.overflow_rows == eager.overflow_rows
    assert got == jax_corpus
    assert got == want
    sg = graphs[torch.device("cpu")]
    shards = 1 if devices is None else 2
    # every batch has one shape and W 6: G1 and G2 run eagerly
    # CAPTURE_AT - 1 times, are captured at the next run and replayed at
    # every later one
    eager_runs = 2 * (G.CAPTURE_AT - 1)
    runs = 2 * shards * len(enc.batch_widths)
    assert runs > eager_runs + 2
    assert (sg.eager_runs, sg.captures, sg.replays) == (
        eager_runs, 2, runs - eager_runs)
    for chans_t, data in zip(chans, got):
        out = Decoder().decode_whole(data)
        assert all(np.array_equal(out[c], chans_t[c]) for c in range(2))


@pytest.mark.parametrize("flags", [{"num_afmethod_iterations": 1},
                                   {"enable_learning": True}],
                         ids=["a1", "l"])
def test_replayed_stages_around_the_eager_middle(monkeypatch, flags):
    """-a and -l: G1 run, the eager AF stages or the trainer on its
    outputs, their params copied into G2's static inputs, G2 run; over
    three batches of one shape (eager, captured, replayed: the capture
    taken at a key's second run) the bytes equal the JAX TpuEncoder's and
    the eager encode's."""
    monkeypatch.setattr(G, "CAPTURE_AT", 2)
    tracks = [_track(10 * SPB, 5)]
    chans, lengths = [[t[0], t[1]] for t in tracks], [10 * SPB]
    streams = []
    for graphed in (False, True):
        enc = TorchEncoder(batch_blocks=4, device="cpu")
        enc.set_encode_parameter(_param(0, **flags))
        if graphed:
            graphs = _with_graphs(enc)
        streams.append(enc.encode_many(chans, lengths))
    assert streams[1] == _jax_streams(0, chans, lengths, 4, **flags)
    assert streams[1] == streams[0]
    sg = graphs[torch.device("cpu")]
    assert ("g1", SPB, 4, 2, torch.int16) in sg.keys()
    assert sg.replays > 0


def test_one_capture_per_key():
    """A shape's first CAPTURE_AT - 1 batches run eagerly, the next
    captures, every later one replays: the graphs are one G1 a (block
    length, rows, channels, dtype) and one G2 a W on top. A second corpus
    of the same shapes captures only shapes the first ran fewer times,
    and a third captures nothing and runs nothing eagerly."""
    chans, lengths = _corpus()
    enc = TorchEncoder(batch_blocks=8, device="cpu")
    enc.set_encode_parameter(_param(1))
    graphs = _with_graphs(enc)
    first = enc.encode_many(chans, lengths)
    sg = graphs[torch.device("cpu")]
    widths = list(enc.batch_widths)
    g1 = [k for k in sg.keys() if k[0] == "g1"]
    assert g1 == [("g1", SPB, 8, 2, torch.int16)]
    k = G.CAPTURE_AT
    assert len(widths) >= k
    taken = {w for w in widths if widths.count(w) >= k}
    assert sg.eager_runs == (k - 1) + sum(min(widths.count(w), k - 1)
                                          for w in set(widths))
    assert sg.captures == sg.graphs == 1 + len(taken)
    keys = set(sg.keys())
    assert enc.encode_many(chans, lengths) == first
    fewer = {g1[0][1:] + (w,) for w in set(widths) - taken}
    assert {k[1:] for k in set(sg.keys()) - keys} <= fewer
    captures, eager_runs, replays = sg.captures, sg.eager_runs, sg.replays
    batches = len(enc.batch_widths) - len(widths)
    assert enc.encode_many(chans, lengths) == first
    assert (sg.captures, sg.eager_runs) == (captures, eager_runs)
    assert sg.replays == replays + 2 * batches


def test_sharded_analyze_through_replayed_stages(monkeypatch):
    """sharded_analyze over two shards of one device, the capture taken
    at a key's second run: the first shard runs the stages eagerly, the
    second captures and replays them, and each shard's packed result is
    kept before the next run; the result equals the JAX package's
    sharded_analyze."""
    monkeypatch.setattr(G, "CAPTURE_AT", 2)
    sig = _track(8 * SPB, 9)
    blocks = sig.reshape(2, 8, SPB).transpose(1, 0, 2).copy()
    enc = TorchEncoder(device="cpu")
    enc.set_encode_parameter(_param(1))
    graphs = _with_graphs(enc)
    got = mesh.sharded_analyze(enc, [torch.device("cpu")] * 2, blocks, SPB)
    ref = TpuEncoder(batch_blocks=8)
    ref.set_encode_parameter(_param(1, cls=jax_params.EncodeParameter))
    want = jax_mesh.sharded_analyze(
        ref, jax_mesh.make_block_mesh(jax.devices()[:2]), blocks,
        SPB)["packed"]
    assert np.array_equal(got.numpy(), np.asarray(want))
    sg = graphs[torch.device("cpu")]
    assert (sg.eager_runs, sg.captures) == (2, 2)  # one G1, one G2


def test_graphs_keep_what_they_read_alive(monkeypatch):
    """A CUDA graph reads, at every replay, the memory of each tensor its
    capture read from outside itself (windows, ridge terms), and holds no
    reference to it. Every such tensor of the encoder's graphs (captured
    at a key's second run) stays alive as long as the encoder, whatever
    else the process frees; a replay after a collection gives the same
    bytes."""
    monkeypatch.setattr(G, "CAPTURE_AT", 2)
    read = []

    def recording(fn, args, pool, stream):
        outside = _ReadsFromOutside(args)
        with outside:
            out = _rerun(fn, args, pool, stream)
        read.extend(outside.refs)
        return out

    chans, lengths = _corpus()
    enc = TorchEncoder(batch_blocks=8, device="cpu")
    enc.set_encode_parameter(_param(7, spb=2048))
    _with_graphs(enc, capture=recording)
    first = enc.encode_many(chans, lengths)
    assert len(read) >= 3  # the windows, a ridge vector
    gc.collect()
    torch.zeros(1 << 20)  # memory a freed window could be reused for
    assert all(ref() is not None for ref in read)
    assert enc.encode_many(chans, lengths) == first


class _ReadsFromOutside(TorchDispatchMode):
    """Weak references to the tensors that the ops under it read and that
    neither an earlier op under it nor `args` made."""

    def __init__(self, args):
        super().__init__()
        self._made = {id(t): t for t in pytree.tree_leaves(
            args) if isinstance(t, torch.Tensor)}
        self._seen = set()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        inputs = pytree.tree_leaves((args, kwargs or {}))
        for t in inputs:
            if (isinstance(t, torch.Tensor) and id(t) not in self._made
                    and id(t) not in self._seen):
                self._seen.add(id(t))
                self.refs.append(weakref.ref(t))
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._made[id(t)] = t
        return out


def test_stage_graphs_refuse_the_cpu():
    """A CPU device has no CUDA graphs: it runs the stages eagerly, and
    StageGraphs made for it raises."""
    with pytest.raises(ValueError, match="CUDA"):
        StageGraphs("cpu")
    enc = TorchEncoder(device="cpu")
    enc.set_encode_parameter(_param(0))
    assert enc._stage_graphs(torch.device("cpu")) is None
