"""The batched encoder's stages as CUDA graphs: captured once per shape,
replayed once per batch. Counterpart of the per-shape executables that
`jax.jit` caches for each stage in linne_tpu/codec/encoder.py.

Eagerly, Python issues every torch op of every batch (about 1,300 for a
64-block preset-7 batch), and the card waits on that dispatch. Here a
stage chain is captured once per shape and each later batch of that shape
replays it: one launch from Python per graph.

One StageGraphs serves one device. `run(key, fn, args)` runs `fn(*args)`
for the shape `key`:
- at the first CAPTURE_AT - 1 batches of a key, eagerly on the graphs'
  own stream. The first of those runs is also the warm-up a capture
  needs: it builds the kernels' libraries, cuBLAS's workspace for that
  stream and the cuFFT plans, none of which may be made during a
  capture. A key seen fewer times (a short file, a track's last partial
  batch, a tail length) costs what it costs eagerly;
- at its CAPTURE_AT-th batch, the graph is captured (torch.cuda.CUDAGraph's
  capture_begin/capture_end on the graphs' stream, into their pool) and
  replayed;
- from then on, replayed.
`args` are pytrees of tensors: the graph's static inputs, which the
caller refills before each run (`buffer` keeps such tensors), or the
outputs of another graph. `fn` returns a pytree of tensors; a replay
returns the graph's static outputs in that structure.

Streams. The eager first run and the capture go to the graphs' stream,
which first waits for the device's current stream; the current stream
waits for the eager run's end. Replays run on the current stream. A
tensor the eager run allocates and the current stream reads later is
only reused by work queued after that read, because every use of the
graphs' stream begins by waiting for the current stream.

Memory. The graphs of one StageGraphs capture into one memory pool. A
capture may place its tensors in memory that an earlier graph of the pool
uses as scratch, never in a live tensor, so a replay may overwrite the
outputs of the graphs captured after it and nothing else. Sharing is safe
under one rule, which the encoder keeps: every read of a graph's outputs
is enqueued, on the device's current stream, before the next replay of
another graph of the pool. The encoder enqueues a batch's G1 replay, its
eager middle (`-a`, `-l`), its G2 replay, the copy of `packed` to the
host and the device-side copy it keeps of `residual` before the next
batch's replays. A graph's own outputs also outlive only one replay of
it: a caller that needs an output later (the encoder's `residual`, read
at drain time after later batches were dispatched) copies it. A graph
also reads, at every replay, the tensors that `fn` read from outside it
(windows, ridge terms): their owner keeps them as long as the graphs
(the encoder's stage chain does). When the graphs are freed, their
pool's memory stays with the allocator until its cache is emptied; a
capture, which cannot return memory to the card, empties it first when
less than a quarter of the card is free.

Launch accounting. The kernel wrappers of ops/analysis_scans.py count
launches when they run in Python. An eager run's counts are launches. A
capture's are recordings: they are taken back out of
`analysis_scans.KERNEL_LAUNCHES`, kept as the kernels the graph holds,
and every replay adds them. So the counts read as the eager path's: once
a batch for a kernel the chain launches once.

There is no eager fallback: a capture or a replay that fails raises.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, NamedTuple, Sequence

import torch
from torch.utils import _pytree as pytree

from ..ops import analysis_scans

# The run of a key at which its graph is captured. A capture costs more
# than an eager run of the same batch, and each replay then saves the
# host dispatch that exceeds the batch's device time. Capturing after
# CAPTURE_AT - 1 eager runs, with CAPTURE_AT - 1 = cost / saving, keeps a
# key that stops right after its capture from losing more than twice
# what the best choice in hindsight would have cost, and a key that runs
# on from losing more than one capture. chip_smoke.py's phase 17 measures
# both on cold encoders (graph_crossover_phase): 1 + cost / saving read
# 4.79 at 64 rows and 3.22 at 128 on an H100; this is the larger, rounded
# up.
CAPTURE_AT = 5


def _capture_cuda(fn: Callable, args: Sequence, pool, stream):
    """fn(*args) captured as a CUDA graph on `stream` into `pool`: (its
    outputs, the graph's replay)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            outputs = fn(*args)
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the broken capture's own error; fn's is the cause
            raise
        graph.capture_end()
    return outputs, graph.replay


class _Graph(NamedTuple):
    args: tuple          # the static input tensors it was captured on
    outputs: object      # its static outputs, in fn's structure
    replay: Callable
    kernels: dict        # kernel name -> launches a replay


class StageGraphs:
    """The stage graphs of one CUDA device, keyed by shape.

    `capture` replaces the CUDA capture (fn, args, pool, stream) ->
    (outputs, replay), fn returning a tuple of tensors; it is how a CPU
    test drives the buffer logic. A CPU device without it raises: the CPU
    runs the stages eagerly."""

    def __init__(self, device, capture: Callable | None = None):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        if capture is None:
            if not cuda:
                raise ValueError(
                    f"StageGraphs on {self.device}: CUDA graphs need a CUDA "
                    "device (the CPU runs the stages eagerly)")
            capture = _capture_cuda
        self._capture = capture
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._runs: Dict[Hashable, int] = {}  # eager runs of each key
        self._graphs: Dict[Hashable, _Graph] = {}
        self._buffers: Dict[Hashable, torch.Tensor] = {}
        self.eager_runs = 0
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0  # host seconds, summed over the captures

    def buffer(self, key: Hashable, shape, dtype) -> torch.Tensor:
        """A static input tensor on the device, made at the first call of
        `key` and the same tensor at every later one."""
        t = self._buffers.get(key)
        if t is None:
            t = torch.empty(tuple(shape), dtype=dtype, device=self.device)
            self._buffers[key] = t
        elif t.shape != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"buffer {key}: {tuple(t.shape)} {t.dtype} "
                             f"made, {tuple(shape)} {dtype} asked for")
        return t

    def run(self, key: Hashable, fn: Callable, args: Sequence):
        """fn(*args) for the shape `key`: eagerly at its first
        CAPTURE_AT - 1 calls, then as a graph captured at the next and
        replayed (see the module docstring)."""
        args = tuple(args)
        graph = self._graphs.get(key)
        if graph is None:
            runs = self._runs.get(key, 0)
            if runs + 1 < CAPTURE_AT:
                self._runs[key] = runs + 1
                self.eager_runs += 1
                return self._on_stream(fn, args)
            graph = self._graphs[key] = self._build(fn, args)
        elif any(a is not b for a, b in
                 zip(pytree.tree_leaves(args), graph.args, strict=True)):
            raise ValueError(f"graph {key} replayed on other tensors than "
                             "it was captured on")
        graph.replay()
        self.replays += 1
        counts = analysis_scans.KERNEL_LAUNCHES
        for name, n in graph.kernels.items():
            counts[name] += n
        return graph.outputs

    def _on_stream(self, fn: Callable, args: tuple):
        """fn(*args) eagerly on the graphs' stream, ordered after the
        current stream's work and before its later work."""
        if self._stream is None:
            return fn(*args)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            out = fn(*args)
        current.wait_stream(self._stream)
        return out

    def _build(self, fn: Callable, args: tuple) -> _Graph:
        spec = []

        def flat(*a):
            leaves, s = pytree.tree_flatten(fn(*a))
            spec.append(s)
            return tuple(leaves)

        counts = analysis_scans.KERNEL_LAUNCHES
        before = dict(counts)
        t0 = time.perf_counter()
        if self._stream is not None:
            # no memory goes back to the card while a stream captures, so
            # a capture cannot take the blocks the allocator holds idle
            # (the pools of graphs that were freed among them) when the
            # card runs short; hand them back first when less than a
            # quarter of the card is free
            free, total = torch.cuda.mem_get_info(self.device)
            if free < total // 4:
                torch.cuda.empty_cache()
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        leaves, replay = self._capture(flat, args, self._pool, self._stream)
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        kernels = {k: counts[k] - before[k] for k in counts
                   if counts[k] != before[k]}
        counts.update(before)  # recorded, not launched
        return _Graph(tuple(pytree.tree_leaves(args)),
                      pytree.tree_unflatten(list(leaves), spec[0]), replay,
                      kernels)

    @property
    def graphs(self) -> int:
        return len(self._graphs)

    def keys(self):
        return list(self._graphs)

    def pool_bytes(self):
        """Bytes of the device memory segments the graphs' pool holds
        (torch.cuda.memory_snapshot), or None on the CPU or where the
        snapshot does not name pools."""
        if self._pool is None:
            return None
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pool = seg.get("segment_pool_id")
            if pool is None:
                continue
            named = True
            if tuple(pool) == tuple(self._pool):
                total += seg["total_size"]
        return total if named else None
