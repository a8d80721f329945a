"""Block data parallelism over a list of torch devices.
Counterpart of linne_tpu/parallel/mesh.py.

Blocks are independent on encode, reconstruction rows are independent
through every layer's synthesis, and the byte-exact encoder's fit rows are
independent, so corpus throughput is pure data parallelism over the row
axis. torch has no SPMD mesh: a "mesh" here is an ordered list of devices.
A batch's leading (row) axis is split into contiguous shards, one per
entry; each shard runs the same stage chain on its device, and the results
are joined in row order on the host. The numeric path has no collective, so
the bytes equal the one-device run's. The training step's one reduction,
the reference's `pmean` of the shards' losses, is a mean over the shards
inside this process: no path crosses processes.

Entries may repeat: ["cpu", "cpu"] runs the split on the CPU, and
["cuda:0", "cuda:0"] on a machine with one card. The batched encoder
keeps one set of stage graphs per CUDA device of the list
(codec/graphs.py), entered under `on_device`; shards of one device share
it, and a shard whose row count differs has graphs of its own. Dispatch
stays on the calling thread, as in the reference; the callers enqueue
every shard's work before they read any result, so several cards compute
at once.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import analysis as A
from ..ops.training import _abs


def make_block_mesh(devices=None) -> List[torch.device]:
    """The device list: `devices` as torch.devices, or by default every
    CUDA card. Raises where a card is asked for and there is none; never
    falls back to the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError(
                "make_block_mesh: no CUDA card (torch.cuda.is_available() is "
                "false); pass devices=['cpu', ...] to split on the CPU")
        devices = [f"cuda:{i}" for i in range(count)]
    mesh = [torch.device(d) for d in devices]
    if not mesh:
        raise ValueError("make_block_mesh: empty device list")
    if any(d.type == "cuda" for d in mesh) and not torch.cuda.is_available():
        raise RuntimeError(
            "make_block_mesh: a CUDA device was asked for and "
            "torch.cuda.is_available() is false")
    return mesh


def resolve_devices(device=None, devices=None) -> List[torch.device]:
    """The device list of an entry point that takes either `device=` (one
    device, default "cuda") or `devices=` (a list), never both."""
    if device is not None and devices is not None:
        raise ValueError("device and devices are mutually exclusive")
    return make_block_mesh([device or "cuda"] if devices is None
                           else devices)


def shards(mesh: Sequence[torch.device], rows: int
           ) -> List[Tuple[torch.device, int, int]]:
    """(device, start, stop) of each non-empty contiguous shard of `rows`
    rows over the mesh, in row order; the first rows % len(mesh) shards
    hold one row more."""
    q, r = divmod(rows, len(mesh))
    out = []
    start = 0
    for i, d in enumerate(mesh):
        stop = start + q + (i < r)
        if stop > start:
            out.append((d, start, stop))
        start = stop
    return out


def pad_rows(arr: np.ndarray, count: int) -> np.ndarray:
    """`arr` with zero rows appended up to a multiple of `count`."""
    pad = (-arr.shape[0]) % count
    if not pad:
        return arr
    return np.concatenate(
        [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)


def on_device(device: torch.device):
    """Context that makes a CUDA device current while a shard's work is
    enqueued (nothing for the CPU), so tensors a stage creates without an
    explicit device land beside the shard's."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_blocks(mesh: Sequence[torch.device], blocks) -> List[torch.Tensor]:
    """Split a [B, ...] batch (numpy array or tensor) into its contiguous
    row shards, each on its device."""
    if isinstance(blocks, np.ndarray):
        blocks = torch.from_numpy(np.ascontiguousarray(blocks))
    return [blocks[a:b].to(d) for d, a, b in shards(mesh, blocks.shape[0])]


def sharded_analyze(encoder, mesh: Sequence[torch.device], blocks,
                    n: int) -> torch.Tensor:
    """Run the encoder's batched stage chain data-parallel over the mesh:
    each row shard on its device (a CUDA device replays the encoder's
    graphs of that device, codec/graphs.py), the packed results (at the
    widest residual class) joined in row order on the host. Equal, bit
    for bit, to the unsharded call's "packed"."""
    outs = []
    for shard in shard_blocks(mesh, blocks):
        with on_device(shard.device):
            packed, _residual = encoder._run_stages(shard, n, shard.device)
            # on a card, the next shard of the device may replay the same
            # graph and overwrite its static output
            outs.append(packed.clone() if packed.is_cuda else packed)
    return torch.cat([o.cpu() for o in outs])


def training_step_fn(layer_orders: Sequence[int], n: int, dtype):
    """One shard's training step on the network's L1 loss: the multi-device
    form of the reference's per-block momentum trainer
    (linne_network.c:805-873). local_step(params, signal, momentum) ->
    (new params, new momentum, the shard's loss); params are per-layer
    [B, C, order], signal [B, C, n] of `dtype`."""

    def loss_fn(ps, signal):
        x = signal
        for li in range(len(layer_orders)):
            # single-unit forward: x[t] += sum_j p[j] x[t-order+j]
            x = A.unit_forward(x, ps[li][..., None, :], 1)
        # L1 loss, mean over the local shard
        return torch.sum(_abs(x)) / x.numel()

    def local_step(params, signal, momentum):
        if signal.shape[-1] != n or signal.dtype != dtype:
            raise ValueError(
                f"signal {tuple(signal.shape)} {signal.dtype}: expected "
                f"[..., {n}] {dtype}")
        leaves = [p.detach().requires_grad_() for p in params]
        with torch.enable_grad():
            loss = loss_fn(leaves, signal)
            grads = torch.autograd.grad(loss, leaves)
        new_momentum = tuple(0.8 * m + 0.1 * g
                             for m, g in zip(momentum, grads))
        new_params = tuple(p.detach() - m
                           for p, m in zip(params, new_momentum))
        return new_params, new_momentum, loss.detach()

    return local_step


def make_sharded_train_step(mesh: Sequence[torch.device],
                            layer_orders: Sequence[int], n: int,
                            dtype=torch.float32):
    """step(params, signal, momentum) -> (params, momentum, loss) over the
    whole batch: the rows split over the mesh, each shard steps on its
    device, params and momentum are joined in row order on the signal's
    device, and the loss is the mean of the shards' losses (the
    reference's pmean). The row count must divide by the mesh size, as the
    reference's shard_map requires."""
    local = training_step_fn(layer_orders, n, dtype)

    def step(params, signal, momentum):
        rows = signal.shape[0]
        if rows % len(mesh):
            raise ValueError(
                f"{rows} rows do not divide over {len(mesh)} devices")
        parts = []
        for d, a, b in shards(mesh, rows):
            with on_device(d):
                parts.append(local(tuple(p[a:b].to(d) for p in params),
                                   signal[a:b].to(d),
                                   tuple(m[a:b].to(d) for m in momentum)))
        home = signal.device
        new_params = tuple(
            torch.cat([part[0][li].to(home) for part in parts])
            for li in range(len(params)))
        new_momentum = tuple(
            torch.cat([part[1][li].to(home) for part in parts])
            for li in range(len(momentum)))
        loss = torch.stack([part[2].to(home) for part in parts]).mean()
        return new_params, new_momentum, loss

    return step
