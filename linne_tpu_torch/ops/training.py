"""Batched gradient training of the per-block predictor (`-l`).
Counterpart of linne_tpu/ops/training.py.

The reference fine-tunes every block's layer cascade with full-batch
momentum gradient descent on the L1 residual loss, with per-block early
stopping (reference: linne_network.c:805-873, hyperparameters
linne_internal.h:29-33). Here the whole [blocks, channels] population
trains in one loop that carries (params, momentum, prev_loss, active):
converged rows freeze through masked updates, as the reference's
independent per-block stopping rule. The loop is Python, one host sync an
iteration to test whether any row is still active. A caller may pass an
int64 tensor of the rows' shape, to which each iteration adds the rows
still active on the device: each row's stop iteration, read once after
the loop.

Each row's unit count is frozen during training, so the parameters are
gathered once into a canonical [u_max, order] per-segment layout
(_dense_layouts) and the cascade runs one unit_forward per layer.

Gradients come from autograd of the forward cascade. The L1 term's
derivative at exactly zero is +1, as in JAX (`_abs`), where torch's own
`abs` backward gives 0: residuals are exactly zero wherever a block has
digital silence and on the all-zero padding rows of a partial batch.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .analysis import unit_forward


class _Abs(torch.autograd.Function):
    """|x| whose backward is g * (+1 where x >= 0, else -1): JAX's rule,
    which counts +0.0 and -0.0 as positive."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _abs(x: torch.Tensor) -> torch.Tensor:
    return _Abs.apply(x)


def _forward_loss(params_list, log2u_list, sig, orders, unit_choices):
    """L1 loss of the full cascade with per-(block, channel) unit counts
    selected among the static candidates."""
    x = sig
    for li, order in enumerate(orders):
        choices = unit_choices[li]
        variants = []
        for u in choices:
            p = params_list[li].reshape(
                tuple(params_list[li].shape[:-1]) + (u, order // u))
            variants.append(unit_forward(x, p, u))
        stack = torch.stack(variants, dim=0)
        lut = {u: i for i, u in enumerate(choices)}
        table = torch.tensor([lut.get(1 << l, 0) for l in range(8)],
                             dtype=torch.long, device=sig.device)
        idx = table[log2u_list[li].long()][None, ..., None]
        x = torch.gather(stack, 0, idx.expand((1,) + tuple(x.shape)))[0]
    n = x.shape[-1]
    return torch.sum(_abs(x), dim=-1) / n  # per-(B, C) loss


def _dense_layouts(orders: Sequence[int], unit_choices, log2u_list):
    """Per-layer gather spec embedding each row's (u, order/u)-reshaped
    parameters into one canonical [u_max, order] per-segment filter layout
    (u_max = finest candidate split). Segment s of the finest split belongs
    to real unit s*u//u_max; the row's order/u taps sit tail-aligned on the
    j axis (j = order - age, reference reversed layout), invalid ages
    masked. Returns [(src int32 [..., u_max, order], valid bool, u_max)]."""
    out = []
    for order, choices, log2u in zip(orders, unit_choices, log2u_list):
        dev = log2u.device
        u_max = max(choices)
        log2u = log2u.to(torch.int32)
        k = order - torch.arange(order, dtype=torch.int32, device=dev)
        s = torch.arange(u_max, dtype=torch.int32, device=dev)
        u_r = (1 << log2u)[..., None, None]
        npu_r = (order >> log2u)[..., None, None]
        unit = (s[None, None, :, None] * u_r) // u_max
        valid = k[None, None, None, :] <= npu_r
        src = unit * npu_r + (npu_r - k[None, None, None, :])
        out.append((torch.where(valid, src, 0).to(torch.int32), valid,
                    u_max))
    return out


def _dense_forward_loss(params_list, layouts, sig):
    """L1 loss of the cascade in the canonical dense layout."""
    x = sig
    for p, (src, valid, u_max) in zip(params_list, layouts):
        flat = p[..., None, :].expand(src.shape)
        coefs = torch.where(valid, torch.gather(flat, -1, src.long()), 0.0)
        x = unit_forward(x, coefs, u_max)
    n = x.shape[-1]
    return torch.sum(_abs(x), dim=-1) / n  # per-(B, C) loss


def make_train_fn(orders: Sequence[int], unit_choices,
                  max_iters: int, learning_rate: float, loss_eps: float,
                  alpha: float = 0.8):
    """Returns train(sig, params_list, log2u_list, stops=None) ->
    (trained params_list, iterations run); `stops` (int64, sig's shape
    without the samples) gains each row's active iterations."""

    def train(sig, params_list, log2u_list, stops=None):
        layouts = _dense_layouts(orders, unit_choices, log2u_list)
        params = [p.detach() for p in params_list]
        momentum = [torch.zeros_like(p) for p in params]
        prev = torch.full(tuple(sig.shape[:-1]), float("inf"),
                          dtype=sig.dtype, device=sig.device)
        active = torch.ones(tuple(sig.shape[:-1]), dtype=torch.bool,
                            device=sig.device)
        it = 0
        while it < max_iters and bool(torch.any(active)):
            if stops is not None:
                stops += active
            leaves = [p.requires_grad_() for p in params]
            with torch.enable_grad():
                per_loss = _dense_forward_loss(leaves, layouts, sig)
                grads = torch.autograd.grad(torch.sum(per_loss), leaves)
            per_loss = per_loss.detach()
            mask = active[..., None].to(sig.dtype)
            momentum = [torch.where(active[..., None],
                                    alpha * m + learning_rate * g, m)
                        for m, g in zip(momentum, grads)]
            params = [p.detach() - mask * m
                      for p, m in zip(params, momentum)]
            active = active & (torch.abs(per_loss - prev) >= loss_eps)
            prev = per_loss
            it += 1
        return params, it

    return train
