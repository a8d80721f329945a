"""Move nested structures of arrays between numpy and torch.

The codec has no trained weights: it fits its LPC network per block inside
the encoder and ships the coefficients in the bitstream. What crosses
between the JAX reference and this package is data — stage outputs
(a JAX result after `np.asarray`) fed to the next stage of the port.
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(tree, device="cpu"):
    """Map every numpy array (or numpy scalar) in nested tuples, lists and
    dicts to a tensor of the same dtype on `device`; other leaves pass
    through."""
    if isinstance(tree, (np.ndarray, np.generic)):
        # a copy: arrays viewed from JAX results are read-only
        return torch.tensor(np.asarray(tree), device=device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return tree


def to_numpy(tree):
    """Map every tensor in nested tuples, lists and dicts to a numpy array
    of the same dtype; other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree
