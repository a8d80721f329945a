"""W-bit plane packing for slim device<->host transfers.
Counterpart of linne_tpu/ops/bitpack.py.

Sample planes leave the device at a static W bits per sample in two's
complement, packed into int32 words: the encoder's residual plane behind
its side columns (codec/encoder.py) and the decoder's reconstruction plane
(codec/torch_decoder.py). The host-side inverse is native.unpack_bits.

The reference shifts uint32 lanes. torch has no uint32 arithmetic on every
device, so the fields are placed in int64: no field crosses bit 63, fields
never overlap, so each word is the plain sum of its fields' parts, and
the finished words wrap to int32 at the end. Plain torch, a handful of ops
per call; the same code runs on the CPU and on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pack_geometry(width: int):
    """(samples per group, words per group) for a W-bit plane: groups of g
    samples pack exactly into g*W/32 int32 words."""
    g = 32 // math.gcd(width, 32)
    return g, width * g // 32


def pack_plane_words(x: torch.Tensor, width: int) -> torch.Tensor:
    """[..., n] int32 -> [..., ceil(n/g)*wpg] int32 words carrying the low
    `width` bits of each sample (two's complement), little-endian bit order
    within and across words."""
    g, wpg = pack_geometry(width)
    pad = (-x.shape[-1]) % g
    if pad:
        x = F.pad(x, (0, pad))
    lead = tuple(x.shape[:-1])
    bit = torch.arange(g, device=x.device) * width
    word, off = bit // 32, bit % 32
    # sample j of a group holds bits [off, off + width) of word `word`,
    # spilling its high part into the next word
    field = (x.to(torch.int64) & ((1 << width) - 1)).reshape(
        lead + (-1, g)) << off
    words = torch.zeros(lead + (field.shape[-2], wpg + 1), dtype=torch.int64,
                        device=x.device)
    words.index_add_(-1, word, field & 0xFFFFFFFF)
    words.index_add_(-1, word + 1, field >> 32)
    words = words[..., :wpg]
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).reshape(lead + (-1,))
