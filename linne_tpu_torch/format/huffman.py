"""Static Huffman coding of zigzagged LPC coefficients.

Wire-compatible with the reference static-Huffman layer
(reference: libs/static_huffman/src/static_huffman.c:28-165). The tree-build
procedure — repeated extraction of the two lowest-count nodes by a linear scan
with first-index tie-breaking, zero counts bumped to one — fully determines
the code table, so it is reproduced exactly here; the decoder, however, is
re-architected as a flat lookup table instead of a bit-by-bit tree walk.

All presets share a single coefficient frequency table, so the codebook is
built once and cached.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

from .bitstream import BitReader, BitWriter

MAX_NUM_SYMBOLS = 256
_SENTINEL = 2 * MAX_NUM_SYMBOLS
_UINT32_MAX = 0xFFFFFFFF


class HuffmanCodebook:
    """Code table + decode LUT for one symbol-frequency table."""

    def __init__(self, symbol_counts: Sequence[int]):
        num_symbols = len(symbol_counts)
        assert 0 < num_symbols <= MAX_NUM_SYMBOLS
        self.num_symbols = num_symbols
        # children[i] = (node0, node1) for internal nodes i >= num_symbols
        children, root = _build_tree(symbol_counts)
        self.children = children
        self.root = root
        codes: List[Tuple[int, int]] = [(0, 0)] * num_symbols
        # Iterative DFS replicating the recursive left-then-right assignment
        # (code<<1|0 for node_0, code<<1|1 for node_1).
        stack = [(root, 0, 0)]
        while stack:
            node, code, nbits = stack.pop()
            if node < num_symbols:
                codes[node] = (code, nbits)
                continue
            n0, n1 = children[node]
            # push right first so left is processed first (order irrelevant
            # for correctness; codes are per-leaf)
            stack.append((n1, (code << 1) | 1, nbits + 1))
            stack.append((n0, (code << 1) | 0, nbits + 1))
        self.codes = codes
        self.max_code_len = max(nbits for _, nbits in codes)
        self._build_decode_lut()
        # flat arrays for the native packer/unpacker
        self.codes_array = np.array([c for c, _ in codes], dtype=np.uint32)
        self.lens_array = np.array([l for _, l in codes], dtype=np.uint8)
        nnodes = self.root + 1
        self.node0_array = np.zeros(nnodes, dtype=np.int16)
        self.node1_array = np.zeros(nnodes, dtype=np.int16)
        for node, (n0, n1) in children.items():
            self.node0_array[node] = n0
            self.node1_array[node] = n1

    def _build_decode_lut(self) -> None:
        """Flat decode table: index by the next `max_code_len` bits, get
        (symbol, code length). Memory is 2^maxlen * 2 int16 entries; for the
        fixed coefficient table maxlen is small (~20 bits would be too big, so
        fall back to a two-level scheme if needed)."""
        maxlen = self.max_code_len
        if maxlen <= 16:
            size = 1 << maxlen
            sym = np.zeros(size, dtype=np.int16)
            length = np.zeros(size, dtype=np.int8)
            for s, (code, nbits) in enumerate(self.codes):
                shift = maxlen - nbits
                base = code << shift
                sym[base : base + (1 << shift)] = s
                length[base : base + (1 << shift)] = nbits
            self.lut_bits = maxlen
            self.lut_sym = sym.tolist()  # plain lists: faster scalar lookup
            self.lut_len = length.tolist()
        else:
            self.lut_bits = 0
            self.lut_sym = None
            self.lut_len = None

    def put(self, writer: BitWriter, symbol: int) -> None:
        code, nbits = self.codes[symbol]
        writer.put(code, nbits)

    def get(self, reader: BitReader) -> int:
        """Decode one symbol: peek max_code_len bits, single LUT lookup,
        consume the code length (tree walk only if the table overflows)."""
        if self.lut_sym is None:
            return self._get_treewalk(reader)
        idx = reader.peek(self.lut_bits)
        reader.skip(self.lut_len[idx])
        return self.lut_sym[idx]

    def _get_treewalk(self, reader: BitReader) -> int:
        node = self.root
        children = self.children
        n = self.num_symbols
        while node >= n:
            node = children[node][reader.get(1)]
        return node


def _build_tree(symbol_counts: Sequence[int]):
    """Two-minimum linear-scan Huffman tree build with first-index
    tie-breaking and zero counts bumped to one, matching the reference
    construction bit-for-bit."""
    num_symbols = len(symbol_counts)
    counts = [0] * (2 * MAX_NUM_SYMBOLS + 1)
    for i, c in enumerate(symbol_counts):
        counts[i] = c if c > 0 else 1
    counts[_SENTINEL] = _UINT32_MAX
    children = {}
    free_node = num_symbols
    while True:
        min1 = min2 = _SENTINEL
        for node in range(free_node):
            c = counts[node]
            if c > 0:
                if c < counts[min1]:
                    min2 = min1
                    min1 = node
                elif c < counts[min2]:
                    min2 = node
        if min2 == _SENTINEL:
            break
        counts[free_node] = counts[min1] + counts[min2]
        counts[min1] = counts[min2] = 0
        children[free_node] = (min1, min2)
        free_node += 1
    root = free_node - 1
    return children, root


@lru_cache(maxsize=8)
def _codebook_cached(symbol_counts: Tuple[int, ...]) -> HuffmanCodebook:
    return HuffmanCodebook(symbol_counts)


def get_codebook(symbol_counts: Sequence[int]) -> HuffmanCodebook:
    return _codebook_cached(tuple(symbol_counts))
