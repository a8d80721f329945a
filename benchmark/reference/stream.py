"""Plain NumPy reader of `.lnn` streams: the benchmark's own, independent of
the program.

The wire format (header, block frames with CRC-16, compress payloads of
pre-emphasis state, per-layer unit counts, shifts and Huffman-coded
coefficients, then partitioned Rice residual planes; raw and silent
blocks) is read here from its definition, so that the benchmark can judge
the program's streams by what they say. Blocks of one length are read in
lockstep: every step reads one field or one symbol of every block at
once, with NumPy, so a corpus of thousands of blocks reads in seconds.
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Sequence

import numpy as np

MAGIC = b"IBRA"
FORMAT_VERSION = 1
CODEC_VERSION = 2
HEADER_SIZE = 30
BLOCK_HEADER_SIZE = 11
SYNC = 0xFFFF
BLOCK_COMPRESS, BLOCK_SILENT, BLOCK_RAW = 0, 1, 2
PREEMPH_SHIFT = 5
NUM_PREEMPH = 2
LOG2_UNITS_BITS = 3
RSHIFT_BITS = 4
PORDER_BITS = 10
RICE_PARAM_BITS = 5
MASK32 = 0xFFFFFFFF

# The static-Huffman frequency table of the zigzagged 8-bit coefficients,
# fixed by the format (every preset shares it).
COEF_FREQ_TABLE = (
    2944693, 2417040, 2500224, 2220717, 2361506, 2005548, 2161319, 1804396,
    1961813, 1628891, 1774159, 1471673, 1604885, 1335449, 1451476, 1218111,
    1316402, 1112581, 1200154, 1019661, 1094294, 935533, 1000598, 861453,
    914647, 793863, 837607, 733372, 769686, 679634, 709504, 630828,
    653277, 583990, 602876, 545068, 556612, 507071, 516014, 473301,
    478009, 441389, 442848, 415057, 412045, 389010, 384623, 364872,
    359578, 343600, 335976, 322541, 314173, 304513, 293388, 286871,
    277191, 271905, 260699, 256892, 245269, 243815, 231142, 231894,
    217938, 220197, 205798, 209146, 196061, 199652, 185811, 189659,
    176121, 181265, 168122, 173827, 159699, 167156, 150968, 158868,
    144276, 152666, 137117, 146329, 130245, 141026, 124044, 134984,
    118946, 130389, 113141, 125287, 108826, 120399, 102664, 116857,
    98953, 112210, 93718, 109059, 89757, 106036, 86363, 102597,
    82554, 99558, 78306, 96473, 76105, 92575, 72428, 89227,
    68911, 85952, 66258, 82764, 63571, 80241, 61196, 78050,
    58502, 75544, 56329, 73454, 53557, 71750, 51667, 81769,
    52853, 90325, 53934, 86990, 51338, 83565, 48756, 80882,
    47304, 78156, 44823, 75050, 43129, 72304, 41339, 70163,
    39767, 67853, 37538, 65134, 35572, 62994, 34367, 61059,
    32981, 58664, 31690, 56196, 30505, 54354, 29091, 52803,
    27750, 50577, 26523, 49428, 25414, 47359, 24109, 46224,
    23419, 44925, 22167, 43578, 21336, 42201, 20551, 41434,
    19640, 39842, 18815, 38775, 18200, 37804, 17159, 36516,
    16591, 35217, 16053, 34221, 14962, 33101, 14533, 32077,
    13842, 31550, 13427, 30277, 12962, 29616, 12296, 29090,
    11678, 27922, 11467, 27212, 10733, 26329, 10270, 25938,
    9930, 24828, 9336, 24672, 9085, 23868, 8616, 23456,
    8430, 22633, 7892, 21759, 7594, 21723, 7430, 20729,
    6988, 20475, 6673, 20100, 6489, 19480, 6100, 18993,
    5912, 18480, 5599, 17993, 5292, 17267, 5100, 17013,
    4919, 16502, 4721, 16304, 4471, 16040, 4313, 16120,
    4090, 17146, 3921, 28239, 3817, 49638, 5544, 7587,
)


class StreamError(ValueError):
    """A stream that does not follow the format."""


# -- Huffman code of the coefficients ------------------------------------

def huffman_codes(counts: Sequence[int]):
    """(code, length) of every symbol: the format's tree, built by repeated
    extraction of the two smallest counts by a linear scan with
    first-index ties, zero counts taken as one; a node's first child gets
    bit 0."""
    nsym = len(counts)
    sentinel = 2 * 256
    c = [0] * (2 * 256 + 1)
    for i, v in enumerate(counts):
        c[i] = v if v > 0 else 1
    c[sentinel] = MASK32
    children = {}
    free = nsym
    while True:
        m1 = m2 = sentinel
        for node in range(free):
            v = c[node]
            if v > 0:
                if v < c[m1]:
                    m2, m1 = m1, node
                elif v < c[m2]:
                    m2 = node
        if m2 == sentinel:
            break
        c[free] = c[m1] + c[m2]
        c[m1] = c[m2] = 0
        children[free] = (m1, m2)
        free += 1
    codes = [(0, 0)] * nsym
    stack = [(free - 1, 0, 0)]
    while stack:
        node, code, nbits = stack.pop()
        if node < nsym:
            codes[node] = (code, nbits)
            continue
        n0, n1 = children[node]
        stack.append((n1, (code << 1) | 1, nbits + 1))
        stack.append((n0, code << 1, nbits + 1))
    return codes


class HuffmanTable(NamedTuple):
    bits: int            # the peek width
    symbol: np.ndarray   # [2^bits] symbol of each peeked pattern
    length: np.ndarray   # [2^bits] its code length


def huffman_table(counts: Sequence[int] = COEF_FREQ_TABLE) -> HuffmanTable:
    codes = huffman_codes(counts)
    bits = max(n for _, n in codes)
    sym = np.zeros(1 << bits, np.int64)
    length = np.zeros(1 << bits, np.int64)
    for s, (code, n) in enumerate(codes):
        lo = code << (bits - n)
        sym[lo : lo + (1 << (bits - n))] = s
        length[lo : lo + (1 << (bits - n))] = n
    return HuffmanTable(bits, sym, length)


# -- CRC-16/IBM ------------------------------------------------------------

def _crc_table() -> np.ndarray:
    t = np.zeros(256, np.int64)
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ 0xA001 if c & 1 else c >> 1
        t[b] = c
    return t


_CRC_TABLE = _crc_table()


def _crc_table2() -> np.ndarray:
    """CRC register after two zero bytes from each 16-bit register value:
    with a 16-bit register, two data bytes b0, b1 take register r to
    table2[r ^ b0 ^ (b1 << 8)]."""
    r = np.arange(1 << 16, dtype=np.int64)
    for _ in range(2):
        r = (r >> 8) ^ _CRC_TABLE[r & 0xFF]
    return r


_CRC_TABLE2 = _crc_table2()


def crc16_many(spans: Sequence[bytes]) -> np.ndarray:
    """CRC-16/IBM (init 0, no final xor) of many byte strings at once,
    two bytes a step over all of them. Leading zero bytes leave a
    zero-initialised register at zero, so the strings are right-aligned
    behind zero bytes to a common even length."""
    if not spans:
        return np.zeros(0, np.int64)
    width = max(len(x) for x in spans)
    width += width & 1
    m = np.zeros((len(spans), width), np.uint8)
    for i, x in enumerate(spans):
        if x:
            m[i, width - len(x):] = np.frombuffer(x, np.uint8)
    pairs = m.view("<u2").astype(np.int64)  # b0 | b1 << 8
    crc = np.zeros(len(spans), np.int64)
    for j in range(pairs.shape[1]):
        crc = _CRC_TABLE2[crc ^ pairs[:, j]]
    return crc


# -- stream and block frames -----------------------------------------------

class Header(NamedTuple):
    num_channels: int
    num_samples: int
    sampling_rate: int
    bits_per_sample: int
    num_samples_per_block: int
    preset: int
    ch_process_method: int


def read_header(data: bytes) -> Header:
    if len(data) < HEADER_SIZE:
        raise StreamError("stream shorter than its header")
    (magic, fmt, codec, nch, ns, rate, bps, spb, preset,
     chproc) = struct.unpack_from(">4sIIHIIHIBB", data)
    if magic != MAGIC or fmt != FORMAT_VERSION or codec != CODEC_VERSION:
        raise StreamError("bad magic or version")
    return Header(nch, ns, rate, bps, spb, preset, chproc)


class Frame(NamedTuple):
    block_type: int
    num_samples: int
    crc: int
    body: bytes      # the bytes the CRC covers: type, length, payload
    payload: bytes


def read_frames(data: bytes, header: Header) -> List[Frame]:
    """The block frames of a stream, which must cover its samples exactly
    and end where the stream ends."""
    frames = []
    off = HEADER_SIZE
    done = 0
    while done < header.num_samples:
        if off + BLOCK_HEADER_SIZE > len(data):
            raise StreamError("stream ends inside a block header")
        sync, size, crc, btype, n = struct.unpack_from(">HIHBH", data, off)
        if sync != SYNC or btype not in (0, 1, 2) or n == 0:
            raise StreamError(f"bad block header at byte {off}")
        end = off + 6 + size
        if size < 5 or end > len(data):
            raise StreamError("stream ends inside a block")
        frames.append(Frame(btype, n, crc, data[off + 8 : end],
                            data[off + BLOCK_HEADER_SIZE : end]))
        done += n
        off = end
    if done != header.num_samples or off != len(data):
        raise StreamError("blocks do not cover the stream exactly")
    return frames


# -- lockstep bit reading ----------------------------------------------------

_MASK63 = (1 << 63) - 1
_MASK56 = (1 << 56) - 1
# leading zeros of a 16-bit value (16 for zero)
_LZ16 = np.array([16] + [15 - int(v).bit_length() + 1
                         for v in range(1, 1 << 16)], np.int64)


def _leading_zeros(v: np.ndarray) -> np.ndarray:
    """Leading zeros of 63-bit windows held in int64 (63 for zero),
    exactly: the top 31 and the low 32 bits each convert to float64
    without rounding."""
    hi = (v >> 32).astype(np.float64)
    lo = (v & MASK32).astype(np.float64)
    bitlen = np.where(hi > 0, 32 + np.frexp(hi)[1], np.frexp(lo)[1])
    return 63 - bitlen.astype(np.int64)


def _top(v: np.ndarray, k) -> np.ndarray:
    """The first k bits (k <= 32) of 63-bit windows, 0 where k is 0."""
    return v >> (63 - np.asarray(k, np.int64))


def unzigzag(u: np.ndarray) -> np.ndarray:
    return (u >> 1) ^ -(u & 1)


class Lanes:
    """One bit reader per payload, all advanced together. A read gives
    each lane (or the lanes in `idx`) its next field. A lane's window is
    the 63 bits from its position, held in int64, of which at least 49
    come from its payload (7 bytes loaded, shifted by the position's
    offset within its byte)."""

    VALID = 49

    def __init__(self, payloads: Sequence[bytes]):
        sizes = np.array([len(p) for p in payloads], np.int64)
        self.start = np.concatenate([[0], np.cumsum(sizes)[:-1]]) * 8
        self.end = self.start + sizes * 8
        self.buf = np.frombuffer(b"".join(payloads) + bytes(16), np.uint8)
        # the little-endian 8-byte word at every byte offset
        self.words = np.ndarray(shape=(self.buf.size - 7,), dtype=np.uint64,
                                buffer=self.buf, strides=(1,))
        self.pos = self.start.copy()
        self.bad = np.zeros(len(payloads), bool)

    def _window(self, idx):
        pos = self.pos[idx]
        w = self.words[np.minimum(pos >> 3, self.words.size - 1)]
        w = w.byteswap().view(np.int64)  # the 8 bytes from pos >> 3
        return (((w >> 8) & _MASK56) << (7 + (pos & 7))) & _MASK63

    def get(self, k, idx=slice(None)) -> np.ndarray:
        """The next k bits (k <= 32, scalar or per lane) as int64."""
        v = _top(self._window(idx), k)
        self.pos[idx] += k
        return v

    def peek(self, k, idx=slice(None)) -> np.ndarray:
        return _top(self._window(idx), k)

    def _scalar_run(self, lane: int) -> int:
        """Zero run at a lane's position, read bit by bit (the rare runs
        longer than a window)."""
        pos = int(self.pos[lane])
        end = int(self.end[lane])
        run = 0
        while pos < end and not (self.buf[pos >> 3] >> (7 - (pos & 7))) & 1:
            run += 1
            pos += 1
        if pos >= end:
            self.bad[lane] = True
        self.pos[lane] = pos
        return run

    def _scalar_get(self, lane: int, k: int) -> int:
        v = 0
        pos = int(self.pos[lane])
        for _ in range(k):
            v = (v << 1) | int((self.buf[pos >> 3] >> (7 - (pos & 7))) & 1)
            pos += 1
        self.pos[lane] = pos
        return v

    def _scalar_gamma(self, lane: int) -> int:
        run = self._scalar_run(lane)
        self.pos[lane] += 1
        if run >= 32:
            self.bad[lane] = True
            return 0
        return (1 << run) + self._scalar_get(lane, run) - 1 if run else 0

    def gamma(self, idx) -> np.ndarray:
        """The format's gamma code: a zero run r, a one, then r bits; the
        value is 2^r + those bits - 1."""
        v = self._window(idx)
        q = _leading_zeros(v)
        fast = 2 * q + 1 <= self.VALID
        rest = ((v << np.where(fast, q + 1, 0)) & _MASK63) >> (63 - q)
        val = np.where(q == 0, 0,
                       (np.int64(1) << np.minimum(q, 62)) + rest - 1)
        lanes = np.arange(self.pos.size)[idx]
        self.pos[lanes[fast]] += (2 * q + 1)[fast]
        for j in np.flatnonzero(~fast):
            val[j] = self._scalar_gamma(lanes[j])
        return val

    def rice(self, k1: np.ndarray, k2: np.ndarray,
             k1pow: np.ndarray) -> np.ndarray:
        """One Rice symbol of every lane, with parameters (k1, k2),
        k1 = k2 + 1, k1pow = 2^k1: a value below 2^k1 is a one and k1
        bits; else a zero run q >= 1, a one and k2 bits, for 2^k1 +
        ((q - 1) << k2) + those bits, wrapped to 32 bits. Returns the
        zigzag-decoded values."""
        v = self._window(slice(None))
        top = v >> 47
        q = _LZ16[top]
        width = np.where(q == 0, k1, k2)
        shift = q + 1
        val = ((v << shift) & _MASK63) >> (63 - width)
        u = (val + np.where(q == 0, 0, k1pow + ((q - 1) << k2))) & MASK32
        self.pos += shift + width
        slow = np.flatnonzero(top == 0)
        for lane in slow:  # runs of 16 zeros or more, bit by bit
            self.pos[lane] -= shift[lane] + width[lane]
            run = self._scalar_run(lane)
            self.pos[lane] += 1
            if run == 0:
                u[lane] = self._scalar_get(lane, int(k1[lane]))
            else:
                u[lane] = (self._scalar_get(lane, int(k2[lane]))
                           + int(k1pow[lane])
                           + ((run - 1) << int(k2[lane]))) & MASK32
        return unzigzag(u)


class CompressGroup(NamedTuple):
    """The compress blocks of one length, read together; per block."""
    pprev: np.ndarray     # [B, C, 2] pre-emphasis state
    pcoef: np.ndarray     # [B, C, 2] pre-emphasis coefficients
    log2u: np.ndarray     # [B, C, L]
    rshift: np.ndarray    # [B, C, L]
    coefs: np.ndarray     # [B, C, sum of orders]
    porder: np.ndarray    # [B, C]
    k2: np.ndarray        # [B, C, 2^porder], -1 past the block's partitions
    residual: np.ndarray  # [B, C, n] int64
    bad: np.ndarray       # [B] the payload does not parse


def read_compress(payloads: Sequence[bytes], n: int, nch: int, bps: int,
                  orders: Sequence[int], table: HuffmanTable) -> CompressGroup:
    B = len(payloads)
    L = len(orders)
    lanes = Lanes(payloads)
    pprev = np.zeros((B, nch, NUM_PREEMPH), np.int64)
    pcoef = np.zeros((B, nch, NUM_PREEMPH), np.int64)
    for ch in range(nch):
        for st in range(NUM_PREEMPH):
            pprev[:, ch, st] = unzigzag(lanes.get(bps + 1))
            pcoef[:, ch, st] = lanes.get(PREEMPH_SHIFT - 1)
    log2u = np.zeros((B, nch, L), np.int64)
    rshift = np.zeros((B, nch, L), np.int64)
    coefs = np.zeros((B, nch, sum(orders)), np.int64)
    for ch in range(nch):
        col = 0
        for li, order in enumerate(orders):
            log2u[:, ch, li] = lanes.get(LOG2_UNITS_BITS)
            rshift[:, ch, li] = lanes.get(RSHIFT_BITS)
            for _ in range(order):
                pat = lanes.peek(table.bits)
                lanes.pos += table.length[pat]
                coefs[:, ch, col] = unzigzag(table.symbol[pat])
                col += 1
    porder = np.zeros((B, nch), np.int64)
    max_parts = 1 << 10
    k2_all = np.full((B, nch, max_parts), -1, np.int64)
    residual = np.zeros((B, nch, n), np.int64)
    for ch in range(nch):
        po = lanes.get(PORDER_BITS)
        nsmpl = n >> np.minimum(po, 31)
        lanes.bad |= (nsmpl << np.minimum(po, 31)) != n
        nsmpl = np.maximum(nsmpl, 1)
        porder[:, ch] = po
        part = np.zeros(B, np.int64)
        out = np.empty((n, B), np.int64)
        # the steps at which some lane starts a partition
        starts_set = set(np.concatenate(
            [np.arange(0, n, m) for m in np.unique(nsmpl)]).tolist())
        k2 = k1 = k1pow = None
        for s in range(n):
            if s == 0:
                k2 = lanes.get(RICE_PARAM_BITS)
                k2_all[:, ch, 0] = k2
            elif s in starts_set:
                at = np.flatnonzero(s % nsmpl == 0)
                k2[at] += unzigzag(lanes.gamma(at))
                part[at] += 1
                lanes.bad[at] |= (k2[at] < 0) | (k2[at] > 31)
                k2[at] = np.clip(k2[at], 0, 31)
                ok = part[at] < max_parts
                k2_all[at[ok], ch, part[at[ok]]] = k2[at[ok]]
            else:
                out[s] = lanes.rice(k1, k2, k1pow)
                continue
            k1 = k2 + 1
            k1pow = np.int64(1) << k1
            out[s] = lanes.rice(k1, k2, k1pow)
        residual[:, ch, :] = out.T
    # the payload ends at the next byte boundary
    used = (lanes.pos - lanes.start + 7) // 8 * 8
    lanes.bad |= used != lanes.end - lanes.start
    residual = ((residual + 2**31) & MASK32) - 2**31
    return CompressGroup(pprev, pcoef, log2u, rshift, coefs, porder, k2_all,
                         residual, lanes.bad)


def read_raw(payload: bytes, nch: int, n: int, bps: int) -> np.ndarray:
    """[C, n] samples of a raw block: channel-interleaved zigzagged PCM,
    big-endian."""
    width = bps // 8
    if len(payload) != nch * n * width or bps not in (8, 16, 24):
        raise StreamError("raw block of the wrong size")
    b = np.frombuffer(payload, np.uint8).reshape(-1, width).astype(np.int64)
    u = np.zeros(b.shape[0], np.int64)
    for i in range(width):
        u = (u << 8) | b[:, i]
    return unzigzag(u).reshape(n, nch).T.copy()


class Parsed(NamedTuple):
    """Every block of a set of streams. `blocks[i]` lists stream i's blocks
    as (type, n, group key, row): compress blocks point at row `row` of
    `groups[n]`, raw blocks at `raw[row]`; `bad[i]` names what is wrong
    with stream i, or is None."""
    headers: List[Header]
    blocks: List[list]
    groups: Dict[int, CompressGroup]
    members: Dict[int, list]   # n -> [(stream, block index)] of its rows
    raw: List[np.ndarray]
    bad: List[object]


def parse_streams(streams: Sequence[bytes], orders: Sequence[int],
                  table: HuffmanTable | None = None) -> Parsed:
    table = table or huffman_table()
    headers, blocks, bad = [], [], []
    payloads: Dict[int, list] = {}
    members: Dict[int, list] = {}
    raw: List[np.ndarray] = []
    frames_all = []
    for si, data in enumerate(streams):
        try:
            h = read_header(data)
            frames = read_frames(data, h)
        except StreamError as e:
            headers.append(None)
            blocks.append([])
            bad.append(str(e))
            frames_all.append([])
            continue
        headers.append(h)
        bad.append(None)
        frames_all.append(frames)
    # every block's CRC at once
    flat = [(si, bi) for si, fr in enumerate(frames_all)
            for bi in range(len(fr))]
    crcs = crc16_many([frames_all[si][bi].body for si, bi in flat])
    for (si, bi), c in zip(flat, crcs):
        if int(c) != frames_all[si][bi].crc and bad[si] is None:
            bad[si] = f"CRC of block {bi} does not match"
    for si, frames in enumerate(frames_all):
        h = headers[si]
        out = []
        for bi, f in enumerate(frames):
            if f.block_type == BLOCK_COMPRESS:
                payloads.setdefault(f.num_samples, []).append(f.payload)
                members.setdefault(f.num_samples, []).append((si, bi))
                out.append((BLOCK_COMPRESS, f.num_samples, f.num_samples,
                            len(members[f.num_samples]) - 1))
            elif f.block_type == BLOCK_RAW:
                try:
                    raw.append(read_raw(f.payload, h.num_channels,
                                        f.num_samples, h.bits_per_sample))
                except StreamError as e:
                    bad[si] = bad[si] or str(e)
                    raw.append(None)
                out.append((BLOCK_RAW, f.num_samples, None, len(raw) - 1))
            else:
                if f.payload:
                    bad[si] = bad[si] or "silent block with a payload"
                out.append((BLOCK_SILENT, f.num_samples, None, None))
        blocks.append(out)
    groups = {}
    for n, pl in payloads.items():
        nch = headers[members[n][0][0]].num_channels
        bps = headers[members[n][0][0]].bits_per_sample
        groups[n] = read_compress(pl, n, nch, bps, orders, table)
        for row in np.flatnonzero(groups[n].bad):
            si, bi = members[n][row]
            bad[si] = bad[si] or f"compress block {bi} does not parse"
    return Parsed(headers, blocks, groups, members, raw, bad)
