"""Canonical Huffman coder (id "huff").

Format mirror of include/tudocomp/coders/HuffmanCoder.hpp:
  - Encoder writes a 1-bit header flag: 0 for degenerate alphabets
    (size <= 1, literals then raw 8-bit), 1 followed by the serialized table
    (HuffmanCoder.hpp:540-546).
  - Table serialization (huffmantable_encode, :264-273):
    compressed_int(longest), longest x compressed_int(numl[l]),
    compressed_int(alphabet_size), alphabet_size x 8-bit symbols ordered by
    codeword length.
  - Code lengths via the Managing Gigabytes ch. 2.3 in-place heap algorithm
    (gen_codelengths :88-169); canonical codewords from
    firstcode[longest-1]=0, firstcode[i-1]=(firstcode[i]+numl[i])/2
    (gen_first_codes :192-198), assigned in length-sorted symbol order.
  - Non-literal ranges fall back to plain binary (base Encoder).

Encode is vectorized: literal -> (codeword, length) table lookups feed the
bit writer. The port's copy of tudocomp_tpu/coders/huffman.py; the
blockwise device encode is ops/huffman_torch.py.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..io.bitio import BitReader, BitWriter
from ..meta import Meta
from ..ranges import LiteralRange, Range
from .base import Decoder, Encoder


def gen_codelengths(counts: np.ndarray) -> np.ndarray:
    """Huffman code lengths for the effective alphabet (counts all > 0).

    Semantics of gen_codelengths (HuffmanCoder.hpp:88-169): repeatedly merge
    the two least-frequent nodes. Ties break deterministically by node
    creation order; any optimal tree yields the same total bit count.
    """
    sigma = len(counts)
    assert sigma >= 2
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = np.zeros(2 * sigma, dtype=np.int64)  # node id -> parent id
    next_id = sigma
    while len(heap) > 1:
        c1, n1 = heapq.heappop(heap)
        c2, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        heapq.heappush(heap, (c1 + c2, next_id))
        next_id += 1
    root = heap[0][1]
    depth = np.zeros(2 * sigma, dtype=np.uint8)
    # nodes were created in increasing id order; parents have larger ids,
    # so walk ids descending to propagate depths root-down
    for node in range(next_id - 1, -1, -1):
        if node != root:
            depth[node] = depth[parent[node]] + 1
    lengths = depth[:sigma].copy()
    assert (lengths > 0).all() and lengths.max() <= 64
    return lengths


class HuffmanTable:
    """extended_huffmantable analogue (HuffmanCoder.hpp:220-259)."""

    def __init__(self, ordered_map_from_effective, ordered_codelengths, numl, longest):
        self.ordered_map_from_effective = np.asarray(
            ordered_map_from_effective, np.uint8
        )
        self.ordered_codelengths = np.asarray(ordered_codelengths, np.uint8)
        self.numl = np.asarray(numl, np.int64)
        self.longest = int(longest)
        self.alphabet_size = len(self.ordered_map_from_effective)
        self.firstcodes = gen_first_codes(self.numl, self.longest)
        # codewords in ordered-symbol order (gen_codewords :202-218)
        cw = np.zeros(self.alphabet_size, dtype=np.uint64)
        nextcode = self.firstcodes.copy()
        for i in range(self.alphabet_size):
            l = self.ordered_codelengths[i] - 1
            cw[i] = nextcode[l]
            nextcode[l] += 1
        self.codewords = cw

    @classmethod
    def from_counts(cls, full_counts: np.ndarray) -> "HuffmanTable":
        """Build from a 256-entry histogram with >= 2 nonzero entries."""
        eff = np.flatnonzero(full_counts)
        lengths = gen_codelengths(full_counts[eff])
        order = np.argsort(lengths, kind="stable")
        ordered_lengths = lengths[order]
        ordered_map = eff[order].astype(np.uint8)
        longest = int(ordered_lengths.max())
        numl = np.bincount(ordered_lengths.astype(np.int64), minlength=longest + 1)[
            1:
        ]
        return cls(ordered_map, ordered_lengths, numl, longest)


def gen_first_codes(numl: np.ndarray, longest: int) -> np.ndarray:
    """firstcode[l-1] = smallest codeword of length l (HuffmanCoder.hpp:192-198)."""
    firstcode = np.zeros(longest, dtype=np.uint64)
    for i in range(longest - 1, 0, -1):
        firstcode[i - 1] = (firstcode[i] + int(numl[i])) // 2
    return firstcode


def write_table(w: BitWriter, t: HuffmanTable) -> None:
    w.write_compressed_int(t.longest)
    for i in range(t.longest):
        w.write_compressed_int(int(t.numl[i]))
    w.write_compressed_int(t.alphabet_size)
    w.write_ints(t.ordered_map_from_effective.astype(np.uint64), 8)


def read_table(r: BitReader) -> HuffmanTable:
    longest = r.read_compressed_int()
    numl = np.array([r.read_compressed_int() for _ in range(longest)], np.int64)
    alphabet_size = r.read_compressed_int()
    ordered_map = r.read_ints(alphabet_size, 8).astype(np.uint8)
    # ordered codelengths from numl (gen_ordered_codelength :426-435)
    ordered_lengths = np.repeat(np.arange(1, longest + 1, dtype=np.uint8), numl)
    return HuffmanTable(ordered_map, ordered_lengths, numl, longest)


class HuffmanCoder:
    @classmethod
    def meta(cls) -> Meta:
        return Meta("coder", "huff", "Canonical Huffman Coder")

    class Encoder(Encoder):
        def __init__(self, env, writer: BitWriter, literals, counts=None):
            """counts, when given, is an externally imposed 256-entry
            histogram (e.g. a table shared by many blocks) used in place
            of the literal feed's own counts; the table is still serialized into this
            stream, so the output stays standard-decodable."""
            super().__init__(env, writer, literals)
            if counts is None:
                chars = literals.chars()
                if len(chars) == 0:
                    self.table = None
                    self.w.write_bit(0)
                    return
                counts = np.bincount(chars, minlength=256)
            if np.count_nonzero(counts) <= 1:
                self.table = None
                self.w.write_bit(0)
                return
            self.table = HuffmanTable.from_counts(counts)
            from ..paranoid import check_kraft

            check_kraft(self.table.ordered_codelengths)
            # full-alphabet lookup tables for vectorized encode
            self._cw = np.zeros(256, dtype=np.uint64)
            self._cl = np.zeros(256, dtype=np.int64)
            m = self.table.ordered_map_from_effective
            self._cw[m] = self.table.codewords
            self._cl[m] = self.table.ordered_codelengths
            self.w.write_bit(1)
            write_table(self.w, self.table)

        def encode(self, v, r: Range) -> None:
            if isinstance(r, LiteralRange):
                if self.table is None:
                    self.w.write_int(int(v) & 0xFF, 8)
                else:
                    c = int(v) & 0xFF
                    self.w.write_int(int(self._cw[c]), int(self._cl[c]))
            else:
                super().encode(v, r)

        def encode_array(self, values, r: Range) -> None:
            if isinstance(r, LiteralRange):
                values = np.asarray(values, dtype=np.uint8)
                if self.table is None:
                    self.w.write_ints(values.astype(np.uint64), 8, masked=True)
                else:
                    self.w.write_ints(
                        self._cw[values], self._cl[values], masked=True
                    )
            else:
                super().encode_array(values, r)

        def tokens(self, values, r):
            if isinstance(r, LiteralRange):
                from .base import TokenStream

                values = np.asarray(values, dtype=np.uint8)
                if self.table is None:
                    return TokenStream(values.astype(np.uint64), 8, None)
                return TokenStream(self._cw[values], self._cl[values], None)
            return super().tokens(values, r)

    class Decoder(Decoder):
        def __init__(self, env, reader: BitReader):
            super().__init__(env, reader)
            if not self.r.read_bit():
                self.table = None
                return
            self.table = read_table(self.r)
            t = self.table
            # prefix_sum_lengths (gen_prefix_sum_lengths :356-376)
            psl = np.zeros(t.longest, dtype=np.int64)
            psl[t.ordered_codelengths[0] - 1] = 0
            for i in range(1, t.alphabet_size):
                if t.ordered_codelengths[i - 1] < t.ordered_codelengths[i]:
                    psl[t.ordered_codelengths[i] - 1] = i
            self._psl = psl
            # full decode table over `longest` bits when small enough
            self._lut = None
            if t.longest <= 16:
                lut_sym = np.zeros(1 << t.longest, dtype=np.uint8)
                lut_len = np.zeros(1 << t.longest, dtype=np.uint8)
                for i in range(t.alphabet_size):
                    l = int(t.ordered_codelengths[i])
                    cw = int(t.codewords[i])
                    pad = t.longest - l
                    lo = cw << pad
                    hi = (cw + 1) << pad
                    lut_sym[lo:hi] = t.ordered_map_from_effective[i]
                    lut_len[lo:hi] = l
                self._lut = (lut_sym, lut_len)

        def literal_fixed_width(self):
            return 8 if self.table is None else None

        def stream_parse_tables(self):
            if self.table is None:
                return (0, None)  # degenerate: raw 8-bit literals
            t = self.table
            fc = np.ascontiguousarray(t.firstcodes, np.uint64)
            psl = np.ascontiguousarray(self._psl, np.int64)
            syms = np.ascontiguousarray(t.ordered_map_from_effective, np.uint8)
            return (1, (fc, psl, syms, int(t.longest)))

        def decode(self, r: Range) -> int:
            if not isinstance(r, LiteralRange):
                return super().decode(r)
            if self.table is None:
                return self.r.read_int(8)
            t = self.table
            value = 0
            length = 0
            while True:
                value = (value << 1) | self.r.read_bit()
                length += 1
                if value >= int(t.firstcodes[length - 1]):
                    break
            return int(
                t.ordered_map_from_effective[
                    self._psl[length - 1] + value - int(t.firstcodes[length - 1])
                ]
            )

        def decode_array(self, count: int, r: Range) -> np.ndarray:
            if not isinstance(r, LiteralRange):
                return super().decode_array(count, r)
            if self.table is None:
                return self.r.read_ints(count, 8)
            return self._bulk_decode(count)

        def decode_literals_until_eof(self) -> np.ndarray:
            if self.table is None:
                n = max(0, self.r._valid - self.r.pos) // 8
                return self.r.read_ints(n, 8).astype(np.uint8)
            return self._bulk_decode(None)

        def _native_tables(self):
            if not hasattr(self, "_nt"):
                t = self.table
                sym_len = np.zeros(256, np.int64)
                sym_len[t.ordered_map_from_effective] = t.ordered_codelengths
                data = np.frombuffer(self.r._data, dtype=np.uint8)
                fc = np.ascontiguousarray(t.firstcodes, np.uint64)
                psl = np.ascontiguousarray(self._psl, np.int64)
                syms = np.ascontiguousarray(t.ordered_map_from_effective, np.uint8)
                self._nt = (sym_len, data, fc, psl, syms)
            return self._nt

        def _bulk_decode(self, count) -> np.ndarray:
            """Table-driven sequential decode with a byte accumulator."""
            t = self.table
            pos = self.r.pos
            valid = self.r._valid
            out = []
            from .. import native

            lib = native.get_lib()
            if lib is not None:
                sym_len, data, fc, psl, syms = self._native_tables()
                cap = count if count is not None else max(1, valid - pos)
                buf = np.empty(cap, dtype=np.uint8)
                if self._lut is not None:
                    lut_sym, lut_len = self._lut
                    got = lib.tdc_huffman_decode(
                        data, pos, valid, lut_sym, lut_len, t.longest, buf, cap
                    )
                else:
                    got = lib.tdc_huffman_decode_canonical(
                        data, pos, valid, fc, psl, syms, t.longest, buf, cap
                    )
                res = buf[:got]
                # advance the reader by the decoded codeword lengths
                self.r._pos = min(valid, pos + int(sym_len[res].sum()))
                return res.copy()
            bits = self.r._bits
            if self._lut is not None:
                lut_sym, lut_len = self._lut
                L = t.longest
                # pack remaining bits into one big python int window walk
                lut_sym_l = lut_sym.tolist()
                lut_len_l = lut_len.tolist()
                # accumulate bits in an integer window
                acc = 0
                acc_n = 0
                i = pos
                n_target = count if count is not None else -1
                bits_l = bits
                while (n_target < 0 and pos < valid) or (len(out) != n_target):
                    if n_target < 0 and pos >= valid:
                        break
                    # refill accumulator to at least L bits (pad zeros at end)
                    while acc_n < L:
                        if i < valid:
                            take = min(valid - i, 16)
                            chunk = 0
                            for b in bits_l[i : i + take]:
                                chunk = (chunk << 1) | int(b)
                            acc = (acc << take) | chunk
                            acc_n += take
                            i += take
                        else:
                            acc <<= L - acc_n
                            acc_n = L
                    key = (acc >> (acc_n - L)) & ((1 << L) - 1)
                    l = lut_len_l[key]
                    out.append(lut_sym_l[key])
                    acc_n -= l
                    acc &= (1 << acc_n) - 1
                    pos += l
                    if n_target < 0 and pos >= valid:
                        break
                self.r._pos = min(pos, valid)
                return np.array(out, dtype=np.uint8)
            # longest > 16: fall back to per-symbol decode
            lit = LiteralRange()
            if count is None:
                while not self.r.eof():
                    out.append(self.decode(lit))
            else:
                for _ in range(count):
                    out.append(self.decode(lit))
            return np.array(out, dtype=np.uint8)


def register(registry):
    registry.register(HuffmanCoder)
