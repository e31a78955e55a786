"""SLE — static low entropy coder (id "sle"), [Dinklage 2015]; consuming.

Format mirror of include/tudocomp/coders/SLECoder.hpp:9-455:
  - Pre-pass over the literal feed counts single literals and, for kmer>1,
    all contiguous k-grams (k-mer buffer resets when literal positions are
    non-adjacent). The eta most frequent k-mers (eta from the alphabet
    power-of-two headroom, :122-131) join the alphabet; symbols are ranked
    by (count desc, value asc) (util/Counter.hpp:47-85).
  - Header: compressed_int(sigma) then each ranked symbol as a
    compressed_int (k-mers are the packed bytes OR'd with 0xFF<<56).
  - Literals emit rank codes in a sigma_bits-dependent prefix scheme
    (:193-247); recognized full k-mers emit one rank code for k literals.
  - Non-literal ranges interrupt (flush) the k-mer buffer: plain Range is
    binary, MinDistributedRange uses a 2-bit-prefix scheme (:277-302),
    BitRange one bit.
The port's copy of tudocomp_tpu/coders/sle.py.
"""

from __future__ import annotations

import numpy as np

from ..io.bitio import BitReader, BitWriter, bits_for
from ..meta import Meta
from ..ranges import BitRange, LiteralRange, MinDistributedRange, Range
from .base import Decoder, Encoder

KMER_MASK = 0xFF << 56


def is_kmer(x: int) -> bool:
    return (x & KMER_MASK) == KMER_MASK


def compile_kmer(kmer, k: int) -> int:
    x = 0
    for i in range(k):
        x |= int(kmer[k - 1 - i]) << (8 * i)
    return x | KMER_MASK


def decompile_kmer(x: int, k: int) -> list[int]:
    return [(x >> (8 * (k - 1 - i))) & 0xFF for i in range(k)]


def _sorted_counts(counts: dict[int, int]):
    """Counter::getSorted order: count desc, symbol asc."""
    return sorted(counts.items(), key=lambda e: (-e[1], e[0]))


class SLECoder:
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("coder", "sle", "Static low entropy encoding [Dinklage, 2015]")
        m.option("kmer").dynamic(3)
        return m

    class Encoder(Encoder):
        def __init__(self, env, writer: BitWriter, literals):
            super().__init__(env, writer, literals)
            self.k = self.env.option("kmer").as_integer()
            chars = np.asarray(literals.chars(), dtype=np.uint8)
            positions = np.asarray(literals.positions(), dtype=np.int64)

            alphabet: dict[int, int] = {}
            kmers: dict[int, int] = {}
            self._kmer: list[int] = []
            last_pos = 0
            for c, pos in zip(chars, positions):
                c = int(c)
                if self.k > 1:
                    if pos != last_pos + 1:
                        self._kmer = []
                    if len(self._kmer) == self.k:
                        self._kmer.pop(0)
                    self._kmer.append(c)
                    if len(self._kmer) == self.k:
                        x = compile_kmer(self._kmer, self.k)
                        kmers[x] = kmers.get(x, 0) + 1
                alphabet[c] = alphabet.get(c, 0) + 1
                last_pos = int(pos)

            sigma = len(alphabet)
            self.sigma_bits = bits_for(sigma - 1) if sigma else 64
            if self.k > 1 and sigma:
                eta_add = 1 if (1 << self.sigma_bits) == sigma else 2
                eta = (1 << (self.sigma_bits + eta_add)) - sigma
                for x, cnt in _sorted_counts(kmers):
                    alphabet[x] = cnt
                    eta -= 1
                    if eta == 0:
                        break
                sigma = len(alphabet)
                self.sigma_bits = bits_for(sigma - 1)

            ordered = _sorted_counts(alphabet)
            self.ranking = {x: i for i, (x, _) in enumerate(ordered)}

            self.w.write_compressed_int(sigma)
            for x, _ in ordered:
                self.w.write_compressed_int(x)
            self._kmer = []

        # -- internals ----------------------------------------------------

        def _flush_kmer(self):
            for c in self._kmer:
                self._encode_sym(c)
            self._kmer = []

        def _encode_sym(self, x: int):
            r = self.ranking[x]
            w = self.w
            sb = self.sigma_bits
            if sb < 4:
                w.write_int(r, sb)
            elif sb < 6:
                if r < 4:
                    w.write_bit(0)
                    w.write_int(r, 2)
                else:
                    w.write_bit(1)
                    w.write_int(r, sb)
            elif sb == 6:
                if r < 8:
                    w.write_int(0, 2)
                    w.write_int(r, 3)
                elif r < 16:
                    w.write_int(1, 2)
                    w.write_int(r - 8, 3)
                elif r < 32:
                    w.write_int(2, 2)
                    w.write_int(r - 16, 4)
                else:
                    w.write_int(3, 2)
                    w.write_int(r, sb)
            else:
                table = [(4, 2, 0), (8, 2, 4), (12, 2, 8), (16, 2, 12),
                         (24, 3, 16), (32, 3, 24), (40, 3, 32)]
                for prefix, (limit, bits, base) in enumerate(table):
                    if r < limit:
                        w.write_int(prefix, 3)
                        w.write_int(r - base, bits)
                        return
                w.write_int(7, 3)
                w.write_int(r, sb)

        # -- coder interface ----------------------------------------------

        def encode(self, v, r: Range) -> None:
            if isinstance(r, LiteralRange):
                c = int(v) & 0xFF
                if len(self._kmer) == self.k:
                    out = self._kmer.pop(0)
                    self._encode_sym(out)
                self._kmer.append(c)
                if len(self._kmer) == self.k:
                    x = compile_kmer(self._kmer, self.k)
                    if x in self.ranking:
                        self._encode_sym(x)
                        self._kmer = []
            elif isinstance(r, BitRange):
                self._flush_kmer()
                self.w.write_bit(bool(v))
            elif isinstance(r, MinDistributedRange):
                self._flush_kmer()
                v = int(v) - r.min
                bits = bits_for(r.delta)
                w = self.w
                if bits <= 5:
                    w.write_int(v, bits)
                elif v < 8:
                    w.write_int(0, 2)
                    w.write_int(v, 3)
                elif v < 16:
                    w.write_int(1, 2)
                    w.write_int(v - 8, 3)
                elif v < 32:
                    w.write_int(2, 2)
                    w.write_int(v - 16, 4)
                else:
                    w.write_int(3, 2)
                    w.write_int(v, bits)
            else:
                self._flush_kmer()
                self.w.write_int(int(v) - r.min, bits_for(r.delta))

        def encode_array(self, values, r: Range) -> None:
            for v in np.asarray(values).ravel():
                self.encode(int(v), r)

        def tokens(self, values, r):
            return None  # consuming coder: no independent token form

        def finalize(self) -> None:
            self._flush_kmer()

    class Decoder(Decoder):
        def __init__(self, env, reader: BitReader):
            super().__init__(env, reader)
            self.k = self.env.option("kmer").as_integer()
            sigma = self.r.read_compressed_int()
            self.sigma_bits = bits_for(sigma - 1) if sigma else 64
            self.inv_ranking = [self.r.read_compressed_int() for _ in range(sigma)]
            self._kmer: list[int] = []
            self._kmer_read = 1 << 62  # SIZE_MAX analogue

        def literal_fixed_width(self):
            return None

        def eof(self) -> bool:
            if self._kmer_read < self.k:
                return False
            return self.r.eof()

        def decode(self, r: Range):
            if isinstance(r, LiteralRange):
                if self._kmer_read < self.k:
                    c = self._kmer[self._kmer_read]
                    self._kmer_read += 1
                    return c
                rr = self._read_rank()
                x = self.inv_ranking[rr]
                if is_kmer(x):
                    self._kmer = decompile_kmer(x, self.k)
                    self._kmer_read = 1
                    return self._kmer[0]
                return int(x)
            if isinstance(r, BitRange):
                self._kmer_read = 1 << 62
                return self.r.read_bit()
            if isinstance(r, MinDistributedRange):
                self._kmer_read = 1 << 62
                bits = bits_for(r.delta)
                rd = self.r
                if bits <= 5:
                    v = rd.read_int(bits)
                else:
                    x = rd.read_int(2)
                    if x == 0:
                        v = rd.read_int(3)
                    elif x == 1:
                        v = 8 + rd.read_int(3)
                    elif x == 2:
                        v = 16 + rd.read_int(4)
                    else:
                        v = rd.read_int(bits)
                return v + r.min
            self._kmer_read = 1 << 62
            return self.r.read_int(bits_for(r.delta)) + r.min

        def _read_rank(self) -> int:
            rd = self.r
            sb = self.sigma_bits
            if sb < 4:
                return rd.read_int(sb)
            if sb < 6:
                if rd.read_bit() == 0:
                    return rd.read_int(2)
                return rd.read_int(sb)
            if sb == 6:
                x = rd.read_int(2)
                if x == 0:
                    return rd.read_int(3)
                if x == 1:
                    return 8 + rd.read_int(3)
                if x == 2:
                    return 16 + rd.read_int(4)
                return rd.read_int(sb)
            x = rd.read_int(3)
            bases = [(0, 2), (4, 2), (8, 2), (12, 2), (16, 3), (24, 3), (32, 3)]
            if x < 7:
                base, bits = bases[x]
                return base + rd.read_int(bits)
            return rd.read_int(sb)
