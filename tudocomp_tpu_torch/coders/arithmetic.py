"""Arithmetic (range) coder (id "arithmetic"); consuming entropy coder.

Format mirror of include/tudocomp/coders/ArithmeticCoder.hpp:16-266:
  codebook:  u32 literal_count | u8 codebook_size
             | per entry: u8 symbol, u32 cumulative normalized count
  payload:   u64 code blocks (a block is flushed when the remaining range
             drops under min_range) | final lower bound | u64 dummy ~0
Non-literal ranges fall back to plain binary (inherited base Encoder), as
in the reference. Two reference quirks are deliberately not reproduced
because they corrupt data (bytes match whenever the reference itself is
correct, i.e. for alphabets without symbol 255 and with < 256 distinct
symbols):
  - literal_count/min_range use the full cumulative total C[255]; the
    reference uses C[254] on encode but C[255] on decode
    (ArithmeticCoder.hpp:87,97 vs :241), desyncing when byte 255 occurs.
  - a 256-entry codebook wraps the u8 size field to 0; the decoder here
    reads size 0 with literal_count > 0 back as 256.
The per-literal bound-update loops run in the port's C++ host helpers
(tdc_arith_encode/tdc_arith_decode) with Python fallbacks. The port's copy
of tudocomp_tpu/coders/arithmetic.py.
"""

from __future__ import annotations

import numpy as np

from ..io.bitio import BitReader, BitWriter
from ..meta import Meta
from ..ranges import LiteralRange, Range
from .base import Decoder, Encoder
from .. import native

U64_MAX = 0xFFFFFFFFFFFFFFFF


def _bounds_update(lower, upper, cum, total, v):
    rng = (upper - lower) & U64_MAX
    off_u = rng * cum[v] // total if rng <= total else rng // total * cum[v]
    upper = (lower + off_u) & U64_MAX
    if v:
        off_l = rng * cum[v - 1] // total if rng <= total else rng // total * cum[v - 1]
        lower = (lower + off_l) & U64_MAX
    return lower, upper


class ArithmeticCoder:
    @classmethod
    def meta(cls) -> Meta:
        return Meta("coder", "arithmetic", "Simple range encoding")

    class Encoder(Encoder):
        def __init__(self, env, writer: BitWriter, literals):
            super().__init__(env, writer, literals)
            chars = np.asarray(literals.chars(), dtype=np.uint8)
            counts = np.bincount(chars, minlength=256).astype(np.uint64)
            self._nonzero = np.flatnonzero(counts)
            self.codebook_size = len(self._nonzero)
            if self.codebook_size:
                mn = int(counts[self._nonzero].min())
                cum = np.cumsum(counts) // mn
            else:
                cum = np.zeros(256, np.uint64)
            self.cum = cum.astype(np.uint64)
            self.total = int(cum[255])
            self.min_range = self.total
            self.literal_count = int(len(chars))
            self._emitted = 0
            self._lower = 0
            self._upper = U64_MAX
            # codebook (writeCodebook, ArithmeticCoder.hpp:119-144)
            self.w.write_int(self.literal_count, 32)
            self.w.write_int(self.codebook_size & 0xFF, 8)
            for s in self._nonzero:
                self.w.write_int(int(s), 8)
                self.w.write_int(int(self.cum[s]), 32)

        def encode(self, v, r: Range) -> None:
            if not isinstance(r, LiteralRange):
                super().encode(v, r)
                return
            v = int(v) & 0xFF
            rng = (self._upper - self._lower) & U64_MAX
            if rng < self.min_range:
                self.w.write_int(self._lower, 64)
                self._lower, self._upper = 0, U64_MAX
            self._lower, self._upper = _bounds_update(
                self._lower, self._upper, self.cum, self.total, v
            )
            self._emitted += 1
            if self._emitted == self.literal_count:
                self.w.write_int(self._lower, 64)
                self.w.write_int(U64_MAX, 64)

        def encode_array(self, values, r: Range) -> None:
            if not isinstance(r, LiteralRange):
                super().encode_array(values, r)
                return
            values = np.ascontiguousarray(values, dtype=np.uint8)
            if self.literal_count == 0:
                return
            lib = native.get_lib()
            if lib is None or self._emitted or len(values) != self.literal_count:
                for v in values:
                    self.encode(int(v), r)
                return
            codes = np.empty(len(values) + 2, dtype=np.uint64)
            nc = lib.tdc_arith_encode(
                values,
                len(values),
                self.cum.astype(np.uint32),
                self.min_range,
                codes,
            )
            self._emitted = len(values)
            for c in codes[:nc]:
                self.w.write_int(int(c), 64)
            self.w.write_int(U64_MAX, 64)

        def tokens(self, values, r):
            if isinstance(r, LiteralRange):
                return None  # consuming: no independent token form
            return super().tokens(values, r)

    class Decoder(Decoder):
        def __init__(self, env, reader: BitReader):
            super().__init__(env, reader)
            self.literal_count = self.r.read_int(32)
            cb = self.r.read_int(8)
            if cb == 0 and self.literal_count > 0:
                cb = 256  # wrapped u8 size (full alphabet)
            self.codebook_size = cb
            self.syms = np.zeros(cb, np.uint8)
            self.cums = np.zeros(cb, np.uint32)
            for i in range(cb):
                self.syms[i] = self.r.read_int(8)
                self.cums[i] = self.r.read_int(32)
            self.min_range = int(self.cums[cb - 1]) if cb else 0
            self._buf: list[int] = []
            self._buf_pos = 0
            self._decoded = 0

        def literal_fixed_width(self):
            return None

        def _decode_block(self, code: int) -> None:
            total = self.min_range
            out = []
            lower, upper = 0, U64_MAX
            rng = U64_MAX
            while self.min_range <= rng and self._decoded < self.literal_count:
                interval_lower = lower
                for i in range(self.codebook_size):
                    c = int(self.cums[i])
                    off = rng * c // total if rng <= total else rng // total * c
                    upper = (lower + off) & U64_MAX
                    if code < upper:
                        out.append(int(self.syms[i]))
                        lower = interval_lower
                        break
                    interval_lower = upper
                self._decoded += 1
                rng = (upper - lower) & U64_MAX
            self._buf = out
            self._buf_pos = 0

        def decode(self, r: Range):
            if not isinstance(r, LiteralRange):
                return super().decode(r)
            if self._buf_pos >= len(self._buf):
                code = self.r.read_int(64)
                if code != U64_MAX:
                    self._decode_block(code)
            v = self._buf[self._buf_pos]
            self._buf_pos += 1
            if self._buf_pos >= len(self._buf):
                code = self.r.read_int(64)
                if code != U64_MAX:
                    self._decode_block(code)
            return v

        def decode_literals_until_eof(self) -> np.ndarray:
            if self.literal_count == 0:
                return np.zeros(0, np.uint8)
            lib = native.get_lib()
            if lib is None or self._decoded or self._buf:
                out = []
                lit = LiteralRange()
                for _ in range(self.literal_count):
                    out.append(self.decode(lit))
                return np.array(out, dtype=np.uint8)
            # bulk: read all code u64s up to (excluding) the dummy
            codes = []
            while not self.r.eof():
                c = self.r.read_int(64)
                if c == U64_MAX:
                    break
                codes.append(c)
            out = np.empty(self.literal_count, np.uint8)
            got = lib.tdc_arith_decode(
                np.array(codes, dtype=np.uint64),
                len(codes),
                self.syms,
                self.cums,
                self.codebook_size,
                self.min_range,
                self.literal_count,
                out,
            )
            assert got == self.literal_count, (got, self.literal_count)
            self._decoded = got
            return out

