"""Universal coders: ascii, bit, gamma, delta, ternary.

Formats mirror the reference exactly:
  - ASCIICoder (coders/ASCIICoder.hpp:15-96): integers as decimal text + ':'
    terminator, literals as raw 8-bit chars, bits as '0'/'1' characters.
  - BitCoder (coders/BitCoder.hpp:13): the base behavior — v-min in
    bits_for(max-min) bits, 1 bit for BitRange.
  - EliasGammaCoder / EliasDeltaCoder / TernaryCoder: the respective
    universal code for every range except BitRange (the base single-bit
    overload remains visible, per C++ overload hiding in the reference).
The port's copy of tudocomp_tpu/coders/universal.py.
"""

from __future__ import annotations

import numpy as np

from ..io.bitio import bits_for_arr
from ..meta import Meta
from ..ranges import BitRange, LiteralRange, Range
from .base import Decoder, Encoder


class ASCIICoder:
    @classmethod
    def meta(cls) -> Meta:
        return Meta("coder", "ascii", "Simple ASCII encoding")

    class Encoder(Encoder):
        def encode(self, v, r: Range) -> None:
            if isinstance(r, BitRange):
                self.w.write_int(ord("1") if v else ord("0"), 8)
            elif isinstance(r, LiteralRange):
                self.w.write_int(int(v) & 0xFF, 8)
            else:
                for c in str(int(v)).encode():
                    self.w.write_int(c, 8)
                self.w.write_int(ord(":"), 8)

        def encode_array(self, values, r: Range) -> None:
            values = np.asarray(values, dtype=np.uint64)
            if isinstance(r, BitRange):
                self.w.write_ints(
                    np.where(values != 0, np.uint64(ord("1")), np.uint64(ord("0"))), 8
                )
            elif isinstance(r, LiteralRange):
                self.w.write_ints(values & np.uint64(0xFF), 8)
            else:
                for v in values:
                    self.encode(int(v), r)

        def tokens(self, values, r):
            values = np.asarray(values, dtype=np.uint64)
            if isinstance(r, BitRange):
                from .base import TokenStream

                return TokenStream(
                    np.where(values != 0, np.uint64(ord("1")), np.uint64(ord("0"))),
                    8,
                    None,
                )
            if isinstance(r, LiteralRange):
                from .base import TokenStream

                return TokenStream(values & np.uint64(0xFF), 8, None)
            return None  # decimal text form: scalar fallback

    class Decoder(Decoder):
        def decode(self, r: Range) -> int:
            if isinstance(r, BitRange):
                return 1 if self.r.read_int(8) != ord("0") else 0
            if isinstance(r, LiteralRange):
                return self.r.read_int(8)
            digits = []
            while True:
                c = self.r.read_int(8)
                if ord("0") <= c <= ord("9"):
                    digits.append(chr(c))
                else:
                    break
            return int("".join(digits)) if digits else 0

        def decode_array(self, count: int, r: Range) -> np.ndarray:
            if isinstance(r, BitRange):
                return (self.r.read_ints(count, 8) != ord("0")).astype(np.uint64)
            if isinstance(r, LiteralRange):
                return self.r.read_ints(count, 8)
            return np.array([self.decode(r) for _ in range(count)], dtype=np.uint64)


class BitCoder:
    @classmethod
    def meta(cls) -> Meta:
        return Meta("coder", "bit", "Encoding using range-optimal bit widths")

    Encoder = Encoder
    Decoder = Decoder


class EliasGammaCoder:
    @classmethod
    def meta(cls) -> Meta:
        return Meta("coder", "gamma", "Elias-gamma encoding")

    class Encoder(Encoder):
        def encode(self, v, r: Range) -> None:
            if isinstance(r, BitRange):
                self.w.write_bit(bool(v))
            else:
                self.w.write_elias_gamma(int(v))

        def encode_array(self, values, r: Range) -> None:
            if isinstance(r, BitRange):
                super().encode_array(values, r)
            else:
                self.w.write_elias_gammas(values)

        def tokens(self, values, r):
            if isinstance(r, BitRange):
                return super().tokens(values, r)
            from .base import TokenStream

            values = np.asarray(values, dtype=np.uint64)
            nb = bits_for_arr(values)
            vals2 = np.stack([np.ones(len(values), np.uint64), values], 1).ravel()
            bits2 = np.stack([nb + 1, nb], 1).ravel()
            return TokenStream(vals2, bits2, np.full(len(values), 2, np.int64))

    class Decoder(Decoder):
        def literal_fixed_width(self):
            return None

        def decode(self, r: Range) -> int:
            if isinstance(r, BitRange):
                return self.r.read_bit()
            return self.r.read_elias_gamma()

        def decode_array(self, count: int, r: Range) -> np.ndarray:
            if isinstance(r, BitRange):
                return super().decode_array(count, r)
            return np.array(
                [self.r.read_elias_gamma() for _ in range(count)], dtype=np.uint64
            )


class EliasDeltaCoder:
    @classmethod
    def meta(cls) -> Meta:
        return Meta("coder", "delta", "Elias-delta encoding")

    class Encoder(Encoder):
        def encode(self, v, r: Range) -> None:
            if isinstance(r, BitRange):
                self.w.write_bit(bool(v))
            else:
                self.w.write_elias_delta(int(v))

        def encode_array(self, values, r: Range) -> None:
            if isinstance(r, BitRange):
                super().encode_array(values, r)
            else:
                self.w.write_elias_deltas(values)

        def tokens(self, values, r):
            if isinstance(r, BitRange):
                return super().tokens(values, r)
            from .base import TokenStream

            values = np.asarray(values, dtype=np.uint64)
            nb = bits_for_arr(values)
            nnb = bits_for_arr(nb)
            vals3 = np.stack(
                [np.ones(len(values), np.uint64), nb.astype(np.uint64), values], 1
            ).ravel()
            bits3 = np.stack([nnb + 1, nnb, nb], 1).ravel()
            return TokenStream(vals3, bits3, np.full(len(values), 3, np.int64))

    class Decoder(Decoder):
        def literal_fixed_width(self):
            return None

        def decode(self, r: Range) -> int:
            if isinstance(r, BitRange):
                return self.r.read_bit()
            return self.r.read_elias_delta()

        def decode_array(self, count: int, r: Range) -> np.ndarray:
            if isinstance(r, BitRange):
                return super().decode_array(count, r)
            return np.array(
                [self.r.read_elias_delta() for _ in range(count)], dtype=np.uint64
            )


class TernaryCoder:
    @classmethod
    def meta(cls) -> Meta:
        return Meta("coder", "ternary", "Ternary encoding")

    class Encoder(Encoder):
        def encode(self, v, r: Range) -> None:
            if isinstance(r, BitRange):
                self.w.write_bit(bool(v))
            else:
                self.w.write_ternary(int(v))

        def encode_array(self, values, r: Range) -> None:
            if isinstance(r, BitRange):
                super().encode_array(values, r)
                return
            for v in np.asarray(values).ravel():
                self.w.write_ternary(int(v))

        def tokens(self, values, r):
            if isinstance(r, BitRange):
                return super().tokens(values, r)
            return None

    class Decoder(Decoder):
        def literal_fixed_width(self):
            return None

        def decode(self, r: Range) -> int:
            if isinstance(r, BitRange):
                return self.r.read_bit()
            return self.r.read_ternary()

        def decode_array(self, count: int, r: Range) -> np.ndarray:
            if isinstance(r, BitRange):
                return super().decode_array(count, r)
            return np.array(
                [self.r.read_ternary() for _ in range(count)], dtype=np.uint64
            )


class VbyteCoder:
    """Byte-aligned vbyte coder (id "vbyte").

    NEW capability beyond the reference coder set (BASELINE config 1
    "rle + mtf + vbyte"): integers are stored in the 7-bits-per-byte
    continuation format of util/vbyte.hpp:29-40 (the same bytes rle
    writes for run lengths), literals as raw 8-bit bytes, BitRange as a
    full '0'/'1'-style byte — the stream stays byte-aligned throughout,
    which makes `rle:mtf:encode(vbyte)` a pure streaming byte pipeline.
    """

    @classmethod
    def meta(cls) -> Meta:
        return Meta("coder", "vbyte", "7-bit-per-byte varint encoding")

    class Encoder(Encoder):
        def encode(self, v, r: Range) -> None:
            if isinstance(r, BitRange):
                self.w.write_int(1 if v else 0, 8)
            elif isinstance(r, LiteralRange):
                self.w.write_int(int(v) & 0xFF, 8)
            else:
                v = int(v) - r.min
                while True:
                    b = v & 0x7F
                    v >>= 7
                    self.w.write_int(b | (0x80 if v else 0), 8)
                    if not v:
                        break

        def encode_array(self, values, r: Range) -> None:
            values = np.asarray(values, dtype=np.uint64)
            if isinstance(r, BitRange):
                self.w.write_ints((values != 0).astype(np.uint64), 8)
            elif isinstance(r, LiteralRange):
                self.w.write_ints(values & np.uint64(0xFF), 8)
            else:
                for v in values:
                    self.encode(int(v), r)

        def tokens(self, values, r):
            from .base import TokenStream

            values = np.asarray(values, dtype=np.uint64)
            if isinstance(r, BitRange):
                return TokenStream((values != 0).astype(np.uint64), 8, None)
            if isinstance(r, LiteralRange):
                return TokenStream(values & np.uint64(0xFF), 8, None)
            return None

    class Decoder(Decoder):
        def decode(self, r: Range) -> int:
            if isinstance(r, BitRange):
                return 1 if self.r.read_int(8) else 0
            if isinstance(r, LiteralRange):
                return self.r.read_int(8)
            v = 0
            shift = 0
            while True:
                b = self.r.read_int(8)
                v |= (b & 0x7F) << shift
                shift += 7
                if not (b & 0x80):
                    break
            return v + r.min

        def decode_array(self, count: int, r: Range) -> np.ndarray:
            if isinstance(r, BitRange):
                return (self.r.read_ints(count, 8) != 0).astype(np.uint64)
            if isinstance(r, LiteralRange):
                return self.r.read_ints(count, 8)
            return np.array([self.decode(r) for _ in range(count)], dtype=np.uint64)
