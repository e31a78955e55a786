"""Range hierarchy: encoding hints for coders.

The port's copy of tudocomp_tpu/ranges.py.

Mirror of include/tudocomp/Range.hpp:16-115. Coders dispatch on the range
kind: a plain Range encodes binary in bits_for(max-min) bits, a BitRange is a
single bit, MinDistributedRange hints at skewed distributions (Elias coders
use it), LiteralRange marks literal characters (entropy coders build tables
over these).
"""

from __future__ import annotations

LEN_MAX = 0xFFFFFFFF  # len_compact_t = uint32 (def.hpp:100-104)
SIZE_MAX = 0xFFFFFFFFFFFFFFFF


class Range:
    __slots__ = ("min", "max")

    def __init__(self, a: int, b: int | None = None):
        if b is None:
            self.min, self.max = 0, int(a)
        else:
            self.min, self.max = int(a), int(b)

    @property
    def delta(self) -> int:
        return self.max - self.min

    def __repr__(self):
        return f"{type(self).__name__}({self.min}, {self.max})"


class MinDistributedRange(Range):
    """Values tend towards the minimum (Range.hpp:56)."""


class BitRange(Range):
    """The range {0, 1}; encoded as exactly one bit (Range.hpp:102)."""

    def __init__(self):
        super().__init__(0, 1)


class LiteralRange(Range):
    """Range of uliteral_t (0..255); feeds entropy coder tables."""

    def __init__(self):
        super().__init__(0, 255)


class LengthRange(Range):
    """Range of len_t (0..2^32-1)."""

    def __init__(self):
        super().__init__(0, LEN_MAX)


# Global predefined ranges (Range.hpp:104-115)
size_r = Range(0, SIZE_MAX)
bit_r = BitRange()
literal_r = LiteralRange()
uliteral_r = literal_r
len_r = LengthRange()
