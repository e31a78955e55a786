"""Bit-packed integer vectors and rank/select.

Capability mirror of the reference's container layer (§2.3 of SURVEY.md):
  IntVector        ds/IntVector.hpp — arbitrary-bit-width packed vector
  Rank             ds/Rank.hpp:16 — prefix counts of 1 bits
  Select           ds/Select.hpp:20 — positions of the 1 bits
Arrays are numpy-backed; packing uses vectorized shifts. The port's copy of
tudocomp_tpu/ds/int_vector.py, trimmed to what TextDS's CompressMode and
the textds providers (ds/providers.py) call.
"""

from __future__ import annotations

import numpy as np


def bits_for(n: int) -> int:
    n = int(n)
    return 1 if n == 0 else n.bit_length()


class IntVector:
    """Fixed-width bit-packed integer vector.

    Stores values in a packed uint64 word array, width bits each
    (LSB-first within the word stream, like ds/IntRepr.hpp's layout
    choice — layout is an internal detail here; serialization goes
    through BitWriter/bitpack which are MSB-first format-defining).
    """

    def __init__(self, values=None, width: int | None = None):
        if values is None:
            values = np.zeros(0, np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        if width is None:
            width = bits_for(int(values.max())) if len(values) else 1
        assert 1 <= width <= 64
        self._width = int(width)
        self._n = len(values)
        self._words = self._pack(values, self._width)

    @staticmethod
    def _pack(values: np.ndarray, width: int) -> np.ndarray:
        n = len(values)
        total_bits = n * width
        nwords = (total_bits + 63) // 64
        words = np.zeros(nwords + 1, dtype=np.uint64)
        if n == 0:
            return words
        mask = np.uint64((1 << width) - 1) if width < 64 else np.uint64(2**64 - 1)
        v = values & mask
        bitpos = np.arange(n, dtype=np.uint64) * np.uint64(width)
        w0 = (bitpos >> np.uint64(6)).astype(np.int64)
        off = bitpos & np.uint64(63)
        lo = v << off
        np.bitwise_or.at(words, w0, lo)
        # high spill into the next word
        spill = off.astype(np.int64) + width > 64
        if spill.any():
            sh = np.uint64(64) - off[spill]
            np.bitwise_or.at(words, w0[spill] + 1, v[spill] >> sh)
        return words

    def __len__(self) -> int:
        return self._n

    def to_array(self) -> np.ndarray:
        n, width = self._n, self._width
        if n == 0:
            return np.zeros(0, np.uint64)
        mask = np.uint64((1 << width) - 1) if width < 64 else np.uint64(2**64 - 1)
        bitpos = np.arange(n, dtype=np.uint64) * np.uint64(width)
        w0 = (bitpos >> np.uint64(6)).astype(np.int64)
        off = bitpos & np.uint64(63)
        lo = self._words[w0] >> off
        hi_sh = (np.uint64(64) - off) & np.uint64(63)
        hi = np.where(off > 0, self._words[w0 + 1] << hi_sh, np.uint64(0))
        return (lo | hi) & mask


class Rank:
    """Rank over a bit array (ds/Rank.hpp:16).

    rank1(i) = number of 1 bits in positions [0, i] (inclusive, matching
    the reference's rank convention over Rank::rank1(end)).
    """

    def __init__(self, bits):
        self._cum = np.concatenate([[0], np.cumsum(np.asarray(bits, dtype=bool))])

    def rank1_arr(self, idx) -> np.ndarray:
        return self._cum[np.asarray(idx, dtype=np.int64) + 1]


class Select:
    """Select over a bit array (ds/Select.hpp:20).

    select1(k) = position of the k-th 1 bit (1-based, like the reference).
    """

    def __init__(self, bits):
        self._ones = np.flatnonzero(np.asarray(bits, dtype=bool))

    def select1_arr(self, ks) -> np.ndarray:
        return self._ones[np.asarray(ks, dtype=np.int64) - 1]
