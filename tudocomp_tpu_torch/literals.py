"""Literal feeds for entropy coders.

Mirror of include/tudocomp/Literal.hpp:16-68: before encoding begins, an
encoder receives the stream of literals (and their input positions) that it
will be asked to encode, so it can build tables (Huffman tree, k-mer
dictionary...). Here a literal feed is represented as numpy arrays instead
of an iterator, so table construction is vectorized. The port's copy of
tudocomp_tpu/literals.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class NoLiterals:
    """Empty feed (Literal.hpp:37)."""

    def chars(self) -> np.ndarray:
        return np.zeros(0, dtype=np.uint8)

    def positions(self) -> np.ndarray:
        return np.zeros(0, dtype=np.int64)


class ViewLiterals(NoLiterals):
    """Every character of a text view, in order (Literal.hpp:41)."""

    def __init__(self, view):
        self._view = np.asarray(view, dtype=np.uint8)

    def chars(self) -> np.ndarray:
        return self._view

    def positions(self) -> np.ndarray:
        return np.arange(len(self._view), dtype=np.int64)


class ArrayLiterals(NoLiterals):
    """Explicit (chars, positions) feed; used by compressor-specific feeds
    like lzss TextLiterals (compressors/lzss/LZSSLiterals.hpp:11-50)."""

    def __init__(self, chars, positions: Optional[np.ndarray] = None):
        self._chars = np.asarray(chars, dtype=np.uint8)
        self._positions = (
            np.asarray(positions, dtype=np.int64)
            if positions is not None
            else np.arange(len(self._chars), dtype=np.int64)
        )

    def chars(self) -> np.ndarray:
        return self._chars

    def positions(self) -> np.ndarray:
        return self._positions
