"""Literal feeds for entropy coders.

Mirror of include/tudocomp/Literal.hpp:16-68: before encoding begins, an
encoder receives the stream of literals (and their input positions) that it
will be asked to encode, so it can build tables (Huffman tree, k-mer
dictionary...). Here a literal feed is represented as numpy arrays instead
of an iterator, so table construction is vectorized. The port's copy of
tudocomp_tpu/literals.py.
"""

from __future__ import annotations

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
