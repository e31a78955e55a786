"""Canonical Huffman tables in tudocomp's format (HuffmanCoder.hpp), plain Python.

The code lengths merge the two least frequent nodes first, ties broken by
the order in which nodes were made (the leaves by symbol): a frozen copy
of the port's host `gen_codelengths`, whose lengths tudocomp's in-place
algorithm gives. The symbols are then ordered by length, ties by symbol;
the first code of each length follows firstcode[l - 1] = (firstcode[l] +
numl[l]) / 2 from the longest down, and codes are handed out in that order.

The table a stream carries: bit 1, compressed_int(longest), numl[1 ..
longest] as compressed ints, compressed_int(alphabet size), each symbol in
8 bits in that order. An alphabet of at most one symbol writes bit 0 and
its literals raw in 8 bits.
"""

from __future__ import annotations

import heapq

import numpy as np

from .bitstream import compressed_int


def code_lengths(counts) -> np.ndarray:
    """Code lengths of symbols with counts > 0 (at least two)."""
    sigma = len(counts)
    heap = [(int(c), i) for i, c in enumerate(counts)]
    heapq.heapify(heap)
    parent = [0] * (2 * sigma)
    nxt = sigma
    while len(heap) > 1:
        c1, a = heapq.heappop(heap)
        c2, b = heapq.heappop(heap)
        parent[a] = parent[b] = nxt
        heapq.heappush(heap, (c1 + c2, nxt))
        nxt += 1
    root = heap[0][1]
    depth = [0] * (2 * sigma)
    for node in range(nxt - 1, -1, -1):
        if node != root:
            depth[node] = depth[parent[node]] + 1
    return np.array(depth[:sigma], np.int64)


class Table:
    """A literal table from a 256-entry histogram: `code` and `length` per
    byte value (0 where absent) and the table's header tokens."""

    def __init__(self, counts):
        counts = np.asarray(counts, np.int64)
        present = np.flatnonzero(counts)
        self.code = np.zeros(256, np.int64)
        self.length = np.zeros(256, np.int64)
        if len(present) <= 1:
            self.code[:] = np.arange(256)
            self.length[:] = 8
            self.header = [(0, 1)]
            return
        lengths = code_lengths(counts[present])
        order = np.lexsort((present, lengths))
        syms, lens = present[order], lengths[order]
        longest = int(lens.max())
        numl = np.bincount(lens, minlength=longest + 1)[1:]
        first = [0] * longest
        for l in range(longest - 1, 0, -1):
            first[l - 1] = (first[l] + int(numl[l])) // 2
        nextcode = list(first)
        for s, l in zip(syms.tolist(), lens.tolist()):
            self.code[s] = nextcode[l - 1]
            self.length[s] = l
            nextcode[l - 1] += 1
        head = [(1, 1)] + compressed_int(longest)
        for c in numl.tolist():
            head += compressed_int(c)
        head += compressed_int(len(syms))
        head += [(int(s), 8) for s in syms]
        self.header = head
