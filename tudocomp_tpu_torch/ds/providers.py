"""Alternative text-ds providers: SparseISA, CompressedLCP (Sada).

Capability mirror of ds/SparseISA.hpp:16 (sampled inverse suffix array via
cycle-decomposition shortcuts + Rank) and ds/CompressedLCP.hpp:16 /
ds/LCPSada.hpp:62-201 (Fischer WeeLCP: PLCP as a 2n-bit unary-delta
bitvector answered with Select). These trade query time for space, like
the reference's compressed TextDS providers. The port's copy of
tudocomp_tpu/ds/providers.py, trimmed to what TextDS calls.
"""

from __future__ import annotations

import numpy as np

from .int_vector import Rank, Select


class SparseISA:
    """ISA via SA cycle walking with sampled shortcuts (ds/SparseISA.hpp).

    Every `t`-th element of each SA cycle stores its inverse directly
    ("shortcut"); a query walks the cycle forward until a shortcut is hit.
    """

    def __init__(self, sa: np.ndarray, t: int = 16):
        sa = np.ascontiguousarray(sa, dtype=np.int64)
        n = len(sa)
        self.sa = sa
        self.t = t
        from .. import native

        lib = native.get_lib()
        if lib is not None and n and hasattr(lib, "tdc_sparse_isa_build"):
            has_u8 = np.empty(n, np.uint8)
            val = np.empty(n, np.int64)
            lib.tdc_sparse_isa_build(sa, n, int(t), has_u8, val)
            has_shortcut = has_u8.astype(bool)
            order = np.flatnonzero(has_shortcut)
            shortcuts = val[order]
        else:
            has_shortcut = np.zeros(n, dtype=bool)
            shortcut_val = {}
            visited = np.zeros(n, dtype=bool)
            for start in range(n):
                if visited[start]:
                    continue
                # walk the cycle of the permutation
                cycle = []
                j = start
                while not visited[j]:
                    visited[j] = True
                    cycle.append(j)
                    j = int(sa[j])
                L = len(cycle)
                for k in range(0, L, t):
                    pos = cycle[k]
                    has_shortcut[pos] = True
                    # jump t cycle steps backward (wraps on short cycles)
                    shortcut_val[pos] = cycle[(k - t) % L]
            order = np.flatnonzero(has_shortcut)
            shortcuts = (
                np.array([shortcut_val[p] for p in order], np.int64)
                if len(order)
                else np.zeros(0, np.int64)
            )
        self._has = has_shortcut
        self._rank = Rank(has_shortcut)
        self._shortcuts = (
            shortcuts if len(order) else np.zeros(0, np.int64)
        )

    def to_array_via_queries(self) -> np.ndarray:
        """Materialize ISA by answering every query through the sparse
        structure (isa(i) for all i at once: walk forward to the nearest
        shortcut, jump back t steps, finish forward) — the structure,
        not the trivial inverse permutation, produces the result. Each
        walk is bounded by t steps (shortcuts every t-th cycle element)."""
        n = len(self.sa)
        if n == 0:
            return np.zeros(0, np.int64)
        j = np.arange(n, dtype=np.int64)
        for _ in range(self.t):
            miss = ~self._has[j]
            if not miss.any():
                break
            j[miss] = self.sa[j[miss]]
        x = self._shortcuts[self._rank.rank1_arr(j) - 1]
        i = np.arange(n, dtype=np.int64)
        for _ in range(self.t + 1):
            miss = self.sa[x] != i
            if not miss.any():
                break
            x[miss] = self.sa[x[miss]]
        return x


class CompressedLCP:
    """Sada-style PLCP: unary-delta bitvector of 2n bits + Select
    (ds/CompressedLCP.hpp, ds/LCPSada.hpp construct_plcp_bitvector).

    bit stream: for i in 0..n-1, (plcp[i] - plcp[i-1] + 1) zeros then a
    one; plcp[i] = select1(i+1) - 2i - 1.
    """

    def __init__(self, plcp: np.ndarray):
        plcp = np.asarray(plcp, dtype=np.int64)
        n = len(plcp)
        self.n = n
        deltas = np.empty(n, dtype=np.int64)
        if n:
            deltas[0] = plcp[0] + 1
            deltas[1:] = plcp[1:] - plcp[:-1] + 1
        # bitvector: deltas[i] zeros followed by a 1, per position
        nbits = int(deltas.sum()) + n
        bits = np.zeros(nbits, dtype=bool)
        ones_pos = np.cumsum(deltas + 1) - 1
        bits[ones_pos] = True
        self._select = Select(bits)

    def plcp_array(self) -> np.ndarray:
        i = np.arange(self.n, dtype=np.int64)
        return self._select.select1_arr(i + 1) - 2 * i - 1
