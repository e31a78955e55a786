"""Naive suffix tree built by per-suffix insertion (ds/NaivST.hpp:35).

The port's copy of tudocomp_tpu/ds/naiv_st.py, host only. The reference's
simplest suffix-tree backend: every suffix of the sentinel-terminated text
is inserted from the root, walking existing edges, splitting on the first
mismatch and hanging a new leaf — O(n^2) worst case, used where
construction simplicity beats speed. Children hang off per-node dicts
keyed by the edge's first character; accessor surface matches
ds/binary_suffix_tree.py so suffix-tree consumers can swap backends. No
compressor uses it: tests/test_torch_suffix_trees.py holds it to the
binary tree and to the JAX package's copy.
"""

from __future__ import annotations

import numpy as np


class NaivST:
    def __init__(self, text: np.ndarray):
        text = np.ascontiguousarray(text, np.uint8)
        self.text = text
        n = len(text)
        # node arrays; node 0 = root
        self.start = [0]
        self.end = [0]  # end == n for leaves
        self.children: list[dict[int, int]] = [{}]
        self.suffix = [-1]
        self.sdepth = [0]
        for s in range(n):
            self._insert(s, n)

    def _new_node(self, s: int, e: int, sdepth: int, suffix: int = -1) -> int:
        self.start.append(s)
        self.end.append(e)
        self.children.append({})
        self.suffix.append(suffix)
        self.sdepth.append(sdepth)
        return len(self.start) - 1

    def _insert(self, suf: int, n: int) -> None:
        text = self.text
        v = 0
        i = suf
        while True:
            c = int(text[i])
            child = self.children[v].get(c)
            if child is None:
                leaf = self._new_node(i, n, self.sdepth[v] + (n - i), suf)
                self.children[v][c] = leaf
                return
            # walk the edge, looking for a mismatch
            cs, ce = self.start[child], self.end[child]
            k = 0
            while cs + k < ce and i + k < n and text[cs + k] == text[i + k]:
                k += 1
            if cs + k == ce:
                v = child
                i += k
                continue
            # split edge at offset k
            mid = self._new_node(cs, cs + k, self.sdepth[v] + k)
            self.children[v][c] = mid
            self.start[child] = cs + k
            self.children[mid][int(text[cs + k])] = child
            leaf = self._new_node(i + k, n, self.sdepth[mid] + (n - i - k), suf)
            self.children[mid][int(text[i + k])] = leaf
            return

    # -- accessors -----------------------------------------------------------

    def get_first_child(self, v: int) -> int:
        ch = self.children[v]
        return min(ch.values()) if ch else 0

    def child_list(self, v: int) -> list[int]:
        return sorted(self.children[v].values())

    def get_suffix(self, v: int) -> int:
        return self.suffix[v]

    def get_edge_length(self, v: int) -> int:
        return self.end[v] - self.start[v] if v else 0

    def get_tree_size(self) -> int:
        return len(self.start)

    def string_depth(self, v: int) -> int:
        return self.sdepth[v]
