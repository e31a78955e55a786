"""Online (Ukkonen) suffix tree with first-child/next-sibling links.

The port's copy of tudocomp_tpu/ds/binary_suffix_tree.py, host only.
Capability mirror of ds/BinarySuffixTree.hpp (the reference's from-scratch
Ukkonen build, itself after the classic plain-English construction): nodes
are numbered in creation order, each node stores the edge (start, end]
leading to it (end == 0 means "open" leaf edge), children hang off a
first_child pointer chained by next_sibling in insertion order, and leaves
carry the suffix index they represent. The node numbering and sibling
order are what make the lfs2bst compressor's greedy substitution order
distinct from the array-ST-backed lfs2.

The text must end with a unique sentinel (the usual 0 terminator) so every
suffix ends at a leaf.
"""

from __future__ import annotations

import numpy as np


class BinarySuffixTree:
    def __init__(self, text: np.ndarray):
        text = np.ascontiguousarray(text, np.uint8)
        self.text = text
        n = len(text)
        cap = 2 * n + 4
        self.first_child = np.zeros(cap, np.int64)
        self.next_sibling = np.zeros(cap, np.int64)
        self.start = np.zeros(cap, np.int64)
        self.end = np.zeros(cap, np.int64)
        self.suffix_link = np.zeros(cap, np.int64)
        self.suffix = np.zeros(cap, np.int64)
        self.n_nodes = 0
        self._build()

    # -- construction ---------------------------------------------------------

    def _create(self, s: int, e: int) -> int:
        v = self.n_nodes
        self.n_nodes += 1
        self.start[v] = s
        self.end[v] = e
        self.first_child[v] = 0
        self.next_sibling[v] = 0
        self.suffix_link[v] = 0
        return v

    def edge_length(self, v: int) -> int:
        if v == 0:
            return 0
        if self.end[v] == 0:  # open leaf edge
            return self._pos - int(self.start[v]) + 1
        return int(self.end[v]) - int(self.start[v])

    def _build(self) -> None:
        text = self.text
        fc, ns = self.first_child, self.next_sibling
        start, end, sl, suf = self.start, self.end, self.suffix_link, self.suffix
        self._create(0, 0)  # root
        self._pos = -1
        remainder = 0
        active_node = 0
        active_edge = 0
        active_length = 0
        current_suffix = 0

        for c in text:
            c = int(c)
            self._pos += 1
            pos = self._pos
            remainder += 1
            last_sl = 0

            def add_sl(v, last):
                if last != 0:
                    sl[last] = v
                return v

            while remainder > 0:
                if active_length == 0:
                    active_edge = c
                # find the child whose edge starts with active_edge
                child = int(fc[active_node])
                prev_sib = child
                found = False
                while child != 0:
                    if int(text[int(start[child])]) == active_edge:
                        found = True
                        break
                    prev_sib = child
                    child = int(ns[child])
                if not found:
                    leaf = self._create(pos, 0)
                    suf[leaf] = current_suffix
                    current_suffix += 1
                    if fc[active_node] == 0:
                        fc[active_node] = leaf
                    else:
                        ns[prev_sib] = leaf
                    last_sl = add_sl(active_node, last_sl)
                else:
                    nxt = child
                    el = self.edge_length(nxt)
                    if active_length >= el:
                        # walk down
                        active_node = nxt
                        active_length -= el
                        active_edge = int(text[pos - active_length])
                        continue
                    if int(text[int(start[nxt]) + active_length]) == c:
                        active_length += 1
                        last_sl = add_sl(active_node, last_sl)
                        break
                    # split the edge
                    split = self._create(
                        int(start[nxt]), int(start[nxt]) + active_length
                    )
                    start[nxt] = int(start[nxt]) + active_length
                    if fc[active_node] == 0 or fc[active_node] == nxt:
                        fc[active_node] = split
                    else:
                        ns[prev_sib] = split
                    fc[split] = nxt
                    ns[split] = ns[nxt]
                    leaf = self._create(pos, 0)
                    ns[nxt] = leaf
                    suf[leaf] = current_suffix
                    current_suffix += 1
                    last_sl = add_sl(split, last_sl)
                remainder -= 1
                if active_node == 0 and active_length > 0:
                    active_length -= 1
                    active_edge = int(text[pos - remainder + 1])
                else:
                    active_node = int(sl[active_node]) if sl[active_node] else 0

    # -- accessors (BinarySuffixTree.hpp:293-327) -----------------------------

    def get_first_child(self, v: int) -> int:
        return int(self.first_child[v])

    def get_next_sibling(self, v: int) -> int:
        return int(self.next_sibling[v])

    def get_suffix(self, v: int) -> int:
        return int(self.suffix[v])

    def get_edge_length(self, v: int) -> int:
        return self.edge_length(v)

    def get_tree_size(self) -> int:
        return self.n_nodes
