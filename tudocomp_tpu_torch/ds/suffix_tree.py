"""Suffix tree topology from SA + LCP.

The port's copy of tudocomp_tpu/ds/suffix_tree.py. Replaces the
reference's sdsl cst_sada wrapper (lz78u/SuffixTree.hpp, and the basis for
ds/SuffixTree.hpp over LCP intervals): internal nodes are lcp-intervals,
built with the classic single stack pass over the suffix array
(Abouelhoda et al. style). Provides the operations lz78u and the lfs
strategies need: parent, string depth, per-leaf ancestor paths
(root -> leaf), and stable internal node ids for side arrays.

The SA and LCP are numpy arrays of any integer dtype: TextDS hands over
int32 arrays whether the card (ds/suffix_array.suffix_array_device, the
LCP from kernel H) or the host (the C++ SA-IS, or the numpy prefix doubling
where g++ is missing) built them; the SA is widened to int64 and every LCP
value is read through int(), so the tree is the same either way.
"""

from __future__ import annotations

import numpy as np


class SuffixTree:
    """Array suffix tree over a 0-terminated text.

    Node 0 is the root. Internal nodes have ids 0..num_internal-1; leaves
    are addressed by SA rank. Leaf string depth is n - sa[rank].
    """

    def __init__(self, sa: np.ndarray, lcp: np.ndarray):
        n = len(sa)
        self.n = n
        self.sa = np.asarray(sa, dtype=np.int64)
        parent = [0]
        sdepth = [0]
        leaf_parent = np.zeros(n, dtype=np.int64)

        # stack entries: (id, sdepth); leaves tagged id = -(rank + 1)
        stack = [(0, 0)]

        def set_parent(entry_id: int, p: int):
            if entry_id < 0:
                leaf_parent[-entry_id - 1] = p
            else:
                parent[entry_id] = p

        for i in range(n):
            l = int(lcp[i]) if i > 0 else 0
            last = None
            while stack[-1][1] > l:
                last = stack.pop()
            top_id, top_d = stack[-1]
            if top_d == l:
                node = top_id
            else:
                node = len(parent)
                parent.append(top_id)
                sdepth.append(l)
                stack.append((node, l))
            if last is not None:
                set_parent(last[0], node)
            leaf_parent[i] = node  # tentative; fixed up if later popped
            stack.append((-(i + 1), n - int(sa[i])))

        self.parent = np.array(parent, dtype=np.int64)
        self.sdepth = np.array(sdepth, dtype=np.int64)
        self.leaf_parent = leaf_parent
        self.num_internal = len(parent)

    def leaf_path(self, rank: int) -> list[int]:
        """Internal nodes on the root->leaf path (root first)."""
        path = []
        v = int(self.leaf_parent[rank])
        while True:
            path.append(v)
            if v == 0:
                break
            v = int(self.parent[v])
        path.reverse()
        return path
