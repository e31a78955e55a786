"""LFS2 compressors (ids "lfs2" and "lfs2bst").

The port's copy of tudocomp_tpu/compressors/lfs2.py. Mirror of
compressors/lfs/LFS2Compressor.hpp:35-640 and its BST variant
LFS2BSTCompressor.hpp:37-638: two-layer longest-first substitution over
suffix-tree nodes. The variants share format and greedy substitution
logic but differ in the suffix-tree backend — lfs2 walks the array ST
(ds/suffix_tree.py over SA+LCP), lfs2bst the online Ukkonen
BinarySuffixTree (ds/binary_suffix_tree.py), whose construction-order
node binning yields different tie-breaking between equal-depth repeats
(hence different, equally valid outputs — as in the reference).

  compute:  bucket internal ST nodes by string depth; from deep to
            shallow, gather each node's subtree occurrence list (merged
            child lists + sorted leaf begins), greedily pick
            non-overlapping "first layer" occurrences (untouched text) and
            "second layer" occurrences (inside an already substituted
            symbol's representative region); record rule (first_occ,
            depth) and mark positions. The `exact` option re-bins nodes
            whose occurrence span is too narrow.
  encode:   delta-chained rule lengths (len coder); rules encoded
            backwards as bit-flagged (literal | second-layer rule) items;
            then the start string as bit-flagged (literal | rule) items.

Where the work runs: both need the sentinel terminator. lfs2 builds TextDS
on the registry's device over the escaped input plus one byte (the SA on
the card from device.SA_MIN_N of that length, the LCP from kernel H
there); lfs2bst builds no suffix array, its Ukkonen tree is host Python.
The walks and the coding are host Python.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..ds import flags
from ..ds.binary_suffix_tree import BinarySuffixTree
from ..ds.suffix_tree import SuffixTree
from ..ds.textds import TextDS
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..literals import ArrayLiterals, NoLiterals
from ..meta import Meta
from ..ranges import Range, bit_r, literal_r
from ..stats.phase import StatPhase

UINT_MAX = 0xFFFFFFFF


def lfs2_compute(text: np.ndarray, sa, lcp, min_lrf: int, exact: bool):
    """Returns (rules [(first_occ, length)], first_layer_nts, fl_offsets,
    second_layer_nts) — per-position arrays sized len(text), 1-based rule
    numbers, 0 = none."""
    n = len(text)
    st = SuffixTree(sa, lcp)
    # children lists
    internal_children: list[list[int]] = [[] for _ in range(st.num_internal)]
    for v in range(1, st.num_internal):
        internal_children[int(st.parent[v])].append(v)
    leaf_begins: list[list[int]] = [[] for _ in range(st.num_internal)]
    for rank in range(n):
        leaf_begins[int(st.leaf_parent[rank])].append(int(sa[rank]))

    max_d = int(st.sdepth.max()) if st.num_internal else 0
    bins: list[list[int]] = [[] for _ in range(max_d + 1)]
    for v in range(1, st.num_internal):
        bins[int(st.sdepth[v])].append(v)

    node_begins: dict[int, list[int]] = {}
    first_layer_nts = np.zeros(n, np.int64)
    fl_offsets = np.zeros(n, np.int64)
    second_layer_nts = np.zeros(n, np.int64)
    second_layer_dead = np.zeros(n, bool)
    rules: list[tuple[int, int]] = []

    for i in range(len(bins) - 1, min_lrf - 1, -1):
        while bins[i]:
            v = bins[i].pop()
            if v not in node_begins:
                occ: list[int] = []
                for c in internal_children[v]:
                    occ.extend(node_begins.pop(c, ()))
                occ.extend(leaf_begins[v])
                occ.sort()
                node_begins[v] = occ
            occ = node_begins[v]
            if not occ:
                continue
            if len(occ) < 2:
                continue
            if occ[-1] - occ[0] < i:
                if exact:
                    min_shorter = occ[-1] - occ[0]
                    pd = int(st.sdepth[int(st.parent[v])])
                    if pd < min_shorter:
                        bins[min_shorter].append(v)
                continue
            _greedy_substitute(
                occ, i, n, rules, first_layer_nts, fl_offsets,
                second_layer_nts, second_layer_dead,
            )

    return rules, first_layer_nts, fl_offsets, second_layer_nts


def _greedy_substitute(occ, i, n, rules, first_layer_nts, fl_offsets,
                       second_layer_nts, second_layer_dead):
    """Shared greedy layer-substitution step (LFS2Compressor.hpp:233-330 /
    LFS2BSTCompressor.hpp:243-305 — identical in both variants)."""
    last = -i
    fl_viable: list[int] = []
    sl_viable: list[int] = []
    for o in occ:
        if last + i <= o:
            if fl_offsets[o] == 0:
                if o + i - 1 < n and fl_offsets[o + i - 1] == 0:
                    fl_viable.append(o)
                    last = o
            else:
                parent_nts = int(first_layer_nts[o - (fl_offsets[o] - 1)])
                p_first, p_len = rules[parent_nts - 1]
                if p_len >= fl_offsets[o] - 1 + i:
                    sl_viable.append(o)
    if fl_viable and len(fl_viable) + len(sl_viable) >= 2:
        rules.append((fl_viable[0], i))
        nts_number = len(rules)
        for o in fl_viable:
            first_layer_nts[o] = nts_number
            fl_offsets[o : o + i] = np.arange(1, i + 1)
        for o in sl_viable:
            parent_nts = int(first_layer_nts[o - (fl_offsets[o] - 1)])
            p_first, _p_len = rules[parent_nts - 1]
            sl_start = p_first + int(fl_offsets[o]) - 1
            sl_end = sl_start + i - 1
            if not second_layer_dead[sl_start] and not second_layer_dead[sl_end]:
                second_layer_nts[sl_start] = nts_number
                second_layer_dead[sl_start : sl_end + 1] = True


def lfs2bst_compute(text: np.ndarray, min_lrf: int):
    """BST-backed LRF computation (LFS2BSTCompressor.hpp:66-310).

    Structurally distinct from lfs2_compute: nodes come from the online
    Ukkonen BinarySuffixTree, binned by string depth in construction-DFS
    preorder and consumed LIFO, so tie-breaking between equal-depth
    repeats follows the reference BST variant's order, not the array ST's.
    No `exact` re-binning (the BST variant has none).
    """
    n = len(text)
    st = BinarySuffixTree(text)

    # preorder string-depth DFS (compute_string_depth :68-93)
    bins: list[list[int]] = [[]]
    stack = [(0, 0)]
    order: list[tuple[int, int]] = []
    while stack:
        v, d = stack.pop()
        if st.get_first_child(v) == 0:
            continue
        order.append((v, d))
        # push children reversed so they pop in first->sibling order
        children = []
        c = st.get_first_child(v)
        while c:
            children.append(c)
            c = st.get_next_sibling(c)
        for c in reversed(children):
            stack.append((c, d + st.get_edge_length(c)))
    for v, d in order:
        if d > 0:
            while d >= len(bins):
                bins.extend([] for _ in range(len(bins)))
            bins[d].append(v)
    max_d = max((d for _v, d in order), default=0)
    bins = bins[: max_d + 1]

    node_begins: dict[int, list[int]] = {}
    first_layer_nts = np.zeros(n, np.int64)
    fl_offsets = np.zeros(n, np.int64)
    second_layer_nts = np.zeros(n, np.int64)
    second_layer_dead = np.zeros(n, bool)
    rules: list[tuple[int, int]] = []

    for i in range(len(bins) - 1, min_lrf - 1, -1):
        while bins[i]:
            v = bins[i].pop()
            if v not in node_begins:
                positions: list[int] = []
                leaf_bps: list[int] = []
                c = st.get_first_child(v)
                while c:
                    if st.get_first_child(c) == 0:
                        leaf_bps.append(st.get_suffix(c))
                    else:
                        child_bp = node_begins.pop(c, None)
                        if child_bp:
                            positions.extend(child_bp)
                    c = st.get_next_sibling(c)
                positions.extend(sorted(leaf_bps))
                positions.sort()
                node_begins[v] = positions
            occ = node_begins[v]
            if len(occ) < 2:
                continue
            if occ[-1] - occ[0] < i:
                continue
            _greedy_substitute(
                occ, i, n, rules, first_layer_nts, fl_offsets,
                second_layer_nts, second_layer_dead,
            )
    return rules, first_layer_nts, fl_offsets, second_layer_nts


class LFS2Compressor(Compressor):
    ID = "lfs2"
    DOC = "lfs2 two-layer longest-first substitution"

    def _compute(self, text, min_lrf, exact):
        ds = TextDS(text, device=self.env.registry.device)
        return lfs2_compute(
            text, ds.require_sa(), ds.require_lcp(), min_lrf, exact
        )

    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", cls.ID, cls.DOC)
        m.needs_sentinel_terminator()
        m.option("min_lrf").dynamic(5)
        m.option("exact").dynamic(0)
        m.option("lfs2_lit_coder").templated("coder", "huff")
        m.option("lfs2_len_coder").templated("coder", "gamma")
        m.uses_textds(flags.SA | flags.LCP)
        return m

    def _coders(self, stream, encode: bool, literals=None):
        lit_cls, lit_env = self.env.algorithm_for_option("lfs2_lit_coder")
        len_cls, len_env = self.env.algorithm_for_option("lfs2_len_coder")
        if encode:
            return (
                lit_cls.Encoder(lit_env, stream, literals),
                len_cls.Encoder(len_env, stream, NoLiterals()),
            )
        return lit_cls.Decoder(lit_env, stream), len_cls.Decoder(len_env, stream)

    def compress(self, inp: Input, out: Output) -> None:
        text = inp.as_array()
        n = len(text)
        min_lrf = self.env.option("min_lrf").as_integer()
        exact = self.env.option("exact").as_integer() > 0
        rules: list[tuple[int, int]] = []
        fl_nts = np.zeros(n, np.int64)
        fl_off = np.zeros(n, np.int64)
        sl_nts = np.zeros(n, np.int64)
        if n >= min_lrf:
            with StatPhase("Computing LRF"):
                rules, fl_nts, fl_off, sl_nts = self._compute(
                    text, min_lrf, exact
                )

        # literal feed: unsubstituted text chars + rule literals
        lits = [text[fl_off == 0]]
        for first, length in rules:
            seg = np.arange(first, first + length)
            seg = seg[seg < n]
            lits.append(text[seg[sl_nts[seg] == 0]])
        literal_feed = ArrayLiterals(np.concatenate(lits) if lits else [])

        with StatPhase("Encoding Comp"):
            w = BitWriter()
            lit_coder, len_coder = self._coders(w, True, literal_feed)
            intrange = Range(0, UINT_MAX)
            if rules:
                last = rules[0][1]
                s_length_r = Range(0, last)
                len_coder.encode(last, intrange)
                for _, length in rules[1:]:
                    len_coder.encode(last - length, s_length_r)
                    last = length
                len_coder.encode(last, s_length_r)
            else:
                len_coder.encode(0, intrange)
            dict_r = Range(0, len(rules))

            # dictionary strings, backwards
            for nts_num in range(len(rules) - 1, -1, -1):
                first, length = rules[nts_num]
                pos = first
                while pos < first + length:
                    if sl_nts[pos] > 0:
                        lit_coder.encode(1, bit_r)
                        lit_coder.encode(int(sl_nts[pos]), dict_r)
                        pos += rules[int(sl_nts[pos]) - 1][1]
                    else:
                        lit_coder.encode(0, bit_r)
                        lit_coder.encode(int(text[pos]), literal_r)
                        pos += 1

            # start string
            pos = 0
            while pos < n:
                if fl_nts[pos] > 0:
                    lit_coder.encode(1, bit_r)
                    lit_coder.encode(int(fl_nts[pos]), dict_r)
                    pos += rules[int(fl_nts[pos]) - 1][1]
                else:
                    lit_coder.encode(0, bit_r)
                    lit_coder.encode(int(text[pos]), literal_r)
                    pos += 1
            lit_coder.finalize()
            len_coder.finalize()
            out.write(w.getvalue())

    def decompress(self, inp: Input, out: Output) -> None:
        r = BitReader(inp.as_bytes())
        lit_dec, len_dec = self._coders(r, False)
        int_r = Range(0, UINT_MAX)
        symbol_length = int(len_dec.decode(int_r))
        slength_r = Range(0, symbol_length)
        dict_lengths = [symbol_length]
        while symbol_length > 0:
            symbol_length -= int(len_dec.decode(slength_r))
            dict_lengths.append(symbol_length)
        dict_lengths.pop()

        D = len(dict_lengths)
        dict_r = Range(0, D)
        dictionary: list[bytes] = [b""] * D
        for i in range(D - 1, -1, -1):
            buf = bytearray()
            size_cur = dict_lengths[i]
            while size_cur > 0:
                if lit_dec.decode(bit_r):
                    num = int(lit_dec.decode(dict_r)) - 1
                    if num < D:
                        buf += dictionary[num]
                        size_cur -= dict_lengths[num]
                    else:
                        break
                else:
                    buf.append(int(lit_dec.decode(literal_r)) & 0xFF)
                    size_cur -= 1
            dictionary[i] = bytes(buf)

        outb = bytearray()
        while not lit_dec.eof():
            if lit_dec.decode(bit_r):
                num = int(lit_dec.decode(dict_r)) - 1
                if num < D:
                    outb += dictionary[num]
            else:
                outb.append(int(lit_dec.decode(literal_r)) & 0xFF)
        out.write(bytes(outb))


class LFS2BSTCompressor(LFS2Compressor):
    ID = "lfs2bst"
    DOC = "lfs2 with binary suffix tree backend"

    def _compute(self, text, min_lrf, exact):
        return lfs2bst_compute(text, min_lrf)


def register(registry):
    registry.register(LFS2Compressor)
    registry.register(LFS2BSTCompressor)
