"""LFS — longest-first substitution compressor (id "lfs_comp").

The port's copy of tudocomp_tpu/compressors/lfs.py. Mirror of
compressors/lfs/LFSCompressor.hpp:28-106 with the enhanced-suffix-array
computing strategy (lfs/ESAStrategy.hpp:15-235) and the literal/length
coding strategy (lfs/EncodeStrategy.hpp:41-269):

  compute:  bucket suffix-array positions by non-overlap-clamped LCP
            length; from longest to shortest, collect the alive
            occurrences of each repeating factor from its LCP interval,
            greedily select non-overlapping ones (>= 2), mark them dead,
            and record dictionary rule (offset, length) + per-occurrence
            symbols (pos, rule, length), finally sorted by position.
  encode:   delta-chain of rule lengths (len_coder, first in uint32_r,
            deltas in Range(first)), rule strings (lit_coder literals),
            then the start string as bit-flagged (literal | rule number in
            Range(#rules)) items.

The computing_strat axis: "esa" (ESAStrategy.hpp) buckets SA positions by
overlap-clamped LCP; "st" (STStrategy.hpp:21-308) walks the suffix tree —
inner nodes binned by string depth, processed longest-first, each node's
occurrence list = the suffixes in its subtree, greedy non-overlap selection
with the min_shorter re-add rule (a node whose tail is dead re-enters the
bin of its longest free prefix when that exceeds the parent depth).
"bst" (BSTStrategy.hpp) walks its own per-node position lists
(`bst_compute_rules` below), and "sim_st" (SimSTStrategy.hpp) runs its own
simulated-suffix-tree pass over SA/LCP intervals (`simst_compute_rules`);
both match the st strategy's selection semantics but are distinct
implementations, mirroring the reference's separate strategy classes.

Where the work runs: lfs_comp needs the sentinel terminator, so TextDS
(on the registry's device) sees the escaped input plus one byte, and the SA
goes to the card from device.SA_MIN_N (256 KiB) of that length, the LCP
from kernel H there. Every strategy reads the int32 arrays through int()
and sorts positions as int64 or Python ints, so the rules are the same
whichever side built them. The strategies and the coding are host Python.
"""

from __future__ import annotations

import heapq

import numpy as np

from ..base import Compressor
from ..ds import flags
from ..ds.suffix_tree import SuffixTree
from ..ds.textds import TextDS
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..literals import NoLiterals, ViewLiterals
from ..meta import Algorithm, Meta
from ..ranges import Range, bit_r, literal_r
from ..stats.phase import StatPhase

UINT_MAX = 0xFFFFFFFF
MIN_LRF = 2


def esa_compute_rules(text: np.ndarray, sa, lcp):
    """ESAStrategy::compute_rules (ESAStrategy.hpp:68-227)."""
    n = len(text)
    max_lcp = 0
    lcp_bins: list[list[int]] = []
    for i in range(1, n):
        li = int(lcp[i])
        if li >= MIN_LRF:
            if max_lcp < li:
                max_lcp = li
                while len(lcp_bins) < max_lcp + 1:
                    lcp_bins.append([])
            dif = abs(int(sa[i - 1]) - int(sa[i]))
            factor_length = min(li, dif)
            j = i - 1
            while j > 0 and int(lcp[j]) > factor_length:
                alt = abs(int(sa[j]) - int(sa[i]))
                if alt > dif:
                    dif = alt
                j -= 1
            factor_length = min(li, dif)
            lcp_bins[factor_length].append(i)

    dictionary: list[tuple[int, int]] = []
    nts: list[tuple[int, int, int]] = []
    if len(lcp_bins) < MIN_LRF:
        return dictionary, nts

    dead = np.zeros(n, dtype=bool)
    sym_num = 0
    for lcp_len in range(len(lcp_bins) - 1, MIN_LRF - 1, -1):
        for b in lcp_bins[lcp_len]:
            starting = []
            i = b
            while i > 0 and int(lcp[i]) >= lcp_len:
                s = int(sa[i - 1])
                if not dead[s] and not dead[s + lcp_len - 1]:
                    starting.append(s)
                i -= 1
            i = b
            while i < n and int(lcp[i]) >= lcp_len:
                s = int(sa[i])
                if not dead[s] and not dead[s + lcp_len - 1]:
                    starting.append(s)
                i += 1
            if len(starting) < 2:
                continue
            starting.sort()
            selected = []
            last = -lcp_len
            for cur in starting:
                if last + lcp_len <= cur:
                    selected.append(cur)
                    last = cur
            if len(selected) < 2:
                continue
            offset = int(sa[b])
            for s in selected:
                dead[s : s + lcp_len] = True
                nts.append((s, sym_num, lcp_len))
            dictionary.append((offset, lcp_len))
            sym_num += 1
    nts.sort()
    return dictionary, nts


def st_compute_rules(text: np.ndarray, sa, lcp, min_lrf: int = MIN_LRF):
    """STStrategy::compute_rules (lfs/STStrategy.hpp:159-308) on the array
    suffix tree: inner nodes in bins by string depth (lexicographic preorder
    within a bin; the reference's unordered child map leaves this order
    unspecified), processed from deepest down to min_lrf."""
    n = len(text)
    st = SuffixTree(sa, lcp)
    ni = st.num_internal
    # SA interval [lb, rb] per internal node: leaf bounds propagated up
    lb = np.full(ni, n + 1, np.int64)
    rb = np.full(ni, -1, np.int64)
    ranks = np.arange(n, dtype=np.int64)
    np.minimum.at(lb, st.leaf_parent, ranks)
    np.maximum.at(rb, st.leaf_parent, ranks)
    for v in np.argsort(-st.sdepth, kind="stable"):
        v = int(v)
        if v == 0:
            continue
        p = int(st.parent[v])
        lb[p] = min(lb[p], lb[v])
        rb[p] = max(rb[p], rb[v])

    bins: dict[int, list[int]] = {}
    preorder = np.lexsort((-st.sdepth, lb))
    max_depth = 0
    for v in preorder:
        d = int(st.sdepth[v])
        if d > 0:
            bins.setdefault(d, []).append(int(v))
            max_depth = max(max_depth, d)

    dead = np.zeros(n, dtype=bool)
    dictionary: list[tuple[int, int]] = []
    nts: list[tuple[int, int, int]] = []
    poscache: dict[int, np.ndarray] = {}

    def select_starting_positions(v: int, length: int, positions):
        """STStrategy.hpp:94-146 incl. the min_shorter re-add rule."""
        selected = []
        min_shorter = 1
        last = -length - 1
        for cur in positions:
            cur = int(cur)
            if (
                last + length <= cur
                and not dead[cur]
                and not dead[cur + length - 1]
            ):
                selected.append(cur)
                last = cur
            if cur < n and not dead[cur] and dead[cur + length - 1]:
                while cur + min_shorter < n and not dead[cur + min_shorter]:
                    min_shorter += 1
        if min_shorter < length and min_shorter >= min_lrf:
            if int(st.sdepth[st.parent[v]]) < min_shorter:
                bins.setdefault(min_shorter, []).append(v)
        return selected

    for i in range(max_depth, min_lrf - 1, -1):
        queue = bins.get(i)
        if not queue:
            continue
        for v in queue:
            pos = poscache.get(v)
            if pos is None:
                pos = np.sort(np.asarray(sa[lb[v] : rb[v] + 1], np.int64))
                poscache[v] = pos
            if len(pos) < 2 or int(pos[-1]) - int(pos[0]) < i:
                continue
            if dead[int(pos[-1])] or dead[int(pos[0])]:
                continue
            sel = select_starting_positions(v, i, pos)
            if len(sel) < 2:
                continue
            dictionary.append((sel[0], i))
            sym = len(dictionary) - 1
            for s in sel:
                nts.append((s, sym, i))
                dead[s : s + i] = True
    nts.sort()
    return dictionary, nts


def _st_children(st):
    """Per-internal-node (internal children, sorted leaf suffixes)."""
    ni = st.num_internal
    kids: list[list[int]] = [[] for _ in range(ni)]
    for v in range(1, ni):
        kids[int(st.parent[v])].append(v)
    leaves: list[list[int]] = [[] for _ in range(ni)]
    for rank in range(st.n):
        leaves[int(st.leaf_parent[rank])].append(int(st.sa[rank]))
    return kids, leaves


def bst_compute_rules(text: np.ndarray, sa, lcp, min_lrf: int = MIN_LRF):
    """BSTStrategy::compute_rules (lfs/BSTStrategy.hpp:135-290): nodes in
    string-depth bins, deepest first; per-node position lists merged from
    the children's remaining lists (children erased after the merge, dead
    leaves dropped at collect time); greedy non-overlapping selection keeps
    the not-selected live positions for the parent. No min_shorter re-add
    (that rule is st/sim_st-only)."""
    n = len(text)
    st = SuffixTree(sa, lcp)
    kids, leaves = _st_children(st)

    bins: dict[int, list[int]] = {}
    preorder = np.argsort(st.sdepth, kind="stable")  # shallow->deep; stable
    max_depth = 0
    for v in preorder:
        d = int(st.sdepth[v])
        if d > 0:
            bins.setdefault(d, []).append(int(v))
            max_depth = max(max_depth, d)

    dead = np.zeros(n, dtype=bool)
    node_begins: dict[int, list[int]] = {}
    dictionary: list[tuple[int, int]] = []
    nts: list[tuple[int, int, int]] = []

    def gather(v: int) -> list[int]:
        pos = node_begins.get(v)
        if pos is not None:
            return pos
        runs = []
        for ch in kids[v]:
            child_bp = node_begins.pop(ch, None)
            if child_bp:
                runs.append(child_bp)
        leaf_bps = sorted(p for p in leaves[v] if not dead[p])
        if leaf_bps:
            runs.append(leaf_bps)
        pos = list(heapq.merge(*runs)) if runs else []
        node_begins[v] = pos
        return pos

    for i in range(max_depth, min_lrf - 1, -1):
        for v in bins.get(i, ()):  # leaves of depth i never enter bins
            pos = gather(v)
            if len(pos) < 2 or pos[-1] - pos[0] < i:
                continue
            if dead[pos[-1]] or dead[pos[0]]:
                continue
            selected: list[int] = []
            not_selected: list[int] = []
            last = -i - 1
            for cur in pos:
                if last + i <= cur and not dead[cur] and not dead[cur + i - 1]:
                    selected.append(cur)
                    last = cur
                elif not dead[cur]:
                    not_selected.append(cur)
            if len(selected) < 2:
                continue
            node_begins[v] = not_selected
            dictionary.append((selected[0], i))
            sym = len(dictionary) - 1
            for s in selected:
                nts.append((s, sym, i))
                dead[s : s + i] = True
    nts.sort()
    return dictionary, nts


def simst_compute_rules(text: np.ndarray, sa, lcp, min_lrf: int = MIN_LRF):
    """SimSTStrategy::compute_rules (lfs/SimSTStrategy.hpp:125-280):
    like bst, per-node lists merged from the children's remainders — but
    with the st-style min_shorter re-add (a node whose occurrences are cut
    short by dead positions re-enters the bin of the longest still-live
    prefix), and the not-selected retention keeps dead positions."""
    n = len(text)
    st = SuffixTree(sa, lcp)
    kids, leaves = _st_children(st)

    bins: dict[int, list[int]] = {}
    preorder = np.argsort(st.sdepth, kind="stable")
    max_depth = 0
    for v in preorder:
        d = int(st.sdepth[v])
        if d > 0:
            bins.setdefault(d, []).append(int(v))
            max_depth = max(max_depth, d)

    dead = np.zeros(n, dtype=bool)
    node_begins: dict[int, list[int]] = {}
    dictionary: list[tuple[int, int]] = []
    nts: list[tuple[int, int, int]] = []

    def gather(v: int) -> list[int]:
        pos = node_begins.get(v)
        if pos is not None:
            return pos
        runs = []
        for ch in kids[v]:
            child_bp = node_begins.pop(ch, None)
            if child_bp:
                runs.append(child_bp)
        leaf_bps = sorted(p for p in leaves[v] if not dead[p])
        if leaf_bps:
            runs.append(leaf_bps)
        pos = list(heapq.merge(*runs)) if runs else []
        node_begins[v] = pos
        return pos

    for i in range(max_depth, min_lrf - 1, -1):
        queue = bins.get(i)
        if not queue:
            continue
        for v in queue:  # queue may grow via the re-add rule
            pos = gather(v)
            if not pos:
                continue
            if len(pos) >= 2 and pos[-1] - pos[0] < i:
                continue
            selected: list[int] = []
            not_selected: list[int] = []
            last = -i - 1
            min_shorter = 1
            for cur in pos:
                if last + i <= cur and not dead[cur] and not dead[cur + i - 1]:
                    selected.append(cur)
                    last = cur
                else:
                    not_selected.append(cur)
                if cur < n and not dead[cur] and dead[cur + i - 1]:
                    while cur + min_shorter < n and not dead[cur + min_shorter]:
                        min_shorter += 1
            if min_shorter < i and min_shorter >= min_lrf:
                if int(st.sdepth[st.parent[v]]) < min_shorter:
                    bins.setdefault(min_shorter, []).append(v)
            if len(selected) < 2:
                continue
            node_begins[v] = not_selected
            dictionary.append((selected[0], i))
            sym = len(dictionary) - 1
            for s in selected:
                nts.append((s, sym, i))
                dead[s : s + i] = True
    nts.sort()
    return dictionary, nts


class ESAStrategy(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("lfs_comp", "esa", "Enhanced suffix array strategy")
        return m


def _make_strategy(ident, doc):
    class S(Algorithm):
        @classmethod
        def meta(cls) -> Meta:
            m = Meta("lfs_comp", ident, doc)
            m.option("min_lrf").dynamic(2)
            return m

    S.__name__ = f"LFS_{ident}"
    return S


class EncodeStrategy(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("lfs_comp_enc", "lfs_enocde_strat", "LFS coding strategy")
        m.option("lfs_lit_coder").templated("coder", "huff")
        m.option("lfs_len_coder").templated("coder", "gamma")
        return m


class LFSCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "lfs_comp", "LFS compression scheme")
        m.needs_sentinel_terminator()
        m.option("computing_strat").templated("lfs_comp", "esa")
        m.option("coding_strat").templated("lfs_comp_enc", "lfs_enocde_strat")
        m.uses_textds(flags.SA | flags.ISA | flags.LCP)
        return m

    def _coders(self, stream, encode: bool, literals=None):
        strat_env = self.env.env_for_option("coding_strat")
        lit_cls, lit_env = strat_env.algorithm_for_option("lfs_lit_coder")
        len_cls, len_env = strat_env.algorithm_for_option("lfs_len_coder")
        if encode:
            return (
                lit_cls.Encoder(lit_env, stream, literals),
                len_cls.Encoder(len_env, stream, NoLiterals()),
            )
        return lit_cls.Decoder(lit_env, stream), len_cls.Decoder(len_env, stream)

    def compress(self, inp: Input, out: Output) -> None:
        text = inp.as_array()
        dictionary: list[tuple[int, int]] = []
        nts: list[tuple[int, int, int]] = []
        strat_av = self.env.option("computing_strat").as_algorithm()
        if len(text) > 1:
            with StatPhase("computing lrfs"):
                ds = TextDS(text, device=self.env.registry.device)
                sa = ds.require_sa()
                lcp = ds.require_lcp()
                if strat_av.name in ("st", "bst", "sim_st"):
                    min_lrf = max(
                        int(strat_av.options.get("min_lrf", MIN_LRF)), 2
                    )
                    compute = {
                        "st": st_compute_rules,
                        "bst": bst_compute_rules,
                        "sim_st": simst_compute_rules,
                    }[strat_av.name]
                    dictionary, nts = compute(text, sa, lcp, min_lrf)
                else:
                    dictionary, nts = esa_compute_rules(text, sa, lcp)

        with StatPhase("encoding input"):
            w = BitWriter()
            lit_coder, len_coder = self._coders(w, True, ViewLiterals(text))
            intrange = Range(0, UINT_MAX)
            if dictionary:
                last_length = dictionary[0][1]
                s_length_r = Range(0, last_length)
                len_coder.encode(last_length, intrange)
                for _, length in dictionary[1:]:
                    len_coder.encode(last_length - length, s_length_r)
                    last_length = length
                len_coder.encode(last_length, s_length_r)
            else:
                len_coder.encode(0, intrange)

            for offset, length in dictionary:
                for k in range(length):
                    lit_coder.encode(int(text[offset + k]), literal_r)

            dict_r = Range(0, len(dictionary))
            pos = 0
            for start, sym, length in nts:
                while pos < start:
                    lit_coder.encode(0, bit_r)
                    lit_coder.encode(int(text[pos]), literal_r)
                    pos += 1
                lit_coder.encode(1, bit_r)
                lit_coder.encode(sym, dict_r)
                pos += length
            while pos < len(text):
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
            delta = int(len_dec.decode(slength_r))
            symbol_length -= delta
            dict_lengths.append(symbol_length)
        dict_lengths.pop()

        dictionary = []
        for ln in dict_lengths:
            dictionary.append(
                bytes(int(lit_dec.decode(literal_r)) & 0xFF for _ in range(ln))
            )
        dict_r = Range(0, len(dictionary))
        outb = bytearray()
        while not lit_dec.eof():
            if lit_dec.decode(bit_r):
                outb += dictionary[int(lit_dec.decode(dict_r))]
            else:
                outb.append(int(lit_dec.decode(literal_r)) & 0xFF)
        out.write(bytes(outb))


def register(registry):
    registry.register(LFSCompressor)
    registry.register(ESAStrategy)
    registry.register(EncodeStrategy)
    for ident, doc in (
        ("st", "Suffix tree strategy"),
        ("bst", "Binary suffix tree strategy"),
        ("sim_st", "Simulated suffix tree strategy"),
    ):
        registry.register(_make_strategy(ident, doc))
