"""ESP D-array codings (type "d_coding") and monotone-subsequence strategies.

Mirrors of the reference's esp/DRCoder.hpp, esp/MonotoneSubsequences.hpp and
esp/SubseqStrategy.hpp:

  - DPlain           (DRCoder.hpp:66-95)    fixed-width values
  - DHuffman         (DRCoder.hpp:12-38)    esp huff2 canonical Huffman over
                                            size_t values (HuffmanCoder.hpp:297-339
                                            table layout: real size, longest,
                                            numl, effective symbols at
                                            bits_for(real-1))
  - DWaveletTree     (DRCoder.hpp:96-152)   levelwise wt_pc wavelet tree
  - DMonotonSubseq   (DRCoder.hpp:153-288)  "succinct": B array as unary
                                            deltas of sorted D, a monotone-
                                            subsequence decomposition (Dpi)
                                            plus direction bits b, and
                                            Dcombined = Dpi ++ Dsi through a
                                            nested dx_coder
  - SubSeqOptimal    (SubseqStrategy.hpp:8-21 over MonotoneSubsequences.hpp:
                      436-468): repeatedly extract the longest increasing or
                      decreasing subsequence (patience sorting LIS)
  - SubSeqGreedy     (SubseqStrategy.hpp:22-169): greedy chain walks from
                      both ends of the remaining list
  - DDiff            (DRCoder.hpp:485-511)  encode_unary_diff with sign bits
  - DRangeFit        (DRCoder.hpp:513-849)  per-position [min,max) windows,
                                            values in bits_for(range) bits,
                                            optional per-run wavelet trees
                                            (wt), threshold smoothing and
                                            zero_min rebasing

All formats are self-consistent within this framework; the stream layout
follows the reference structure so compressed sizes are comparable. The
port's copy of tudocomp_tpu/compressors/esp_dcoding.py: the longest
increasing subsequence runs in the port's C++ host helpers
(tdc_lis_indices), and d_coding=arith decodes its D region in one call of
the C++ decode loop; both write and read the same bits as the JAX package.
"""

from __future__ import annotations

from bisect import bisect_left

import numpy as np

from .. import native
from ..coders.arithmetic import ArithmeticCoder
from ..coders.huffman import gen_codelengths, gen_first_codes
from ..io.bitio import BitReader, BitWriter, bits_for, bits_for_arr
from ..meta import AlgorithmValue, Algorithm, Env, Meta
from ..ranges import literal_r
from ..stats.phase import StatPhase

# ---------------------------------------------------------------------------
# unary-diff codec (DRCoder.hpp:291-483)


def encode_unary_diff(
    w: BitWriter, vec, bit_width: int, diff_bit_width: int, sign: bool
) -> None:
    """encode_unary_diff (DRCoder.hpp:291-437): 1-bit mode flag, then either
    unary |delta| codes (+ sign bits for the nonzero deltas) or an RLE of
    (run_length @ bit_width, value @ diff_bit_width) entries."""
    v = np.asarray(vec, np.int64).ravel()
    n = len(v)
    prev = np.concatenate([[0], v[:-1]]) if n else v
    diff = np.abs(v - prev)
    nz = diff != 0
    bits_unary = n + int(diff.sum()) + int(nz.sum())
    diff_val_counter = int(nz.sum()) + (1 if n > 0 and v[0] == 0 else 0)
    bits_binary = diff_val_counter * (bit_width + diff_bit_width)
    use_unary = bits_unary <= bits_binary
    w.write_bit(use_unary)
    if use_unary:
        w.write_unaries(diff)
        if sign:
            sbits = (v > prev)[nz]
            if len(sbits):
                w.write_ints(sbits.astype(np.uint64), 1)
    elif n:
        change = np.flatnonzero(np.concatenate([[True], v[1:] != v[:-1]]))
        lengths = np.diff(np.concatenate([change, [n]]))
        vals = v[change]
        toks = np.empty(2 * len(vals), np.uint64)
        toks[0::2] = lengths.astype(np.uint64)
        toks[1::2] = vals.astype(np.uint64)
        widths = np.empty(2 * len(vals), np.int64)
        widths[0::2] = bit_width
        widths[1::2] = diff_bit_width
        w.write_ints(toks, widths)


def decode_unary_diff(
    r: BitReader, count: int, bit_width: int, diff_bit_width: int, sign: bool
) -> np.ndarray:
    """decode_unary_diff (DRCoder.hpp:439-483)."""
    count = int(count)
    use_unary = bool(r.read_bit())
    if use_unary:
        diffs = r.read_unaries(count).astype(np.int64)
        if sign:
            nz = diffs != 0
            sbits = r.read_ints(int(nz.sum()), 1).astype(np.int64)
            signs = np.ones(count, np.int64)
            signs[nz] = np.where(sbits == 1, 1, -1)
            return np.cumsum(diffs * signs)
        return np.cumsum(diffs)
    out = np.zeros(count, np.int64)
    i = 0
    while i < count:
        rep = int(r.read_int(bit_width))
        val = int(r.read_int(diff_bit_width))
        out[i : i + rep] = val
        i += rep
    return out


# ---------------------------------------------------------------------------
# wavelet tree level helpers (wt_pc levelwise layout; esp/wt_pc.hpp)


def wt_levels(values, depth: int) -> list[np.ndarray]:
    """Levelwise wt_pc bitvectors: level k lists each element's k-th MSB with
    elements stably ordered by their k-bit prefix."""
    v = np.asarray(values, dtype=np.uint64)
    levels = []
    for k in range(depth):
        prefix = v >> np.uint64(depth - k)
        order = np.argsort(prefix, kind="stable")
        levels.append(((v[order] >> np.uint64(depth - 1 - k)) & np.uint64(1)))
    return levels


def wt_recover(levels: list[np.ndarray], n: int) -> np.ndarray:
    """Inverse of wt_levels (recover_Dxx, MonotoneSubsequences.hpp:657-695)."""
    vals = np.zeros(n, dtype=np.uint64)
    if not levels or n == 0:
        return vals.astype(np.int64)
    pos = np.arange(n, dtype=np.int64)
    for level in levels:
        b = np.asarray(level, np.uint64)[pos]
        vals = (vals << np.uint64(1)) | b
        idx = np.argsort(vals, kind="stable")
        rank = np.empty(n, dtype=np.int64)
        rank[idx] = np.arange(n, dtype=np.int64)
        pos = rank
    return vals.astype(np.int64)


# ---------------------------------------------------------------------------
# simple d_codings


class DPlain(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        return Meta("d_coding", "plain", "Plain D array encoding")

    def encode(self, w, rhs, bit_width, max_value):
        w.write_ints(np.asarray(rhs, np.uint64), bit_width)

    def decode(self, r, count, bit_width, max_value):
        return r.read_ints(count, bit_width).astype(np.int64)


class DDiff(Algorithm):
    """d_coding=diff (DRCoder.hpp:485-511): unary-diff coding of D with sign
    bits (encode_unary_diff with diff_bit_width == bit_width)."""

    @classmethod
    def meta(cls) -> Meta:
        return Meta("d_coding", "diff", "Unary-diff D array encoding")

    def encode(self, w, rhs, bit_width, max_value):
        encode_unary_diff(w, rhs, bit_width, bit_width, True)

    def decode(self, r, count, bit_width, max_value):
        return decode_unary_diff(r, count, bit_width, bit_width, True)


class DWaveletTree(Algorithm):
    """d_coding=wavelet_tree (DRCoder.hpp:96-152): compressed_int(depth) then
    `depth` n-bit level bitvectors in the wt_pc layout."""

    @classmethod
    def meta(cls) -> Meta:
        return Meta("d_coding", "wavelet_tree", "Wavelet tree D array encoding")

    def encode(self, w, rhs, bit_width, max_value):
        values = np.asarray(rhs, dtype=np.uint64)
        depth = int(max_value).bit_length()
        w.write_compressed_int(depth)
        if depth == 0 or len(values) == 0:
            return
        for level in wt_levels(values, depth):
            w.write_ints(level, 1)

    def decode(self, r, count, bit_width, max_value):
        depth = r.read_compressed_int()
        if depth == 0 or count == 0:
            return np.zeros(count, np.int64)
        levels = [r.read_ints(count, 1) for _ in range(depth)]
        return wt_recover(levels, count)


class DHuffman(Algorithm):
    """d_coding=huffman (DRCoder.hpp:12-38): esp huff2 canonical Huffman over
    size_t values. Degenerate alphabets (size <= 1) use a 0 flag bit and raw
    64-bit values (esp/HuffmanCoder.hpp:429-443)."""

    @classmethod
    def meta(cls) -> Meta:
        return Meta("d_coding", "huffman", "Huffman D array encoding")

    def encode(self, w, rhs, bit_width, max_value):
        v = np.asarray(rhs, np.int64)
        counts = np.bincount(v) if len(v) else np.zeros(1, np.int64)
        eff = np.flatnonzero(counts)
        if len(eff) <= 1:
            w.write_bit(0)
            w.write_ints(v.astype(np.uint64), 64)
            return
        w.write_bit(1)
        lengths = gen_codelengths(counts[eff]).astype(np.int64)
        order = np.argsort(lengths, kind="stable")
        ordered_syms = eff[order].astype(np.int64)
        ordered_lengths = lengths[order]
        longest = int(ordered_lengths.max())
        numl = np.bincount(ordered_lengths, minlength=longest + 1)[1:]
        real_size = int(v.max()) + 1
        # table (esp/HuffmanCoder.hpp:297-308)
        w.write_compressed_int(real_size)
        w.write_compressed_int(longest)
        for c in numl:
            w.write_compressed_int(int(c))
        w.write_compressed_int(len(ordered_syms))
        w.write_ints(ordered_syms.astype(np.uint64), bits_for(real_size - 1))
        # canonical codewords in ordered-symbol order
        firstcodes = gen_first_codes(numl, longest)
        cw = np.zeros(len(ordered_syms), np.uint64)
        nextcode = firstcodes.copy()
        for i in range(len(ordered_syms)):
            l = int(ordered_lengths[i]) - 1
            cw[i] = nextcode[l]
            nextcode[l] += 1
        val_to_idx = np.zeros(real_size, np.int64)
        val_to_idx[ordered_syms] = np.arange(len(ordered_syms))
        idx = val_to_idx[v]
        w.write_ints(cw[idx], ordered_lengths[idx])

    def decode(self, r, count, bit_width, max_value):
        if not r.read_bit():
            return r.read_ints(count, 64).astype(np.int64)
        real_size = r.read_compressed_int()
        longest = r.read_compressed_int()
        numl = np.array(
            [r.read_compressed_int() for _ in range(longest)], np.int64
        )
        eff_size = r.read_compressed_int()
        syms = r.read_ints(eff_size, bits_for(real_size - 1)).astype(np.int64)
        firstcodes = gen_first_codes(numl, longest).astype(np.int64)
        # prefix sums: index of first symbol of each length group
        psl = np.concatenate([[0], np.cumsum(numl)[:-1]])
        bits = r._bits
        pos = r.pos
        lib = native.get_lib()
        if lib is not None and count:
            idx = np.empty(count, np.int32)
            pos = lib.tdc_canonical_decode_idx(
                np.ascontiguousarray(bits, np.uint8),
                pos,
                int(r._valid),
                np.ascontiguousarray(firstcodes, np.int64),
                np.ascontiguousarray(psl, np.int64),
                int(longest),
                idx,
                count,
            )
            if pos < 0:
                raise ValueError("truncated esp huffman D stream")
            r._pos = pos
            return syms[idx]
        out = np.zeros(count, np.int64)
        fc = firstcodes.tolist()
        for i in range(count):
            value = 0
            length = 0
            while True:
                value = (value << 1) + int(bits[pos])
                pos += 1
                length += 1
                if value >= fc[length - 1]:
                    break
            out[i] = syms[int(psl[length - 1]) + (value - fc[length - 1])]
        r._pos = pos
        return out


# ---------------------------------------------------------------------------
# monotone subsequence strategies (type "subseq")


def _lis_indices(y: np.ndarray) -> list[int]:
    """Longest strictly increasing subsequence of distinct values y; returns
    indices into y (patience sorting with predecessor links; the C++
    tdc_lis_indices where the host helpers are built, the same loop in
    Python otherwise)."""
    n = len(y)
    lib = native.get_lib()
    if lib is not None:
        out = np.empty(max(n, 1), np.int64)
        k = lib.tdc_lis_indices(np.ascontiguousarray(y, np.int64), n, out)
        return out[:k].tolist()
    tails: list[int] = []  # tail values per layer
    tails_idx: list[int] = []
    prev = [-1] * n
    yl = y.tolist()
    for i in range(n):
        val = yl[i]
        j = bisect_left(tails, val)
        if j == len(tails):
            tails.append(val)
            tails_idx.append(i)
        else:
            tails[j] = val
            tails_idx[j] = i
        prev[i] = tails_idx[j - 1] if j > 0 else -1
    chain = []
    k = tails_idx[-1]
    while k != -1:
        chain.append(k)
        k = prev[k]
    chain.reverse()
    return chain


class SubSeqOptimal(Algorithm):
    """subseq=optimal (MonotoneSubsequences.hpp:436-468): repeatedly extract
    the longest increasing or decreasing subsequence of the remaining sorted
    positions (ties go to increasing)."""

    @classmethod
    def meta(cls) -> Meta:
        return Meta("subseq", "optimal", "Optimal monotone subsequences")

    def create_dpi_and_b(self, sis: np.ndarray):
        n = len(sis)
        Dpi = np.zeros(n, np.int64)
        b: list[int] = []
        alive = np.arange(n)
        y = np.asarray(sis, np.int64)
        while len(alive):
            ya = y[alive]
            inc = _lis_indices(ya)
            dec = _lis_indices(-ya)
            if len(inc) >= len(dec):
                chosen, bit = inc, 0
            else:
                chosen, bit = dec, 1
            Dpi[alive[chosen]] = len(b)
            b.append(bit)
            mask = np.ones(len(alive), bool)
            mask[chosen] = False
            alive = alive[mask]
        return Dpi, np.array(b, np.uint8)


class SubSeqGreedy(Algorithm):
    """subseq=greedy (SubseqStrategy.hpp:22-169): per round, walk the
    remaining doubly-linked list left-to-right collecting a greedy increasing
    chain and right-to-left collecting a greedy decreasing chain; keep the
    longer (ties to increasing)."""

    @classmethod
    def meta(cls) -> Meta:
        return Meta("subseq", "greedy", "Greedy monotone subsequences")

    def create_dpi_and_b(self, sis: np.ndarray):
        n = len(sis)
        y = np.asarray(sis, np.int64).tolist()
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        first, last = 0, n - 1
        remaining = n
        Dpi = np.zeros(n, np.int64)
        b: list[int] = []
        while remaining:
            inc = [first]
            cur = nxt[first]
            while cur < n:
                if y[cur] > y[inc[-1]]:
                    inc.append(cur)
                cur = nxt[cur]
            dec = [last]
            cur = prv[last]
            while cur >= 0:
                if y[cur] > y[dec[-1]]:
                    dec.append(cur)
                cur = prv[cur]
            dec.reverse()
            if len(inc) >= len(dec):
                chosen, bit = inc, 0
            else:
                chosen, bit = dec, 1
            for k in chosen:
                Dpi[k] = len(b)
                p, q = prv[k], nxt[k]
                if p >= 0:
                    nxt[p] = q
                else:
                    first = q
                if q < n:
                    prv[q] = p
                else:
                    last = p
            b.append(bit)
            remaining -= len(chosen)
        return Dpi, np.array(b, np.uint8)


def _recover_D(Dpi, Dsi, b, Bde) -> np.ndarray:
    """recover_D_from_encoding (MonotoneSubsequences.hpp:697-749), vectorized:
    for subsequence s, ascending original positions pair with ascending sorted
    positions when b[s]=0 (increasing) and with descending ones when b[s]=1."""
    Dpi = np.asarray(Dpi, np.int64)
    Dsi = np.asarray(Dsi, np.int64)
    b = np.asarray(b, np.int64)
    n = len(Dpi)
    counts = np.bincount(Dpi, minlength=len(b))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    idx_p = np.argsort(Dpi, kind="stable")  # sorted positions grouped by subseq
    idx_o = np.argsort(Dsi, kind="stable")  # original positions grouped by subseq
    grp = Dsi[idx_o]
    rank_o = np.arange(n) - starts[grp]
    rev = b[grp] == 1
    match = np.where(rev, counts[grp] - 1 - rank_o, rank_o)
    p_for_o = idx_p[starts[grp] + match]
    D = np.zeros(n, np.int64)
    Bde = np.asarray(Bde, np.int64)
    D[idx_o] = Bde[p_for_o]
    return D


class DMonotonSubseq(Algorithm):
    """d_coding=succinct (DRCoder.hpp:153-288)."""

    @classmethod
    def meta(cls) -> Meta:
        m = Meta("d_coding", "succinct", "Monotone-subsequence D encoding")
        m.option("subseq").templated("subseq", "optimal")
        m.option("dx_coder").templated("d_coding", "wavelet_tree")
        return m

    def encode(self, w, rhs, bit_width, max_value):
        v = np.asarray(rhs, np.int64)
        n = len(v)
        with StatPhase("sort D, B unaries"):
            sis = np.argsort(v, kind="stable")
            B = v[sis]
            w.write_unaries(np.diff(np.concatenate([[0], B])))
        subseq = self.env.instantiate("subseq")
        with StatPhase(f"subsequences {subseq.meta().name}") as ph:
            Dpi, b = subseq.create_dpi_and_b(sis)
            ph.log("subsequences", len(b))
        w.write_compressed_int(len(b))
        w.write_ints(b.astype(np.uint64), 1)
        Dsi = np.zeros(n, np.int64)
        Dsi[sis] = Dpi
        dx = self.env.instantiate("dx_coder")
        d_max = len(b) - 1
        with StatPhase(f"dx coding {dx.meta().name}"):
            dx.encode(w, np.concatenate([Dpi, Dsi]), bits_for(d_max), d_max)

    def decode(self, r, count, bit_width, max_value):
        n = int(count)
        Bde = np.cumsum(r.read_unaries(n))
        b_size = r.read_compressed_int()
        b = r.read_ints(b_size, 1).astype(np.uint8)
        dx = self.env.instantiate("dx_coder")
        d_max = b_size - 1
        Dcombined = dx.decode(r, 2 * n, bits_for(d_max), d_max)
        return _recover_D(Dcombined[:n], Dcombined[n:], b, Bde)


# ---------------------------------------------------------------------------
# range-fit (DRCoder.hpp:513-849)


def _perc_diff(a: float, b: float, diff: float) -> bool:
    denom = (a + b) / 2.0
    if denom == 0.0:
        return False  # C++: 0/0 = NaN, NaN <= diff is false
    return abs((a - b) / denom) <= diff


class DRangeFit(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("d_coding", "range_fit", "Range-fit D array encoding")
        m.option("threshold").dynamic("none")
        m.option("wt").dynamic("false")
        m.option("zero_min").dynamic("false")
        return m

    def _opts(self):
        thr_s = self.env.option("threshold").as_string()
        threshold = None if thr_s == "none" else int(thr_s) / 100.0
        use_wt = self.env.option("wt").as_bool()
        zero_min = self.env.option("zero_min").as_bool()
        return threshold, use_wt, zero_min

    def encode(self, w, rhs, bit_width, max_value):
        threshold, use_wt, zero_min = self._opts()
        v = np.asarray(rhs, np.int64)
        size = len(v)
        # suffix minima (DRCoder.hpp:547-560)
        mins = np.minimum.accumulate(v[::-1])[::-1].copy() if size else v.copy()
        if threshold is not None:
            last = 0
            for i in range(size):
                if _perc_diff(float(mins[i]), float(last), threshold):
                    mins[i] = last
                last = int(mins[i])
        if not use_wt:
            maxs = np.maximum.accumulate(v) if size else v
            bit_ranges = np.zeros(size, np.int64)
            last_min_flush = 0
            for i in range(size):
                if zero_min:
                    if bits_for(int(maxs[i]) - int(mins[i])) == bits_for(
                        int(maxs[i])
                    ) and last_min_flush == 0:
                        mins[i] = 0
                    last_min_flush = int(mins[i])
                bit_ranges[i] = bits_for(int(maxs[i]) - int(mins[i]))
            encode_unary_diff(w, mins, bit_width, bit_width, False)
            encode_unary_diff(w, bit_ranges, bit_width, 64, True)
            w.write_ints((v - mins).astype(np.uint64), bit_ranges)
        else:
            maxs = np.maximum.accumulate(v).copy() if size else v.copy()
            if threshold is not None:
                last = float("inf")
                for i in range(size - 1, -1, -1):
                    if last != float("inf") and _perc_diff(
                        float(maxs[i]), float(last), threshold
                    ):
                        maxs[i] = int(last)
                    last = float(maxs[i])
            ranges = np.zeros(size, np.int64)
            last_min_flush = 0
            for i in range(size):
                if zero_min:
                    if bits_for(int(maxs[i]) - int(mins[i])) == bits_for(
                        int(maxs[i])
                    ) and last_min_flush == 0:
                        mins[i] = 0
                    last_min_flush = int(mins[i])
                ranges[i] = int(maxs[i]) - int(mins[i])
            if threshold is not None:
                # backward then forward smoothing (DRCoder.hpp:673-698)
                last = 0
                for i in range(size - 1, -1, -1):
                    if ranges[i] < last and _perc_diff(
                        float(ranges[i]), float(last), threshold
                    ):
                        ranges[i] = last
                    last = int(ranges[i])
                last = 0
                for i in range(size):
                    if ranges[i] < last and _perc_diff(
                        float(ranges[i]), float(last), threshold
                    ):
                        ranges[i] = last
                    last = int(ranges[i])
            encode_unary_diff(w, mins, bit_width, bit_width, False)
            encode_unary_diff(w, ranges, bit_width, bit_width, True)
            # per equal-range chunk: wavelet tree levels with trailing-zero
            # truncation (DRCoder.hpp:703-765)
            i = 0
            while i < size:
                j = i
                while j < size and ranges[j] == ranges[i]:
                    j += 1
                rng = int(ranges[i])
                cv = (v[i:j] - mins[i:j]).astype(np.uint64)
                depth = rng.bit_length()
                cv_size = j - i
                for level in wt_levels(cv, depth):
                    nzl = np.flatnonzero(level)
                    tnull = cv_size - (int(nzl[-1]) + 1 if len(nzl) else 0)
                    w.write_int(tnull, bits_for(cv_size))
                    w.write_ints(level[: cv_size - tnull], 1)
                i = j

    def decode(self, r, count, bit_width, max_value):
        _, use_wt, _ = self._opts()
        size = int(count)
        mins = decode_unary_diff(r, size, bit_width, bit_width, False)
        if not use_wt:
            bit_ranges = decode_unary_diff(r, size, bit_width, 64, True)
            vals = r.read_tokens(bit_ranges).astype(np.int64)
            return vals + mins
        ranges = decode_unary_diff(r, size, bit_width, bit_width, True)
        out = np.zeros(size, np.int64)
        i = 0
        while i < size:
            j = i
            while j < size and ranges[j] == ranges[i]:
                j += 1
            rng = int(ranges[i])
            cv_size = j - i
            depth = rng.bit_length()
            levels = []
            for _ in range(depth):
                tnull = int(r.read_int(bits_for(cv_size)))
                bits = r.read_ints(cv_size - tnull, 1)
                levels.append(
                    np.concatenate([bits, np.zeros(tnull, bits.dtype)])
                )
            out[i:j] = wt_recover(levels, cv_size) + mins[i:j]
            i = j
        return out


class _ByteFeed:
    def __init__(self, b):
        self._b = b

    def chars(self):
        return self._b


class DArith(Algorithm):
    """d_coding=arith — NEW beyond the reference d_coding set (BASELINE
    config 4 "esp + arithmetic coder"): the D array serialized as
    big-endian ceil(bit_width/8)-byte tuples and range-coded with the
    arithmetic coder (coders/arithmetic.py, self-framing codebook +
    sentinel format)."""

    @classmethod
    def meta(cls) -> Meta:
        return Meta("d_coding", "arith", "Arithmetic-coded D array encoding")

    def _coder_env(self):
        """The arithmetic coder's Env, from the registry that selected this
        d_coding."""
        return Env(self.env.registry, AlgorithmValue("arithmetic", {}, type="coder"))

    def encode(self, w, rhs, bit_width, max_value):
        values = np.asarray(rhs, np.uint64)
        nb = max(1, (int(bit_width) + 7) // 8)
        w.write_compressed_int(nb)
        shifts = ((nb - 1 - np.arange(nb)) * 8).astype(np.uint64)
        byts = ((values[:, None] >> shifts[None, :]) & np.uint64(0xFF)).astype(
            np.uint8
        ).ravel()
        enc = ArithmeticCoder.Encoder(self._coder_env(), w, _ByteFeed(byts))
        enc.encode_array(byts, literal_r)
        enc.finalize()

    def decode(self, r, count, bit_width, max_value):
        nb = r.read_compressed_int()
        dec = ArithmeticCoder.Decoder(self._coder_env(), r)
        # the region holds exactly count * nb literals, so the bulk decode
        # reads the same code words as the JAX package's scalar loop, through
        # the U64_MAX sentinel: the embedding stream continues after it
        byts = dec.decode_literals_until_eof().astype(np.uint64)
        if len(byts) != count * nb:
            raise ValueError("corrupt esp container: arith D region length")
        shifts = ((nb - 1 - np.arange(nb)) * 8).astype(np.uint64)
        return (
            (byts.reshape(count, nb) << shifts[None, :]).sum(axis=1).astype(np.int64)
        )
