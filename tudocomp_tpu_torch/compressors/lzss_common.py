"""Shared LZSS factor stream format.

Byte-exact mirror of lzss/LZSSCoding.hpp:19-140 (encode_text/decode_text)
and lzss/LZSSFactors.hpp (FactorBuffer min/max bookkeeping):
  header:  n (len_r) | flen_min (Range(n)) | flen_max (Range(n))
           | fdist_max (Range(n))
  factor:  gap-flag bit | [gap length (Range(fdist_max))] | gap literals
           | src (Range(n)) | len (MinDistributedRange(flen_min, flen_max))
  trailer: gap-flag bit + length + literals for text after the last factor.
Empty factor sets keep the reference's INDEX_MAX shortest-factor artifact
(LZSSFactors.hpp:28 m_shortest_factor initialized to INDEX_MAX).

The literal feed for entropy coders is the factor-uncovered text
(lzss/LZSSLiterals.hpp TextLiterals). Encoding is vectorized through
write_segmented; decoding mirrors decode_text with DecodeBackBuffer
(byte-wise factor copy allows overlapping self-referential factors). The
port's copy of tudocomp_tpu/compressors/lzss_common.py.
"""

from __future__ import annotations

import numpy as np

from ..coders.base import write_segmented
from ..literals import ArrayLiterals
from ..ranges import LEN_MAX, MinDistributedRange, Range, bit_r, len_r, literal_r
from ..stats.phase import StatPhase


class Factors:
    """Sorted factor arrays (pos, src, len)."""

    def __init__(self, pos, src, length):
        self.pos = np.asarray(pos, dtype=np.int64)
        self.src = np.asarray(src, dtype=np.int64)
        self.len = np.asarray(length, dtype=np.int64)
        self._covered = None

    def __len__(self):
        return len(self.pos)

    def covered(self, n: int) -> np.ndarray:
        """bool[n]: text positions covered by a factor. Cached — the
        literal feed and encode_text share one sweep (profiling showed the
        duplicated int64 add.at+cumsum pair costing ~0.9 s at 16 MiB)."""
        if self._covered is None or len(self._covered) != n:
            if len(self):
                # factors never overlap, so starts and ends are each
                # unique: plain fancy assignment beats bincount/add.at
                delta = np.zeros(n + 1, dtype=np.int32)
                delta[self.pos] = 1
                delta[np.minimum(self.pos + self.len, n)] -= 1
                self._covered = np.cumsum(delta[:n], dtype=np.int32) > 0
            else:
                self._covered = np.zeros(n, dtype=bool)
        return self._covered

    @property
    def shortest(self) -> int:
        return int(self.len.min()) if len(self) else LEN_MAX

    @property
    def longest(self) -> int:
        return int(self.len.max()) if len(self) else 0


def uncovered_literals(text: np.ndarray, factors: Factors) -> np.ndarray:
    """Characters not covered by any factor, in text order (TextLiterals)."""
    return text[~factors.covered(len(text))]


def encode_text(enc, w, text: np.ndarray, factors: Factors) -> None:
    """lzss::encode_text (LZSSCoding.hpp:19-92), vectorized."""
    n = len(text)
    with StatPhase("Stream columns"):
        flen_min = factors.shortest
        flen_max = factors.longest

        fpos = factors.pos
        flen = factors.len
        nf = len(factors)
        # gap before each factor; trailing gap after the last
        prev_end = np.concatenate([[0], (fpos + flen)])  # [nf+1]
        gaps = np.concatenate([fpos, [n]]) - prev_end  # [nf+1]
        assert (gaps >= 0).all(), "factors overlap or unsorted"
        fdist_max = int(gaps.max()) if len(gaps) else 0

        text_r = Range(n)
        fdist_r = Range(fdist_max)
        flen_r = MinDistributedRange(flen_min, flen_max)

        enc.encode(n, len_r)
        enc.encode(flen_min, text_r)
        enc.encode(flen_max, text_r)
        enc.encode(fdist_max, text_r)

        # literal characters inside the gaps, grouped per segment
        gap_literals = text[~factors.covered(n)]

        has_gap = gaps > 0
        # trailing segment emits flag+gap+literals only when a gap exists
        seg_live = np.ones(nf + 1, dtype=np.int64)
        seg_live[nf] = 1 if gaps[nf] > 0 else 0

        live = seg_live > 0
        gap_in_live = has_gap & live
        lit_counts = np.where(live, gaps, 0)
        factor_seg = np.concatenate([np.ones(nf, np.int64), [0]])
        columns = [
            (has_gap[live].astype(np.uint64), bit_r, seg_live),
            (gaps[gap_in_live], fdist_r, gap_in_live.astype(np.int64)),
            (gap_literals, literal_r, lit_counts),
            (factors.src, text_r, factor_seg),
            (factors.len, flen_r, factor_seg),
        ]

    if not write_segmented(w, enc, columns):
        # scalar fallback (consuming coders without token forms)
        p = 0
        li = 0
        for f in range(nf):
            if fpos[f] == p:
                enc.encode(0, bit_r)
            else:
                enc.encode(1, bit_r)
                enc.encode(int(fpos[f] - p), fdist_r)
            while p < fpos[f]:
                enc.encode(int(text[p]), literal_r)
                p += 1
                li += 1
            enc.encode(int(factors.src[f]), text_r)
            enc.encode(int(flen[f]), flen_r)
            p += int(flen[f])
        if p < n:
            enc.encode(1, bit_r)
            enc.encode(n - p, fdist_r)
            while p < n:
                enc.encode(int(text[p]), literal_r)
                p += 1


def native_stream_parse(dec, n, flen_min, flen_max, fdist_max):
    """C++ parse of the post-header lzss stream (tdc_lzss_stream_parse):
    gap literals placed into a fresh buffer, factors returned as arrays.
    Returns (buffer, cursor, tgt, srcs, lens) or None when the coder or the
    C++ helpers can't serve it."""
    from .. import native

    lib = native.get_lib()
    spt = getattr(dec, "stream_parse_tables", lambda: None)()
    if lib is None or spt is None:
        return None
    use_huff, tables = spt
    if tables is None:
        fc = np.zeros(1, np.uint64)
        psl = np.zeros(1, np.int64)
        syms = np.zeros(1, np.uint8)
        longest = 0
        use_huff = 0
    else:
        fc, psl, syms, longest = tables
    r = dec.r
    data = np.frombuffer(r._data, np.uint8)
    out = np.zeros(max(n, 1), np.uint8)
    cap = max(n, 1)
    tgt = np.empty(cap, np.uint32)
    srcs = np.empty(cap, np.uint32)
    lens = np.empty(cap, np.uint32)
    cursor_out = np.zeros(1, np.int64)
    nf = lib.tdc_lzss_stream_parse(
        data,
        len(data),
        r.pos,
        r._valid,
        n,
        flen_min,
        flen_max,
        fdist_max,
        use_huff,
        fc,
        psl,
        syms,
        longest,
        out,
        tgt,
        srcs,
        lens,
        cursor_out,
    )
    if nf < 0:
        raise ValueError("malformed lzss factor stream")
    r._pos = r._valid  # stream fully consumed
    return out[:n], int(cursor_out[0]), tgt[:nf], srcs[:nf], lens[:nf]


def decode_text(dec) -> np.ndarray:
    """lzss::decode_text with DecodeBackBuffer (LZSSCoding.hpp:94-140)."""
    n = dec.decode(len_r)
    if getattr(getattr(dec, "r", None), "overran", False):
        # the coder's table header or the length field ran past the valid
        # end (reads past EOF return 0 bits) — a truncated container
        raise ValueError("truncated lzss stream: header cut off")
    text_r = Range(n)
    flen_min = dec.decode(text_r)
    flen_max = dec.decode(text_r)
    flen_r = MinDistributedRange(flen_min, flen_max)
    fdist_max = dec.decode(text_r)
    fdist_r = Range(fdist_max)

    parsed = native_stream_parse(dec, n, flen_min, flen_max, fdist_max)
    if parsed is not None:
        from .. import native

        out, cursor, tgt, srcs, lens = parsed
        if cursor != n:
            # a valid stream reconstructs exactly n characters; anything
            # short means the container was truncated mid-stream
            raise ValueError(
                f"truncated lzss stream: decoded {cursor} of {n} characters"
            )
        native.get_lib().tdc_lzss_apply_factors(out, tgt, srcs, lens, len(tgt))
        return out[:cursor]

    out = np.zeros(n, dtype=np.uint8)
    cursor = 0
    while not dec.eof():
        num = dec.decode(fdist_r) if dec.decode(bit_r) else 0
        if num:
            lits = dec.decode_array(num, literal_r)
            out[cursor : cursor + num] = lits
            cursor += num
        if not dec.eof():
            src = dec.decode(text_r)
            ln = dec.decode(flen_r)
            if src + ln <= cursor:
                out[cursor : cursor + ln] = out[src : src + ln]
            else:
                for j in range(ln):  # overlapping copy, byte-wise
                    out[cursor + j] = out[src + j]
            cursor += ln
    if cursor != n:
        raise ValueError(
            f"truncated lzss stream: decoded {cursor} of {n} characters"
        )
    return out[:cursor]


def literal_feed(text: np.ndarray, factors: Factors):
    """LiteralIterator feed of uncovered characters for entropy coders."""
    return ArrayLiterals(uncovered_literals(text, factors))
