"""Encoder/Decoder bases with range-overload dispatch.

Mirror of include/tudocomp/Coder.hpp:14-147: the default `encode(v, Range)`
writes v-min in bits_for(max-min) bits; `encode(v, BitRange)` writes one bit.
Subclasses override per-range behavior. Vectorized `encode_array` /
`decode_array` variants encode whole token streams in one call. The port's
copy of tudocomp_tpu/coders/base.py.
"""

from __future__ import annotations

import numpy as np

from dataclasses import dataclass
from typing import Optional

from .. import native
from ..io.bitio import BitReader, BitWriter, bits_for, bits_for_arr
from ..meta import Algorithm, Env
from ..ranges import BitRange, Range
from ..stats.phase import StatPhase


@dataclass
class TokenStream:
    """Flattened (value, nbits) tokens for n logical values.

    `counts` gives tokens-per-value (None = exactly one token per value);
    multi-token codes (gamma = 2 tokens, delta = 3) flatten row-major."""

    values: np.ndarray  # uint64 token values
    nbits: "np.ndarray | int"  # per-token widths (or scalar)
    counts: Optional[np.ndarray]  # tokens per logical value, None -> 1

    def n_values(self) -> int:
        if self.counts is None:
            return len(self.values)
        return len(self.counts)

    def expand(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (values, nbits, counts) with nbits/counts materialized."""
        nb = self.nbits
        if np.isscalar(nb):
            nb = np.full(len(self.values), nb, dtype=np.int64)
        cnt = self.counts
        if cnt is None:
            cnt = np.ones(len(self.values), dtype=np.int64)
        return self.values, nb, cnt


def write_interleaved(w: BitWriter, streams: list[TokenStream]) -> None:
    """Write several per-value token columns interleaved row-wise.

    For n logical values and streams s0..sk, emits s0's tokens for value 0,
    then s1's for value 0, ..., then s0's for value 1, etc. — reproducing
    the scalar loop `for i: enc.encode(a[i], ..); enc.encode(b[i], ..)`."""
    parts = [s.expand() for s in streams]
    n = parts[0][2].shape[0] if parts else 0
    for v, nb, cnt in parts:
        assert cnt.shape[0] == n
    total_counts = sum(p[2] for p in parts)
    row_starts = np.cumsum(total_counts) - total_counts  # exclusive
    all_vals = []
    all_bits = []
    all_pos = []
    for si, (v, nb, cnt) in enumerate(parts):
        # position of this stream's tokens: row_start + offset of earlier
        # streams in the same row + intra-stream token index
        before = sum(parts[sj][2] for sj in range(si)) if si else 0
        starts = row_starts + (before if si else 0)
        tok_rows = np.repeat(np.arange(n, dtype=np.int64), cnt)
        intra = np.arange(len(v), dtype=np.int64) - np.repeat(
            np.cumsum(cnt) - cnt, cnt
        )
        all_pos.append(starts[tok_rows] + intra)
        all_vals.append(v)
        all_bits.append(nb)
    pos = np.concatenate(all_pos)
    vals = np.concatenate(all_vals)
    bits = np.concatenate(all_bits)
    order = np.argsort(pos, kind="stable")
    w.write_ints(vals[order], bits[order])


def write_segmented(w: BitWriter, enc: "Encoder", columns) -> bool:
    """Vectorized emit of a segmented token layout.

    `columns` is a list of (values, r, seg_counts) in intra-segment order:
    segment f consists of seg_counts_0[f] values of column 0, then
    seg_counts_1[f] of column 1, etc. (all seg_counts share length S).
    Reproduces the scalar loop `for f: for c: for v in col c of f:
    enc.encode(v, r_c)` in one vectorized pack. Returns False if any column
    has no token form (caller falls back to scalar encoding).
    """
    with StatPhase("Tokens"):
        parts = []
        for values, r, seg_counts in columns:
            values = np.asarray(values)
            ts = enc.tokens(values, r)
            if ts is None:
                return False
            parts.append((ts.expand(), np.asarray(seg_counts, dtype=np.int64)))
    if not parts:
        return True
    with StatPhase("Pack bits"):
        _pack_segmented(w, parts)
    return True


def _pack_segmented(w: BitWriter, parts) -> None:
    """write_segmented's second half: interleave the columns' expanded
    tokens segment by segment and write them."""
    S = len(parts[0][1])

    lib = native.get_lib()
    if lib is not None:
        C = len(parts)
        vals = np.concatenate([p[0][0] for p in parts], dtype=np.uint64)
        bits = np.concatenate([p[0][1] for p in parts], dtype=np.int64)
        cnts = np.concatenate([p[0][2] for p in parts], dtype=np.int64)
        tok_off = np.zeros(C + 1, np.int64)
        val_off = np.zeros(C + 1, np.int64)
        np.cumsum([len(p[0][0]) for p in parts], out=tok_off[1:])
        np.cumsum([len(p[0][2]) for p in parts], out=val_off[1:])
        sc = np.concatenate([p[1] for p in parts], dtype=np.int64)  # [C, S]
        out_vals = np.empty(len(vals), np.uint64)
        out_bits = np.empty(len(vals), np.int64)
        got = lib.tdc_segment_interleave(
            vals, bits, tok_off, cnts, val_off, sc, C, S, out_vals, out_bits
        )
        assert got == len(vals), "segment interleave metadata mismatch"
        w.write_ints(out_vals, out_bits, masked=True)  # masked natively
        return

    # per-column: cumulative token counts by value, segment starts in values
    col_data = []
    for (v, nb, cnt), sc in parts:
        cs = np.concatenate([[0], np.cumsum(cnt)])  # tokens before value i
        vstart = np.concatenate([[0], np.cumsum(sc)])  # first value of seg f
        tokens_per_seg = cs[vstart[1:]] - cs[vstart[:-1]]
        col_data.append((v, nb, cnt, cs, vstart, tokens_per_seg, sc))

    total_per_seg = sum(cd[5] for cd in col_data)
    seg_off = np.concatenate([[0], np.cumsum(total_per_seg)])[:-1]

    total_tokens = int(sum(len(cd[0]) for cd in col_data))
    out_vals = np.zeros(total_tokens, dtype=np.uint64)
    out_bits = np.zeros(total_tokens, dtype=np.int64)

    col_start = seg_off
    for v, nb, cnt, cs, vstart, tps, sc in col_data:
        n_vals = len(cnt)
        if n_vals:
            val_of_tok = np.repeat(np.arange(n_vals, dtype=np.int64), cnt)
            seg_of_val = np.repeat(np.arange(S, dtype=np.int64), sc)
            seg_of_tok = seg_of_val[val_of_tok]
            tok_idx = np.arange(len(v), dtype=np.int64)
            pos = col_start[seg_of_tok] + (tok_idx - cs[vstart[seg_of_tok]])
            out_vals[pos] = v
            out_bits[pos] = nb
        col_start = col_start + tps
    w.write_ints(out_vals, out_bits)


class Encoder(Algorithm):
    def __init__(self, env: Env, writer: BitWriter, literals):
        super().__init__(env)
        self.w = writer
        self.literals = literals

    def encode(self, v, r: Range) -> None:
        if isinstance(r, BitRange):
            self.w.write_bit(bool(v))
        else:
            self.w.write_int(int(v) - r.min, bits_for(r.delta))

    def encode_array(self, values, r: Range) -> None:
        """Vectorized encode of many values with the same range."""
        values = np.asarray(values, dtype=np.uint64)
        if isinstance(r, BitRange):
            self.w.write_ints(values, 1)
        else:
            self.w.write_ints(values - np.uint64(r.min), bits_for(r.delta))

    def finalize(self) -> None:
        """Called after the last encode (destructor analogue). Consuming
        coders (arithmetic/SLE) flush their buffers here."""

    def tokens(self, values, r) -> "TokenStream | None":
        """Token representation of encoding `values` under range `r`.

        `r` is a Range, or a numpy array of per-value maxima meaning
        Range(0, r[i]) (the growing-range pattern of lz78/lzw). Returns a
        TokenStream, or None if this coder has no vectorizable token form
        (caller falls back to scalar encode calls). Token streams from
        several columns can be interleaved per-row with write_interleaved,
        reproducing the exact scalar interleaving of the reference."""
        values = np.asarray(values, dtype=np.uint64)
        if isinstance(r, np.ndarray):
            return TokenStream(values, bits_for_arr(r), None)
        if isinstance(r, BitRange):
            return TokenStream(values.astype(np.uint64), 1, None)
        return TokenStream(
            values - np.uint64(r.min), bits_for(r.delta), None
        )


class Decoder(Algorithm):
    def __init__(self, env: Env, reader: BitReader):
        super().__init__(env)
        self.r = reader

    def eof(self) -> bool:
        return self.r.eof()

    def decode(self, r: Range) -> int:
        if isinstance(r, BitRange):
            return self.r.read_bit()
        return r.min + self.r.read_int(bits_for(r.delta))

    def decode_array(self, count: int, r: Range) -> np.ndarray:
        if isinstance(r, BitRange):
            return self.r.read_ints(count, 1)
        if type(self).decode is not Decoder.decode:
            from ..ranges import LiteralRange

            if isinstance(r, LiteralRange) and self.literal_fixed_width() is None:
                # subclass decodes literals with variable-width codes
                return np.array(
                    [self.decode(r) for _ in range(count)], dtype=np.uint64
                )
        return self.r.read_ints(count, bits_for(r.delta)) + np.uint64(r.min)

    def literal_fixed_width(self) -> int | None:
        """Bits per literal_r symbol if fixed (enables bulk decode), else None."""
        return 8

    def stream_parse_tables(self):
        """Support marker for the C++ lzss stream parse
        (tdc_lzss_stream_parse): (0, None) when all ranges decode as plain
        binary with raw 8-bit literals (the bit coder), (1, tables) for
        canonical-Huffman literals (huffman.py override), None when the
        coder uses other universal codes (gamma/delta/ternary/ascii/...)."""
        if type(self).decode is Decoder.decode:
            return (0, None)
        return None
