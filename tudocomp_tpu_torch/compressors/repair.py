"""Re-Pair grammar compressor (id "repair").

The port's copy of tudocomp_tpu/compressors/repair.py, host only. Format
mirror of compressors/RePairCompressor.hpp:15-337: repeatedly
replace the most frequent digram (the first to reach the maximal count in
scan order) with a fresh nonterminal until no digram repeats or max_rules
is hit. Stream: rule count (len_r); per rule i two symbols, each as
  0-bit + literal            (terminal)
  1-bit + value in Range(i)  (nonterminal, id offset by 256)
then the start rule symbols in Range(#rules) until EOF. The literal feed
is the remaining text terminals plus rule right-hand-side terminals
(RePairCompressor.hpp:36-83 Literals). Grammar build and expansion run in
the C++ host helpers (csrc/host/tdc_host.cpp) with Python fallbacks.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..coders.base import write_segmented
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..literals import ArrayLiterals
from ..meta import Meta
from ..ranges import Range, bit_r, len_r, literal_r
from ..stats.phase import StatPhase
from .. import native


def repair_build(data: np.ndarray, max_rules: int):
    """Returns (rules_l, rules_r, seq) arrays."""
    n = len(data)
    lib = native.get_lib()
    if lib is not None and n:
        text = np.ascontiguousarray(data, np.uint32).copy()
        cap = n // 2 + 2
        rl = np.empty(cap, np.uint32)
        rr = np.empty(cap, np.uint32)
        seq_len = np.zeros(1, np.int64)
        nr = lib.tdc_repair_build(text, n, max_rules, rl, rr, seq_len)
        return rl[:nr].copy(), rr[:nr].copy(), text[: seq_len[0]].copy()
    # python mirror
    text = list(map(int, data))
    nxt = list(range(1, n + 1))
    rules_l: list[int] = []
    rules_r: list[int] = []
    if max_rules == 0:
        max_rules = 1 << 62
    while len(rules_l) < max_rules and n > 0:
        count: dict[tuple[int, int], int] = {}
        max_di, max_count = None, 0
        i = 0
        while i < n - 1:
            j = nxt[i]
            if j >= n:
                break
            di = (text[i], text[j])
            c = count.get(di, 0) + 1
            count[di] = c
            if c > max_count:
                max_di, max_count = di, c
            i = j
        if max_count <= 1:
            break
        new_sym = 256 + len(rules_l)
        rules_l.append(max_di[0])
        rules_r.append(max_di[1])
        i = 0
        while i < n - 1:
            j = nxt[i]
            if j >= n:
                break
            if (text[i], text[j]) == max_di:
                text[i] = new_sym
                nxt[i] = nxt[j]
            i = nxt[i]
    seq = []
    i = 0
    while i < n:
        seq.append(text[i])
        i = nxt[i]
    return (
        np.array(rules_l, np.uint32),
        np.array(rules_r, np.uint32),
        np.array(seq, np.uint32),
    )


def repair_expand(rules_l, rules_r, seq) -> bytes:
    lib = native.get_lib()
    nrules = len(rules_l)
    if lib is not None:
        cap = max(16, len(seq) * 4)
        while True:
            out = np.empty(cap, np.uint8)
            got = lib.tdc_repair_expand(
                np.ascontiguousarray(rules_l, np.uint32),
                np.ascontiguousarray(rules_r, np.uint32),
                nrules,
                np.ascontiguousarray(seq, np.uint32),
                len(seq),
                out,
                cap,
            )
            if got == -2:
                raise ValueError("invalid repair rule reference")
            if got >= 0:
                return out[:got].tobytes()
            cap *= 4
    out = bytearray()
    for x in seq:
        stack = [int(x)]
        while stack:
            s = stack.pop()
            if s < 256:
                out.append(s)
            else:
                stack.append(int(rules_r[s - 256]))
                stack.append(int(rules_l[s - 256]))
    return bytes(out)


class RePairCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "repair", "Re-Pair compression")
        m.option("coder").templated("coder", "bit")
        m.option("max_rules").dynamic(0)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        data = inp.as_array()
        max_rules = self.env.option("max_rules").as_integer()
        with StatPhase("RePair") as ph:
            rl, rr, seq = repair_build(data, max_rules)
            ph.log("rules", len(rl))
        nr = len(rl)
        # literal feed: start-rule terminals in order, then rule terminals
        g_syms = np.stack([rl, rr], axis=1).ravel() if nr else np.zeros(0, np.uint32)
        lits = np.concatenate([seq[seq < 256], g_syms[g_syms < 256]]).astype(np.uint8)
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        w = BitWriter()
        enc = coder_cls.Encoder(coder_env, w, ArrayLiterals(lits))
        enc.encode(nr, len_r)

        def emit_syms(syms, ranges_max):
            """Each symbol: flag bit + (literal | value in Range(max))."""
            syms = np.asarray(syms, np.uint64)
            is_nt = syms >= 256
            ok = write_segmented(
                w,
                enc,
                [
                    (is_nt.astype(np.uint64), bit_r, np.ones(len(syms), np.int64)),
                    (
                        (syms - 256)[is_nt],
                        np.asarray(ranges_max, np.int64)[is_nt],
                        is_nt.astype(np.int64),
                    ),
                    (syms[~is_nt], literal_r, (~is_nt).astype(np.int64)),
                ],
            )
            if not ok:
                for k, x in enumerate(syms):
                    x = int(x)
                    if x < 256:
                        enc.encode(0, bit_r)
                        enc.encode(x, literal_r)
                    else:
                        enc.encode(1, bit_r)
                        enc.encode(x - 256, Range(int(ranges_max[k])))

        if nr:
            rule_syms = np.stack([rl, rr], axis=1).ravel()
            rule_ranges = np.repeat(np.arange(nr, dtype=np.int64), 2)
            emit_syms(rule_syms, rule_ranges)
        emit_syms(seq, np.full(len(seq), nr, np.int64))
        enc.finalize()
        out.write(w.getvalue())

    def decompress(self, inp: Input, out: Output) -> None:
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        r = BitReader(inp.as_bytes())
        dec = coder_cls.Decoder(coder_env, r)
        num_rules = dec.decode(len_r)
        rl = np.zeros(num_rules, np.uint32)
        rr = np.zeros(num_rules, np.uint32)

        def decode_sym(rmax):
            if dec.decode(bit_r):
                return 256 + dec.decode(Range(rmax))
            return dec.decode(literal_r)

        for i in range(num_rules):
            rl[i] = decode_sym(i)
            rr[i] = decode_sym(i)
        seq = []
        while not dec.eof():
            seq.append(decode_sym(num_rules))
        out.write(repair_expand(rl, rr, np.array(seq, np.uint32)))
