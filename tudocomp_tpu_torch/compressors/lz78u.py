"""LZ78U compressor (id "lz78u"), SEA'17.

The port's copy of tudocomp_tpu/compressors/lz78u.py. Mirror of
compressors/LZ78UCompressor.hpp:89-385: LZ78-style parse over the suffix
tree where each factor is a tree node; factor labels are strings. The sdsl
cst_sada is replaced by the SA+LCP suffix tree (ds/suffix_tree.py). Per
factor the stream holds
  ref (Range(factor_count)) | sep bit | label
where the label is either a plain 0-terminated string (sep=1) or, above
`threshold`, a factorized sequence of sub-chars / sub-refs with an
optional cut marker (ref 0 + length) and a 0-char terminator (sep=0;
LZ78UCompressor.hpp:156-218). The "streaming" strategy encodes refs with
`coder` and label characters with `string_coder`
(lz78u/StreamingStrategy.hpp); "buffering" buffers the events and codes
them at the end, its string coder fed every label character. Decompression
replays factors with the reference's reverse-buffer expansion
(LZ78UCompressor.hpp:24-86).

Where the work runs: the SA, ISA and LCP come from TextDS on the
registry's device, built over the input as the driver hands it, escaped
and 0-terminated (uses_textds implies the sentinel): a text of n bytes
(with no 0 byte) reaches TextDS as n + 1, and its SA goes to the card from
device.SA_MIN_N (256 KiB) of that length, the ISA from the SA's ranks and
the LCP from kernel H there. The tree, the factorization walk and the
coding are host Python, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..ds import flags
from ..ds.suffix_tree import SuffixTree
from ..ds.textds import TextDS
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..literals import ArrayLiterals, NoLiterals
from ..meta import Algorithm, Meta
from ..ranges import Range, len_r, literal_r
from ..stats.phase import StatPhase


class StreamingStrategy(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("lz78u_strategy", "streaming", "Streaming strategy")
        m.option("string_coder").templated("coder", "ascii")
        return m


class BufferingStrategy(Algorithm):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("lz78u_strategy", "buffering", "Buffering strategy")
        m.option("string_coder").templated("coder", "ascii")
        return m


class LZ78UCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "lz78u", "Lempel-Ziv 78 U")
        m.option("comp").templated("lz78u_strategy", "streaming")
        m.option("coder").templated("coder", "bit")
        m.option("threshold").dynamic(3)
        m.uses_textds(flags.SA | flags.ISA | flags.LCP)
        return m

    def _coders(self, w_or_r, encode: bool):
        ref_cls, ref_env = self.env.algorithm_for_option("coder")
        strat_env = self.env.env_for_option("comp")
        str_cls, str_env = strat_env.algorithm_for_option("string_coder")
        if encode:
            return (
                ref_cls.Encoder(ref_env, w_or_r, NoLiterals()),
                str_cls.Encoder(str_env, w_or_r, NoLiterals()),
            )
        return (
            ref_cls.Decoder(ref_env, w_or_r),
            str_cls.Decoder(str_env, w_or_r),
        )

    def compress(self, inp: Input, out: Output) -> None:
        T = inp.as_array()
        n = len(T)
        threshold = self.env.option("threshold").as_integer()
        with StatPhase("construct suffix tree"):
            ds = TextDS(T, device=self.env.registry.device)
            sa = ds.require_sa()
            isa = ds.require_isa()
            lcp = ds.require_lcp()
            st = SuffixTree(sa, lcp)

        w = BitWriter()
        strat_name = self.env.option("comp").as_algorithm().name
        events: list[tuple[int, int, int]] = []  # (kind, value, range_max)
        if strat_name == "buffering":
            # BufferingStrategy (lz78u/BufferingStrategy.hpp): buffer the
            # event stream; the string coder's literal feed is all label
            # chars, so entropy coders build real tables
            def encode_sep(b):
                events.append((1, 1 if b else 0, 0))

            def encode_char(c):
                events.append((2, int(c), 0))

            def encode_ref_ev(v, rmax):
                events.append((0, int(v), rmax))

            ref_enc = str_enc = None
        else:
            ref_enc, str_enc = self._coders(w, True)

            def encode_sep(b):
                w.write_bit(1 if b else 0)

            def encode_char(c):
                str_enc.encode(int(c), literal_r)

            encode_ref_ev = None

        def encode_ref(v, rmax):
            if encode_ref_ev is not None:
                encode_ref_ev(v, rmax)
            else:
                ref_enc.encode(v, len_r if rmax < 0 else Range(rmax))
        R = np.zeros(st.num_internal, dtype=np.int64)
        state = {"factor_count": 0}

        def output(begin, end, ref):
            while T[end - 1] == 0:
                end -= 1
            encode_ref(int(ref), state["factor_count"])
            if end - begin >= threshold:
                encode_sep(False)
                pos = begin
                while pos < end:
                    path = st.leaf_path(int(isa[pos]))
                    # walk down while internal node already has a factor id
                    parent = 0  # root
                    for nd in path[1:]:
                        if R[nd] != 0:
                            parent = nd
                        else:
                            break
                    depth = int(st.sdepth[parent])
                    if depth < threshold:
                        encode_sep(False)
                        encode_char(T[pos])
                        pos += 1
                    else:
                        encode_sep(True)
                        encode_ref(int(R[parent]), state["factor_count"])
                        pos += depth
                        if pos > end:
                            encode_sep(True)
                            encode_ref(0, state["factor_count"])
                            encode_ref(pos - end, -1)
                encode_sep(False)
                encode_char(0)
            else:
                encode_sep(True)
                for p in range(begin, end):
                    encode_char(T[p])
                encode_char(0)
            state["factor_count"] += 1

        with StatPhase("factorize"):
            pos = 0
            z = 0
            while pos < n - 1:
                rank = int(isa[pos])
                lp = int(st.leaf_parent[rank])
                if lp == 0 or R[lp] != 0:
                    pd = int(st.sdepth[lp])
                    output(pos + pd, pos + pd + 1, int(R[lp]))
                    pos += pd + 1
                    z += 1
                    continue
                path = st.leaf_path(rank)
                parent = 0
                node = None
                for nd in path[1:]:
                    if R[nd] != 0:
                        parent = nd
                    else:
                        node = nd
                        break
                assert node is not None
                begin = pos + int(st.sdepth[parent])
                end = pos + int(st.sdepth[node])
                node_parent = int(st.parent[node])
                output(begin, end, int(R[node_parent]))
                z += 1
                R[node] = z
                pos = end

        if strat_name == "buffering":
            # replay the buffered event stream (BufferingStrategy dtor)
            chars = np.array(
                [v for k, v, _ in events if k == 2], dtype=np.uint8
            )
            ref_cls, ref_env = self.env.algorithm_for_option("coder")
            strat_env = self.env.env_for_option("comp")
            str_cls, str_env = strat_env.algorithm_for_option("string_coder")
            ref_enc = ref_cls.Encoder(ref_env, w, NoLiterals())
            str_enc = str_cls.Encoder(str_env, w, ArrayLiterals(chars))
            for kind, v, rmax in events:
                if kind == 0:
                    ref_enc.encode(v, len_r if rmax < 0 else Range(rmax))
                elif kind == 1:
                    w.write_bit(v)
                else:
                    str_enc.encode(v, literal_r)
        ref_enc.finalize()
        str_enc.finalize()
        out.write(w.getvalue())

    def decompress(self, inp: Input, out: Output) -> None:
        r = BitReader(inp.as_bytes())
        ref_dec, str_dec = self._coders(r, False)

        def decode_sep():
            return bool(r.read_bit())

        def decode_char():
            return int(str_dec.decode(literal_r))

        # factor storage (LZ78UCompressor.hpp:24-66)
        refs: list[int] = [0]  # 1-based; refs[0] unused
        strs: list[bytes] = [b""]
        result = bytearray()

        def expand(index, literals):
            refs.append(index)
            strs.append(bytes(literals))
            buf = bytearray()
            lit = bytes(literals)
            while True:
                buf.extend(reversed(lit))
                if index == 0:
                    break
                lit = strs[index]
                index = refs[index]
            buf.reverse()
            result.extend(buf)

        factor_count = 0
        while not ref_dec.eof():
            ref = int(ref_dec.decode(Range(factor_count)))
            not_factorized = decode_sep()
            if not_factorized:
                s = bytearray()
                while True:
                    c = decode_char()
                    if c == 0:
                        break
                    s.append(c)
                expand(ref, s)
            else:
                rebuilt = bytearray()
                while True:
                    is_sub_char = not decode_sep()
                    if is_sub_char:
                        rebuilt.append(decode_char())
                    else:
                        sub_ref = int(ref_dec.decode(Range(factor_count)))
                        if sub_ref == 0:
                            cut = int(ref_dec.decode(len_r))
                            del rebuilt[len(rebuilt) - cut :]
                        else:
                            prev = sub_ref
                            old_end = len(rebuilt)
                            while prev != 0:
                                s = strs[prev]
                                prev_next = refs[prev]
                                rebuilt.extend(reversed(s))
                                prev = prev_next
                            rebuilt[old_end:] = reversed(rebuilt[old_end:])
                    if rebuilt and rebuilt[-1] == 0:
                        rebuilt.pop()
                        break
                expand(ref, rebuilt)
            factor_count += 1

        result.append(0)  # reference appends '\0'; restriction strips it
        out.write(bytes(result))


def register(registry):
    registry.register(LZ78UCompressor)
    registry.register(StreamingStrategy)
    registry.register(BufferingStrategy)
