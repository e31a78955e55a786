"""LZ78 compressor (id "lz78").

The port's copy of tudocomp_tpu/compressors/lz78.py. Format mirror of
compressors/LZ78Compressor.hpp:42-159: a streaming trie parse; factor i
emits (parent_id encoded in Range(0, i), literal in literal_r); a trailing
partial factor re-emits (parent(node), last char). Decompression replays
(index, literal) pairs, expanding each factor by back-walking the implicit
parent chain (LZ78Compressor.hpp:16-38).

The trie parse runs in the port's C++ host helpers (csrc/host/tdc_host.cpp,
open-addressing (parent,char)->id hash trie, the analogue of the
reference's HashTrie/squeeze_node), with a Python fallback. The registry
exposes the lz78trie axis for parity; trie choice affects only speed,
never the bitstream, so every choice takes this one parse. Under
blockwise, the batch hook parses all blocks on the registry's device
(kernel E, ops/lz78_cuda.py) where device.use_parse_device says so.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..coders.base import write_interleaved
from ..io.bitio import BitReader, BitWriter, bits_for_arr
from ..io.inout import Input, Output
from ..literals import NoLiterals
from ..meta import Meta
from ..ranges import Range, literal_r
from ..stats.phase import StatPhase
from .. import native
from ..device import use_parse_device
from ..ops.lz78_cuda import lz78_parse_blocks_device


def lz78_parse(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Parse into (parents, chars) factor arrays."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint8)
    lib = native.get_lib()
    if lib is not None:
        parents = np.empty(n, dtype=np.uint32)
        chars = np.empty(n, dtype=np.uint8)
        nf = lib.tdc_lz78_parse(data, n, parents, chars)
        return parents[:nf].copy(), chars[:nf].copy()
    # pure-Python fallback
    trie: dict[tuple[int, int], int] = {}
    parents: list[int] = []
    chars: list[int] = []
    node_parent = [0]
    node_char = [0]
    node = 0
    next_id = 1
    c = 0
    for c in data:
        c = int(c)
        key = (node, c)
        child = trie.get(key)
        if child is None:
            trie[key] = next_id
            node_parent.append(node)
            node_char.append(c)
            parents.append(node)
            chars.append(c)
            next_id += 1
            node = 0
        else:
            node = child
    if node != 0:
        parents.append(node_parent[node])
        chars.append(node_char[node])
    return np.array(parents, np.uint32), np.array(chars, np.uint8)


def lz78_expand(parents: np.ndarray, chars: np.ndarray) -> np.ndarray:
    """Expand factors back to text."""
    nf = len(parents)
    if nf == 0:
        return np.zeros(0, np.uint8)
    parents = np.ascontiguousarray(parents, np.uint32)
    chars = np.ascontiguousarray(chars, np.uint8)
    # factor lengths: len(i) = len(parent)+1 (parent < i+1 always)
    flen = np.zeros(nf + 1, dtype=np.int64)
    for f in range(nf):
        flen[f + 1] = flen[parents[f]] + 1
    total = int(flen[1:].sum())
    lib = native.get_lib()
    out = np.empty(total, dtype=np.uint8)
    if lib is not None:
        got = lib.tdc_lz78_decode(parents, chars, nf, out, total)
        assert got == total
        return out
    pos = 0
    for f in range(nf):
        ln = int(flen[f + 1])
        p = pos + ln - 1
        out[p] = chars[f]
        k = int(parents[f])
        while k != 0:
            p -= 1
            out[p] = chars[k - 1]
            k = int(parents[k - 1])
        pos += ln
    return out


class LZ78Compressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "lz78", "Lempel-Ziv 78")
        m.option("coder").templated("coder", "bit")
        m.option("lz78trie").templated("lz78trie", "ternary")
        m.option("dict_size").dynamic(0)
        return m

    def _encode_factors(self, parents: np.ndarray, chars: np.ndarray) -> bytes:
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        w = BitWriter()
        enc = coder_cls.Encoder(coder_env, w, NoLiterals())
        nf = len(parents)
        maxes = np.arange(nf, dtype=np.uint64)  # Range(factor_count)
        t1 = enc.tokens(parents.astype(np.uint64), maxes)
        t2 = enc.tokens(chars, literal_r)
        if t1 is not None and t2 is not None:
            write_interleaved(w, [t1, t2])
        else:
            for i in range(nf):
                enc.encode(int(parents[i]), Range(0, i))
                enc.encode(int(chars[i]), literal_r)
        enc.finalize()
        return w.getvalue()

    def compress(self, inp: Input, out: Output) -> None:
        data = inp.as_array()
        # the reference parses dict_size but its reset path is flagged
        # broken (LZ78Compressor.hpp:110-112 "currently broken") — reject
        # a non-default value instead of silently accepting it
        if int(self.env.option("dict_size").as_integer()) != 0:
            raise ValueError(
                "lz78(dict_size=N) is not supported: the reference's "
                "dictionary reset is flagged broken "
                "(LZ78Compressor.hpp:110-112); omit the option"
            )
        with StatPhase("Lz78 compression") as phase:
            parents, chars = lz78_parse(data)
            phase.log("factor_count", len(parents))
            out.write(self._encode_factors(parents, chars))

    def compress_block_batch(self, blocks: np.ndarray, n_valid: np.ndarray):
        """Per-block payloads of blocks [B, bs], parsed on the registry's
        device by kernel E (its plain version on the CPU) and coded by
        _encode_factors, so every payload equals the host path's; None
        where use_parse_device routes them to the host parse (which also
        rejects a dict_size)."""
        device = self.env.registry.device
        if self.env.option("dict_size").as_integer() or not use_parse_device(blocks.shape[1], len(blocks), device):
            return None
        with StatPhase("device lz78 parse") as ph:
            ph.log("blocks", len(blocks))
            factors = lz78_parse_blocks_device(blocks, n_valid, device)
        with StatPhase("encode"):
            return [self._encode_factors(p, c) for p, c in factors]

    def decompress(self, inp: Input, out: Output) -> None:
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        r = BitReader(inp.as_bytes())
        dec = coder_cls.Decoder(coder_env, r)
        from ..coders.base import Decoder as BaseDecoder

        if type(dec) is BaseDecoder:
            # bit coder: widths are known in advance -> bulk decode.
            # factor i occupies bits_for(i) + 8 bits.
            total = r._valid - r.pos
            nf_hi = max(16, total // 9 + 2)
            widths = bits_for_arr(np.arange(nf_hi, dtype=np.uint64)) + 8
            cum = np.cumsum(widths)
            nf = int(np.searchsorted(cum, total, side="right"))
            if nf > 0 and cum[nf - 1] != total:
                # trailing garbage tolerance: decode greedily like reference
                nf = int(np.searchsorted(cum, total, side="left"))
            tok_w = np.stack(
                [widths[:nf].astype(np.int64) - 8, np.full(nf, 8, np.int64)], 1
            ).ravel()
            toks = r.read_tokens(tok_w)
            parents = toks[0::2].astype(np.uint32)
            chars = toks[1::2].astype(np.uint8)
            out.write(lz78_expand(parents, chars))
            return
        parents_l = []
        chars_l = []
        fc = 0
        while not dec.eof():
            parents_l.append(dec.decode(Range(0, fc)))
            chars_l.append(dec.decode(literal_r))
            fc += 1
        out.write(
            lz78_expand(np.array(parents_l, np.uint32), np.array(chars_l, np.uint8))
        )

