"""LZW compressor (id "lzw").

The port's copy of tudocomp_tpu/compressors/lzw.py. Format mirror of
compressors/LZWCompressor.hpp:19-135: trie parse with 256 pre-seeded root
nodes; factor i emits its node id in Range(i + 256); the
final partial factor is always emitted. Decode replays codes with the
classic LZW dictionary including the k == dict-size self-reference case
(lzw/LZWDecoding.hpp:13-99). Parsing and decoding run in the port's C++
host helpers (tdc_lzw_parse / tdc_lzw_decode) with Python fallbacks, for
every lz78trie choice (the trie never changes the codes). Under
blockwise, the batch hook parses all blocks on the registry's device
(kernel F, ops/lz78_cuda.py) where device.use_parse_device says so.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..coders.base import write_segmented
from ..io.bitio import BitReader, BitWriter, bits_for_arr
from ..io.inout import Input, Output
from ..literals import NoLiterals
from ..meta import Meta
from ..ranges import Range
from ..stats.phase import StatPhase
from .. import native
from ..device import use_parse_device
from ..ops.lz78_cuda import lzw_parse_blocks_device


def lzw_parse(data: np.ndarray) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return np.zeros(0, np.uint32)
    lib = native.get_lib()
    if lib is not None:
        codes = np.empty(n, dtype=np.uint32)
        nf = lib.tdc_lzw_parse(data, n, codes)
        return codes[:nf].copy()
    trie: dict[tuple[int, int], int] = {}
    codes_l: list[int] = []
    node = int(data[0])
    next_id = 256
    for c in data[1:]:
        c = int(c)
        child = trie.get((node, c))
        if child is None:
            trie[(node, c)] = next_id
            codes_l.append(node)
            next_id += 1
            node = c
        else:
            node = child
    codes_l.append(node)
    return np.array(codes_l, np.uint32)


def lzw_expand(codes: np.ndarray) -> bytes:
    nf = len(codes)
    if nf == 0:
        return b""
    codes = np.ascontiguousarray(codes, np.uint32)
    lib = native.get_lib()
    if lib is not None:
        # output length bound: sum of factor lengths <= nf * (nf+1) / 2 but
        # compute exactly: entry lengths grow by construction; replay cheaply
        cap = 16 + nf * 2
        while True:
            out = np.empty(cap, dtype=np.uint8)
            got = lib.tdc_lzw_decode(codes, nf, out, cap)
            if got == -2:
                raise ValueError("invalid compressed code")
            if got >= 0:
                return out[:got].tobytes()
            cap *= 4
    # python replay (LZWDecoding.hpp semantics)
    dictionary: list[tuple[int, int]] = [(-1, c) for c in range(256)]

    def rebuild(k: int) -> bytes:
        s = bytearray()
        while k != -1:
            prev, c = dictionary[k]
            s.append(c)
            k = prev
        return bytes(reversed(s))

    out = bytearray()
    prev_code = None
    for k in codes:
        k = int(k)
        if k > len(dictionary):
            raise ValueError("invalid compressed code")
        if k == len(dictionary):
            assert prev_code is not None
            s = rebuild(prev_code)
            s = s + s[:1]
            dictionary.append((prev_code, s[0]))
            out += s
        else:
            s = rebuild(k)
            if prev_code is not None:
                dictionary.append((prev_code, s[0]))
            out += s
        prev_code = k
    return bytes(out)


class LZWCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "lzw", "Lempel-Ziv-Welch")
        m.option("coder").templated("coder", "bit")
        m.option("lz78trie").templated("lz78trie", "ternary")
        m.option("dict_size").dynamic(0)
        return m

    def _encode_codes(self, codes: np.ndarray) -> bytes:
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        w = BitWriter()
        enc = coder_cls.Encoder(coder_env, w, NoLiterals())
        nf = len(codes)
        maxes = np.arange(nf, dtype=np.int64) + 256  # Range(i + 256)
        ok = write_segmented(
            w, enc, [(codes.astype(np.uint64), maxes, np.ones(nf, np.int64))]
        )
        if not ok:
            for i in range(nf):
                enc.encode(int(codes[i]), Range(i + 256))
        enc.finalize()
        return w.getvalue()

    def compress(self, inp: Input, out: Output) -> None:
        data = inp.as_array()
        # mirror lz78: the reference's dict_size reset is flagged broken
        # (LZ78Compressor.hpp:110-112), so a non-default value is an error
        if int(self.env.option("dict_size").as_integer()) != 0:
            raise ValueError(
                "lzw(dict_size=N) is not supported: the reference's "
                "dictionary reset is flagged broken "
                "(LZ78Compressor.hpp:110-112); omit the option"
            )
        with StatPhase("LZW Compression") as phase:
            codes = lzw_parse(data)
            phase.log("factor_count", len(codes))
            out.write(self._encode_codes(codes))

    def compress_block_batch(self, blocks: np.ndarray, n_valid: np.ndarray):
        """Per-block payloads of blocks [B, bs], parsed on the registry's
        device by kernel F (its plain version on the CPU) and coded by
        _encode_codes, so every payload equals the host path's; None where
        use_parse_device routes them to the host parse (which also rejects
        a dict_size)."""
        device = self.env.registry.device
        if self.env.option("dict_size").as_integer() or not use_parse_device(blocks.shape[1], device):
            return None
        with StatPhase("device lzw parse") as ph:
            ph.log("blocks", len(blocks))
            code_lists = lzw_parse_blocks_device(blocks, n_valid, device)
        with StatPhase("encode"):
            return [self._encode_codes(c) for c in code_lists]

    def decompress(self, inp: Input, out: Output) -> None:
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        r = BitReader(inp.as_bytes())
        dec = coder_cls.Decoder(coder_env, r)
        from ..coders.base import Decoder as BaseDecoder

        if type(dec) is BaseDecoder:
            # bit coder: widths known in advance -> bulk decode
            total = r._valid - r.pos
            nf_hi = max(16, total // 9 + 2)
            widths = bits_for_arr(np.arange(nf_hi, dtype=np.uint64) + 256)
            cum = np.cumsum(widths)
            nf = int(np.searchsorted(cum, total, side="right"))
            codes = r.read_tokens(widths[:nf].astype(np.int64)).astype(np.uint32)
            out.write(lzw_expand(codes))
            return
        codes_l = []
        counter = 0
        while not dec.eof():
            codes_l.append(dec.decode(Range(counter + 256)))
            counter += 1
        out.write(lzw_expand(np.array(codes_l, np.uint32)))

