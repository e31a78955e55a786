"""The literal encoder (id "encode").

The port's copy of tudocomp_tpu/compressors/simple.py, trimmed to
LiteralEncoder (compressors/LiteralEncoder.hpp:12-42): per-byte
coder.encode(c, literal_r); decode until eof. The JAX package's noop, rle
and mtf are not ported yet (ROADMAP.md, Queue 1 item 4a).
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..literals import ViewLiterals
from ..meta import Meta
from ..ranges import literal_r
from ..stats.phase import StatPhase


class LiteralEncoder(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta(
            "compressor", "encode", "Simply encodes the input's individual characters."
        )
        m.option("coder").templated("coder", None)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        data = inp.as_array()
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        w = BitWriter()
        enc = coder_cls.Encoder(coder_env, w, ViewLiterals(data))
        with StatPhase("encode"):
            enc.encode_array(data, literal_r)
            enc.finalize()
        out.write(w.getvalue())

    def decompress(self, inp: Input, out: Output) -> None:
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        r = BitReader(inp.as_bytes())
        dec = coder_cls.Decoder(coder_env, r)
        if hasattr(dec, "decode_literals_until_eof"):
            out.write(dec.decode_literals_until_eof())
            return
        width = dec.literal_fixed_width()
        if width:
            count = max(0, (r._valid - r.pos)) // width
            out.write(dec.decode_array(count, literal_r).astype(np.uint8))
            return
        chunks = []
        while not dec.eof():
            chunks.append(dec.decode(literal_r) & 0xFF)
        out.write(np.array(chunks, dtype=np.uint8))
