"""ChainCompressor: run two compressors in sequence.

The port's copy of tudocomp_tpu/compressors/chain.py. Mirror of
include/tudocomp_driver/ChainCompressor.hpp:14-102: `a:b` CLI sugar parses
to chain(a, b); compress runs first then second with the intermediate
buffered in memory; decompress runs second then first. Each stage's input
(compress) / output (decompress) is wrapped with that stage's declared
input restrictions, exactly as the driver would wrap the outermost
compressor.
"""

from __future__ import annotations

from ..base import Compressor
from ..io.inout import Input, Output
from ..meta import Meta


class ChainCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "chain")
        m.option("first").dynamic_compressor()
        m.option("second").dynamic_compressor()
        return m

    def _stage(self, option: str):
        av = self.env.option(option).as_algorithm()
        comp = self.env.registry.select_algorithm(av, "compressor")
        rest = comp.meta().input_restrictions
        return comp, rest

    def compress(self, inp: Input, out: Output) -> None:
        first, rest1 = self._stage("first")
        second, rest2 = self._stage("second")
        between = Output()
        first.compress(inp.with_restrictions(rest1) if rest1.has_restrictions else inp, between)
        mid = Input(between.getvalue())
        second.compress(mid.with_restrictions(rest2) if rest2.has_restrictions else mid, out)

    def decompress(self, inp: Input, out: Output) -> None:
        first, rest1 = self._stage("first")
        second, rest2 = self._stage("second")
        between = Output()
        wrapped = (
            between.with_restrictions(rest2) if rest2.has_restrictions else between
        )
        second.decompress(inp, wrapped)
        mid = Input(wrapped.getvalue())
        if rest1.has_restrictions:
            # unescape must apply where the data lands: materialize through
            # a restricted buffer, then forward the unescaped bytes
            tmp = Output(rest1)
            first.decompress(mid, tmp)
            out.write(tmp.getvalue())
        else:
            first.decompress(mid, out)
