"""BWT compressor (id "bwt").

The port's copy of tudocomp_tpu/compressors/bwt.py. Mirror of
compressors/BWTCompressor.hpp:14-65: compress emits the Burrows-Wheeler
transform of the escaped, 0-terminated input (a gather text[sa[i]-1] over
the suffix array: on the device where the device built the SA, TextDS.bwt);
decompress rebuilds the text with the LF-mapping walk on the host
(ds/bwt.hpp:77-98) — the sentinel is dropped by the walk, escaping is
undone by the output restriction wrapper. Typically chained:
bwt:rle:mtf:encode(huff) is the bzip-like reference pipeline.
"""

from __future__ import annotations

from ..base import Compressor
from ..ds import flags
from ..ds.textds import decode_bwt
from ..ds.textds_algo import make_textds
from ..io.inout import Input, Output
from ..meta import Meta
from ..stats.phase import StatPhase


class BWTCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "bwt", "BWT of the input text")
        m.option("textds").templated("textds", "textds")
        m.uses_textds(flags.SA)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        text = inp.as_array()
        with StatPhase("Construct Text DS"):
            ds = make_textds(self, text)
            ds.require_sa()
        with StatPhase("Compute BWT"):
            out.write(ds.bwt())

    def decompress(self, inp: Input, out: Output) -> None:
        bwt = inp.as_array()
        with StatPhase("Decode BWT"):
            out.write(decode_bwt(bwt))
