"""Blockwise compressor of the port (id "blockwise").

    blockwise(inner, bs=262144, shared=0)

The input is split into fixed-size blocks, each block is compressed on its
own by the inner compressor, and the streams are framed in the TBK1
container (parallel/blocks.py), so the bytes equal the JAX package's. The
routing is tudocomp_tpu/compressors/blockwise.py's: encode(huff) goes to
the device runtime where device.use_device says so (TDC_DEVICE_HUFF), and
always with shared=1, whose one table of the whole input no per-block host
coder builds (the JAX package's encode route reads no override either);
lzss_lcp(coder=huff) with shared=1 goes to the runtime's
blockwise_lzss_compress, which codes every block's literals with one table
(without shared=1 its blocks go through the driver: the same bytes);
an inner with a batch hook (`compress_block_batch`:
lz78, lzw) codes all blocks at once where its gate says so; every other
block goes through the port's driver with raw=True, which wraps it with
the inner's input restrictions. Decoding mirrors it: encode(huff) on the
device, every other block through the driver, one after another (the JAX
package's thread pool decodes 8 KiB blocks 3-8x slower, PERF.md
section 5).

Not ported yet: a blockwise inner.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..device import use_device
from ..io.inout import Input, Output
from ..meta import Meta
from ..parallel.blocks import frame_streams, split_blocks, unframe_streams
from ..stats.phase import StatPhase

_HUFF = ("encode(coder=huff)", "encode(huff)")


class BlockwiseCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "blockwise", "Block-parallel compression wrapper")
        m.option("inner").dynamic_compressor()
        m.option("bs").dynamic(1 << 18)
        m.option("shared").dynamic(0)
        return m

    def _inner(self):
        av = self.env.option("inner").as_algorithm()
        if av.name == "blockwise":
            raise NotImplementedError(
                "blockwise as the inner compressor is not ported yet (ROADMAP.md, Queue 1 item 1)"
            )
        return self.env.registry.select_algorithm(av, "compressor"), av

    def compress(self, inp: Input, out: Output) -> None:
        bs = self.env.option("bs").as_integer()
        comp, av = self._inner()
        data = inp.as_array()
        device = self.env.registry.device
        if av.id_string() in _HUFF:
            shared = bool(self.env.option("shared").as_integer())
            if shared or use_device("TDC_DEVICE_HUFF", device):
                from ..parallel.runtime import blockwise_huffman_compress

                with StatPhase("device blockwise encode") as ph:
                    ph.log("bs", bs)
                    out.write(blockwise_huffman_compress(data, bs, device, shared_table=shared))
                return
        if av.name == "lzss_lcp" and av.options.get("coder") is not None:
            if av.options["coder"].name == "huff" and self.env.option("shared").as_integer():
                from ..parallel.runtime import blockwise_lzss_compress

                with StatPhase("blockwise lzss, shared table") as ph:
                    ph.log("bs", bs)
                    out.write(
                        blockwise_lzss_compress(
                            data,
                            bs,
                            device,
                            threshold=int(av.options.get("threshold", "3")),
                            shared_table=True,
                            registry=self.env.registry,
                        )
                    )
                return
        blocks, n_valid = split_blocks(data, bs)
        batch = getattr(comp, "compress_block_batch", None)
        payloads = batch(blocks, n_valid) if batch is not None else None
        if payloads is None:
            from ..driver import compress

            with StatPhase("host blockwise encode") as ph:
                inner_id = av.id_string()
                payloads = [
                    compress(inner_id, bytes(block[:nv]), raw=True, registry=self.env.registry)
                    for block, nv in zip(blocks, n_valid)
                ]
                ph.log("blocks", len(payloads))
        out.write(frame_streams(payloads, bs))

    def decompress(self, inp: Input, out: Output) -> None:
        _, av = self._inner()
        device = self.env.registry.device
        if av.id_string() in _HUFF and use_device("TDC_DEVICE_HUFF", device):
            from ..parallel.runtime import blockwise_huffman_decompress

            with StatPhase("device blockwise decode"):
                out.write(blockwise_huffman_decompress(inp.as_bytes(), device))
            return
        from ..driver import decompress

        _, payloads = unframe_streams(inp.as_bytes())
        inner_id = av.id_string()
        with StatPhase("blockwise decode"):
            for p in payloads:
                part = decompress(p, id_string=inner_id, raw=True, registry=self.env.registry)
                out.write(np.frombuffer(part, np.uint8))
