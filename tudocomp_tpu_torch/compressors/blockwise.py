"""Blockwise compressor of the port (id "blockwise").

    blockwise(inner, bs=262144, shared=0)

The input is split into fixed-size blocks, each block is compressed on its
own by the inner compressor, and the streams are framed in the TBK1
container (parallel/blocks.py), so the bytes equal the JAX package's. The
routing is tudocomp_tpu/compressors/blockwise.py's: encode(huff) goes to
the device runtime where device.use_device says so (TDC_DEVICE_HUFF), and
always with shared=1, whose one table of the whole input no per-block host
coder builds (the JAX package's encode route reads no override either),
and always in a process group of more than one, whose ranks split the
blocks (parallel/distributed.py); lzss_lcp(coder=huff) with shared=1, or
in a group of more than one, goes to the runtime's
blockwise_lzss_compress, which with shared=1 codes every block's literals
with one table (without it its blocks equal the driver's); an inner with
a batch hook (`compress_block_batch`: lz78, lzw) codes all blocks at once
where its gate says so; every other block goes through the port's driver
with raw=True, which wraps it with the inner's input restrictions, on a
pool of spawned processes from POOL_MIN_BLOCKS blocks on where
TDC_BLOCKWISE_PROCS asks for one.

TDC_BLOCKWISE_PROCS sets both pools, as in the JAX package: =0 runs the
blocks one after another, =N on N workers; unset, DEFAULT_WORKERS (below:
one after another, from the card's numbers). The encode pool's children
each run on the parent's device, passed by name: a card's child on that
card, a CPU parent's child on the CPU. A pool that fails raises; the one
sequential case beside =0 and fewer blocks is a parent whose __main__
cannot be imported again (an interactive interpreter, a pytest-xdist worker),
which spawned children need. Decoding mirrors the encode: encode(huff) on
the device, every other block through the driver, on a pool of threads
where TDC_BLOCKWISE_PROCS says so. The StatPhase of each arm logs its
number of workers.

A blockwise inner has neither a device route nor a batch hook, so each
outer block goes through the driver and takes the inner blockwise's own
routing: blockwise(blockwise(encode(huff))) runs the device runtime (kernels
A-C, and D on decode) once per outer block, blockwise(blockwise(lzw)) the
batch hook once per outer block. Its container is a TBK1 of TBK1s, the JAX
package's bytes.
"""

from __future__ import annotations

import concurrent.futures as cf
import multiprocessing as mp
import os
import sys

import numpy as np

from ..base import Compressor
from ..device import use_device
from ..io.inout import Input, Output
from ..meta import Meta
from ..parallel.blocks import frame_streams, split_blocks, unframe_streams
from ..parallel.distributed import group
from ..stats.phase import StatPhase

_HUFF = ("encode(coder=huff)", "encode(huff)")

# Fewest blocks the encode pool takes (the JAX package's 8).
POOL_MIN_BLOCKS = 8

# Workers of either pool when TDC_BLOCKWISE_PROCS is unset: none, blocks
# one after another. Measured by chip_smoke.py (phase "group", parts b and
# cd) in two runs on an NVIDIA H100 80GB HBM3 at 700.00 W, seconds, one
# block after another against 8 workers: the encode of 4 MiB of
# synth_english in blockwise(lz78u,bs=262144), 16 blocks, 5.55-7.37
# against 12.58-20.36 on spawned processes (each child's start, torch's
# import and a CUDA context, outweighs 16 blocks of ~0.4 s); its decode
# 2.16-3.46 against 3.48-4.01 on threads; in turns, the decode of 8 MiB in
# blockwise(lz78(coder=bit),bs=8192) 0.79-1.54 against 2.95-4.03, at 256
# KiB blocks 0.37-0.75 against 0.43-0.63: the pools lost everywhere but at
# 256 KiB blocks of lz78, a tie (the decoders are Python under one
# interpreter lock). The JAX package's 8 came from its host.
DEFAULT_WORKERS = 0


def pool_workers() -> int:
    """Workers of a blockwise pool: TDC_BLOCKWISE_PROCS=N gives N (0: none),
    unset gives DEFAULT_WORKERS."""
    v = os.environ.get("TDC_BLOCKWISE_PROCS", "")
    try:
        return int(v) if v else DEFAULT_WORKERS
    except ValueError:
        raise ValueError(f"TDC_BLOCKWISE_PROCS={v!r}: a number of workers, 0 for none") from None


def _compress_one(args):
    inner_id, block, device = args
    from ..driver import compress

    return compress(inner_id, block, device=device, raw=True)


def _main_importable() -> bool:
    """Can a spawned child import this process's __main__ again?"""
    main_file = getattr(sys.modules.get("__main__"), "__file__", None)
    return main_file is not None and os.path.exists(main_file)


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
        return self.env.registry.select_algorithm(av, "compressor"), av

    def compress(self, inp: Input, out: Output) -> None:
        bs = self.env.option("bs").as_integer()
        comp, av = self._inner()
        data = inp.as_array()
        device = self.env.registry.device
        shared = bool(self.env.option("shared").as_integer())
        multiproc = group()[0] > 1
        if av.id_string() in _HUFF:
            if shared or multiproc or use_device("TDC_DEVICE_HUFF", device):
                from ..parallel.runtime import blockwise_huffman_compress

                with StatPhase("device blockwise encode") as ph:
                    ph.log("bs", bs)
                    out.write(blockwise_huffman_compress(data, bs, device, shared_table=shared))
                return
        if av.name == "lzss_lcp" and av.options.get("coder") is not None:
            if av.options["coder"].name == "huff" and (shared or multiproc):
                from ..parallel.runtime import blockwise_lzss_compress

                with StatPhase("blockwise lzss runtime") as ph:
                    ph.log("bs", bs)
                    out.write(
                        blockwise_lzss_compress(
                            data,
                            bs,
                            device,
                            threshold=int(av.options.get("threshold", "3")),
                            shared_table=shared,
                            registry=self.env.registry,
                        )
                    )
                return
        blocks, n_valid = split_blocks(data, bs)
        batch = getattr(comp, "compress_block_batch", None)
        payloads = batch(blocks, n_valid) if batch is not None else None
        if payloads is None:
            with StatPhase("host blockwise encode") as ph:
                payloads = self._host_compress_blocks(av.id_string(), blocks, n_valid, ph)
                ph.log("blocks", len(payloads))
        out.write(frame_streams(payloads, bs))

    def _host_compress_blocks(self, inner_id: str, blocks, n_valid, ph) -> list:
        """Each block through the driver: on a spawn pool of processes, each
        on this registry's device, or (=0, fewer than POOL_MIN_BLOCKS
        blocks, no importable __main__) one after another here."""
        from ..driver import compress

        nb = len(blocks)
        workers = pool_workers()
        if workers < 1 or nb < POOL_MIN_BLOCKS or not _main_importable():
            workers = 0
        ph.log("workers", workers)
        if not workers:
            return [
                compress(inner_id, bytes(block[:nv]), raw=True, registry=self.env.registry)
                for block, nv in zip(blocks, n_valid)
            ]
        device = str(self.env.registry.device)
        jobs = [(inner_id, bytes(block[:nv]), device) for block, nv in zip(blocks, n_valid)]
        # spawn, not fork: the parent may hold CUDA contexts and threads
        with cf.ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn")) as ex:
            return list(ex.map(_compress_one, jobs))

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

        def one(p):
            return decompress(p, id_string=inner_id, raw=True, registry=self.env.registry)

        workers = min(pool_workers(), len(payloads))
        with StatPhase("blockwise decode") as ph:
            ph.log("workers", workers if workers > 1 else 0)
            if workers > 1:
                with cf.ThreadPoolExecutor(max_workers=workers) as ex:
                    parts = list(ex.map(one, payloads))
            else:
                parts = map(one, payloads)
            for part in parts:
                out.write(np.frombuffer(part, np.uint8))
