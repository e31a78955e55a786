"""Block-parallel Huffman and lzss_lcp compression, one process or a group.

The port of tudocomp_tpu/parallel/runtime.py: the input is split into TBK1
blocks (parallel/blocks.py), the blocks are encoded in batches on
`device`, and the per-block streams are framed in block order, so the
container is byte-identical to the JAX package's.

In a process group of more than one (parallel/distributed.py) rank r takes
the contiguous blocks [r * chunk, min(nb, (r + 1) * chunk)), chunk = ceil(nb
/ world), on its own device; a rank with no blocks still joins every
collective, in the same order. The payloads are then gathered to every rank
in block order (their lengths first, then the bytes padded to the longest),
so every rank frames the same container, the bytes of one process. Every
collective is gloo's on host tensors: the payloads are framed on the host
anyway.

With a shared table, the one table covers the whole input, as the JAX
package's psum'd histogram does: pass 1 copies every batch to the device
and sums its histograms in int64 (in a group, the ranks' sums are then
all-reduced on the host), pass 2 builds the table once (one launch of
kernel C's int64 instance, on every rank from the same sum) and encodes
the batches, which stayed on the device between the passes.

blockwise_lzss_compress runs lzss_lcp(coder=huff) on every block of this
rank, on a pool of threads (the suffix stack's launches and the C++ host
stages release the interpreter lock); with a shared table the literal
feeds' histograms are summed (all-reduced in a group) and the one table
codes every block, serialized in each.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np
import torch

from ..device import resolve
from ..ops.bitpack import finalize_stream
from ..ops.huffman_decode_cuda import decode_payloads_batched
from ..ops.huffman_torch import block_histograms, encode_blocks, shared_tables
from .blocks import frame_streams, split_blocks, unframe_streams
from .distributed import group

__all__ = ["blockwise_huffman_compress", "blockwise_huffman_decompress", "blockwise_lzss_compress"]

_BATCH_BYTES = 1 << 24  # input bytes per encode batch (the 16 MiB of bench.py's batch)

# Threads of blockwise_lzss_compress's pool over a rank's blocks. Measured
# by chip_smoke.py (phase "group", part cd) in two runs on an NVIDIA H100
# 80GB HBM3 at 700.00 W: 16 MiB of synth_english in 64 blocks of 256 KiB
# (the SA and kernel H on the card, the factorization and coding on the
# host), one process, in turns, seconds: 1 thread 1.35-1.79, 2 0.98-1.19,
# 4 0.85-0.94, 8 0.91-1.13.
LZSS_THREADS = 4


def _rank_blocks(nb: int, world: int, rank: int) -> tuple[int, int, int]:
    """(chunk, lo, hi): rank's contiguous share [lo, hi) of nb blocks."""
    chunk = -(-nb // world)
    return chunk, min(nb, rank * chunk), min(nb, (rank + 1) * chunk)


def _all_reduce_sum(counts: np.ndarray) -> None:
    """Sum an int64 array over the group, in place (gloo, host tensor)."""
    torch.distributed.all_reduce(torch.from_numpy(counts))


def _gather_payloads(payloads: list, nb: int, chunk: int) -> list:
    """Every rank's payloads (chunk rows each, the last ranks' short) on
    every rank, in block order: the lengths first, then the bytes padded to
    the longest payload of the group."""
    dist = torch.distributed
    world = dist.get_world_size()
    lens = np.zeros(chunk, np.int64)
    lens[: len(payloads)] = [len(p) for p in payloads]
    parts = [torch.empty(chunk, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(parts, torch.from_numpy(lens))
    all_lens = torch.cat(parts).numpy()
    width = max(1, int(all_lens.max()))
    rows = np.zeros((chunk, width), np.uint8)
    for j, p in enumerate(payloads):
        rows[j, : len(p)] = np.frombuffer(p, np.uint8)
    parts = [torch.empty((chunk, width), dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(parts, torch.from_numpy(rows))
    all_rows = torch.cat(parts).numpy()
    return [all_rows[i, : all_lens[i]].tobytes() for i in range(nb)]


def blockwise_huffman_compress(
    data, block_size: int = 1 << 18, device="cuda", shared_table: bool = False
) -> bytes:
    """End-to-end block-parallel Huffman encode -> framed container bytes
    (in a group: this rank's blocks, then the gather; the same bytes on
    every rank)."""
    dev = resolve(device)
    world, rank = group()
    blocks, n_valid = split_blocks(data, block_size)
    chunk, lo, hi = _rank_blocks(len(blocks), world, rank)
    n_words = (9 * block_size + 4096 + 31) // 32
    per = max(1, _BATCH_BYTES // block_size)
    batches = (
        (torch.from_numpy(blocks[b : min(hi, b + per)]).to(dev), torch.from_numpy(n_valid[b : min(hi, b + per)]).to(dev))
        for b in range(lo, hi, per)
    )
    tables = None
    if shared_table:
        batches = list(batches)  # pass 1; the batches stay on the device for pass 2
        total = torch.zeros(256, dtype=torch.int64, device=dev)
        for b, nv in batches:
            total += block_histograms(b, nv).sum(dim=0, dtype=torch.int64)
        if world > 1:
            counts = total.cpu().numpy()
            _all_reduce_sum(counts)
            total = torch.from_numpy(counts).to(dev)
        tables = shared_tables(total)
    payloads = []
    for b, nv in batches:
        words, bits = encode_blocks(b, nv, n_words, shared_table=tables)
        bits = bits.cpu().numpy()
        used = min(n_words, (int(bits.max()) + 31) // 32)
        words = words[:, :used].cpu().numpy()
        payloads.extend(finalize_stream(words[i], int(bits[i])) for i in range(len(bits)))
    if world > 1:
        payloads = _gather_payloads(payloads, len(blocks), chunk)
    return frame_streams(payloads, block_size)


def blockwise_lzss_compress(
    data,
    block_size: int = 1 << 18,
    device="cuda",
    threshold: int = 3,
    shared_table: bool = False,
    registry=None,
    workers: int | None = None,
) -> bytes:
    """Block-parallel lzss_lcp(coder=huff) -> framed container bytes.

    Every block of this rank runs the whole pipeline (restriction wrap,
    SA/ISA/LCP, factorize, lzss encode), with the device stages where their
    gates say so, on `workers` threads (default LZSS_THREADS; results in
    block order). With shared_table the literal histograms of all blocks
    (of every rank, in a group) are summed (int64) and one Huffman table
    codes every block; it is serialized in each block, so the streams stay
    decodable one by one. Without it the payloads equal
    driver.compress("lzss_lcp(coder=huff)", block, raw=True).
    """
    from ..coders.huffman import HuffmanCoder
    from ..compressors.lzss_common import encode_text, literal_feed
    from ..compressors.lzss_lcp import lcp_factorize
    from ..ds.textds import TextDS
    from ..io.bitio import BitWriter
    from ..io.inout import Input
    from ..io.restrict import InputRestrictions
    from ..meta import AlgorithmValue, Env
    from ..registry import TorchRegistry
    from ..stats.phase import StatPhase

    dev = resolve(device)
    registry = registry or TorchRegistry(dev)
    world, rank = group()
    blocks, n_valid = split_blocks(data, block_size)
    chunk, lo, hi = _rank_blocks(len(blocks), world, rank)
    # the restrictions of lzss_lcp's text data structures: escape \0, append
    # the sentinel, per block as the driver does on the per-block path
    rest = InputRestrictions((0,), True)

    def factorize(i):
        text = Input(bytes(blocks[i, : n_valid[i]])).with_restrictions(rest).as_array()
        ds = TextDS(text, device=dev)
        return text, lcp_factorize(ds.require_sa(), ds.require_isa(), ds.require_lcp(), threshold, dev)

    workers = min(LZSS_THREADS if workers is None else workers, max(1, hi - lo))
    with StatPhase("blockwise lzss factorize") as ph:
        ph.log("blocks_local", hi - lo)
        ph.log("workers", workers)
        if workers > 1:
            with cf.ThreadPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(factorize, range(lo, hi)))
        else:
            results = [factorize(i) for i in range(lo, hi)]
    counts = None
    if shared_table:
        counts = np.zeros(256, np.int64)
        for text, f in results:
            counts += np.bincount(literal_feed(text, f).chars(), minlength=256)
        if world > 1:
            _all_reduce_sum(counts)
    env = Env(registry, AlgorithmValue("huff", {}, type="coder"))
    payloads = []
    with StatPhase("blockwise lzss encode"):
        for text, f in results:
            w = BitWriter()
            enc = HuffmanCoder.Encoder(env, w, literal_feed(text, f), counts=counts)
            encode_text(enc, w, text, f)
            enc.finalize()
            payloads.append(w.getvalue())
    if world > 1:
        payloads = _gather_payloads(payloads, len(blocks), chunk)
    return frame_streams(payloads, block_size)


def blockwise_huffman_decompress(container: bytes, device="cuda") -> bytes:
    """Decode a framed container on `device`; the host parses only the
    per-block table headers. One process: in a group every rank decodes
    the whole container."""
    dev = resolve(device)
    block_size, payloads = unframe_streams(container)
    return b"".join(decode_payloads_batched(payloads, block_size, dev))
