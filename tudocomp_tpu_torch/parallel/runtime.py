"""Block-parallel Huffman and lzss_lcp compression on one device.

The port of tudocomp_tpu/parallel/runtime.py for a single GPU (or the CPU,
through the kernels' plain versions): the input is split into TBK1 blocks
(parallel/blocks.py), the blocks are encoded in batches on `device`, and
the per-block streams are framed in block order, so the container is
byte-identical to the JAX package's. There is no mesh.

With a shared table, the one table covers the whole input, as the JAX
package's psum'd histogram does: pass 1 copies every batch to the device
and sums its histograms in int64, pass 2 builds the table once (one
launch of kernel C's int64 instance) and encodes the batches, which
stayed on the device between the passes.

blockwise_lzss_compress runs lzss_lcp(coder=huff) on every block, one
after another; with a shared table the literal feeds' histograms are
summed and the one table codes every block, serialized in each. Across
processes that sum would be an all-reduce; this module is one process.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..ops.bitpack import finalize_stream
from ..ops.huffman_decode_cuda import decode_payloads_batched
from ..ops.huffman_torch import block_histograms, encode_blocks, shared_tables
from .blocks import frame_streams, split_blocks, unframe_streams

__all__ = ["blockwise_huffman_compress", "blockwise_huffman_decompress", "blockwise_lzss_compress"]

_BATCH_BYTES = 1 << 24  # input bytes per encode batch (the 16 MiB of bench.py's batch)


def _single_process() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "more than one GPU is not ported yet (ROADMAP.md, Queue 1 item 5)"
        )


def blockwise_huffman_compress(
    data, block_size: int = 1 << 18, device="cuda", shared_table: bool = False
) -> bytes:
    """End-to-end block-parallel Huffman encode -> framed container bytes."""
    _single_process()
    dev = resolve(device)
    blocks, n_valid = split_blocks(data, block_size)
    n_words = (9 * block_size + 4096 + 31) // 32
    per = max(1, _BATCH_BYTES // block_size)
    batches = (
        (torch.from_numpy(blocks[lo : lo + per]).to(dev), torch.from_numpy(n_valid[lo : lo + per]).to(dev))
        for lo in range(0, len(blocks), per)
    )
    tables = None
    if shared_table:
        batches = list(batches)  # pass 1; the batches stay on the device for pass 2
        total = sum(block_histograms(b, nv).sum(dim=0, dtype=torch.int64) for b, nv in batches)
        tables = shared_tables(total)
    payloads = []
    for b, nv in batches:
        words, bits = encode_blocks(b, nv, n_words, shared_table=tables)
        bits = bits.cpu().numpy()
        used = min(n_words, (int(bits.max()) + 31) // 32)
        words = words[:, :used].cpu().numpy()
        payloads.extend(finalize_stream(words[i], int(bits[i])) for i in range(len(bits)))
    return frame_streams(payloads, block_size)


def blockwise_lzss_compress(
    data,
    block_size: int = 1 << 18,
    device="cuda",
    threshold: int = 3,
    shared_table: bool = False,
    registry=None,
) -> bytes:
    """Block-parallel lzss_lcp(coder=huff) -> framed container bytes.

    Every block runs the whole pipeline (restriction wrap, SA/ISA/LCP,
    factorize, lzss encode), with the device stages where their gates say
    so. With shared_table the literal histograms of all blocks are summed
    (int64) and one Huffman table codes every block; it is serialized in
    each block, so the streams stay decodable one by one. Without it the
    payloads equal driver.compress("lzss_lcp(coder=huff)", block, raw=True).
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

    _single_process()
    dev = resolve(device)
    registry = registry or TorchRegistry(dev)
    blocks, n_valid = split_blocks(data, block_size)
    # the restrictions of lzss_lcp's text data structures: escape \0, append
    # the sentinel, per block as the driver does on the per-block path
    rest = InputRestrictions((0,), True)
    texts, factor_sets = [], []
    counts = np.zeros(256, np.int64) if shared_table else None
    for block, nv in zip(blocks, n_valid):
        text = Input(bytes(block[:nv])).with_restrictions(rest).as_array()
        ds = TextDS(text, device=dev)
        f = lcp_factorize(ds.require_sa(), ds.require_isa(), ds.require_lcp(), threshold, dev)
        if shared_table:
            counts += np.bincount(literal_feed(text, f).chars(), minlength=256)
        texts.append(text)
        factor_sets.append(f)
    env = Env(registry, AlgorithmValue("huff", {}, type="coder"))
    payloads = []
    for text, f in zip(texts, factor_sets):
        w = BitWriter()
        enc = HuffmanCoder.Encoder(env, w, literal_feed(text, f), counts=counts)
        encode_text(enc, w, text, f)
        enc.finalize()
        payloads.append(w.getvalue())
    return frame_streams(payloads, block_size)


def blockwise_huffman_decompress(container: bytes, device="cuda") -> bytes:
    """Decode a framed container on `device`; the host parses only the
    per-block table headers."""
    _single_process()
    dev = resolve(device)
    block_size, payloads = unframe_streams(container)
    return b"".join(decode_payloads_batched(payloads, block_size, dev))
