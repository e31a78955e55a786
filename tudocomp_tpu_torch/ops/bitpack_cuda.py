"""Kernels A and B: per-block token bit packing, with their plain versions.

`pack_blocks` (kernel A) packs [B, NT] (value, width <= 32) tokens into
per-block MSB-first u32 arenas; it replaces
tudocomp_tpu/ops/bitpack_pallas.py:pack_blocks_pallas. `pack_bytes_blocks`
(kernel B) is the fused encode: per live byte it looks up (codeword, length)
in the block's table and packs it after the block's pre-packed header; it
replaces pack_bytes_blocks_pallas (both its pack=1 and its folded pack>1
kernels, whose outputs are bit-identical). The CUDA sources are
csrc/pack.cu.

Each wrapper picks its route by the device of its input tensors: CPU
tensors go to the plain PyTorch version beside it, CUDA tensors to the
kernel, anything else raises. A width outside [0, 32] is reported in the
launch path's mapped flag word (`kernels.launch_flagged`) and raises
ValueError. Arenas are int32 tensors holding u32 bit patterns.
"""

from __future__ import annotations

import torch

from .. import kernels
from .bitpack import pack_rows

__all__ = [
    "pack_blocks",
    "pack_blocks_plain",
    "pack_bytes_blocks",
    "pack_bytes_blocks_plain",
]

TILE = 2048  # tokens per CTA in csrc/pack.cu (THREADS * ITEMS)
_MAX_BITS = (1 << 31) - (1 << 20)  # per-block bit offsets stay in int32


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA inputs, False for CPU inputs; raises for a mix or another device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def check_widths(nbits: torch.Tensor) -> None:
    if nbits.numel() and (int(nbits.min()) < 0 or int(nbits.max()) > 32):
        raise ValueError("token width outside [0, 32]")


def pack_blocks_plain(values, nbits, n_words: int):
    """Plain version of pack_blocks."""
    check_widths(nbits)
    return pack_rows(values, nbits, n_words)


def pack_blocks(values, nbits, n_words: int):
    """[B, NT] (values, nbits) -> (words [B, n_words] int32, bits [B] int32).

    Bit-exact with tudocomp_tpu's vmapped pack_tokens: values are masked to
    their widths, widths outside [0, 32] raise, and bits at or past n_words
    are dropped (bits still counts them)."""
    if not on_cuda(values, nbits):
        return pack_blocks_plain(values, nbits, n_words)
    B, NT = nbits.shape
    if NT * 32 > _MAX_BITS:
        raise ValueError(f"{NT} tokens per block overflow the int32 bit offsets")
    dev = nbits.device
    values = values.to(torch.int32).contiguous()
    nbits = nbits.to(torch.int32).contiguous()
    words = torch.zeros((B, n_words), dtype=torch.int32, device=dev)
    bits = torch.zeros(B, dtype=torch.int32, device=dev)
    if NT == 0 or B == 0:
        return words, bits
    tile_bits = torch.empty((B, -(-NT // TILE)), dtype=torch.int32, device=dev)
    if kernels.launch_flagged("tdc_pack_blocks", values, nbits, B, NT, n_words, tile_bits, words, bits):
        raise ValueError("token width outside [0, 32]")
    return words, bits


def pack_bytes_blocks_plain(blocks, n_valid, table_vals, table_bits, hdr_words, hdr_bits, n_words: int):
    """Plain version of pack_bytes_blocks."""
    check_widths(table_bits)
    c = blocks.to(torch.int64)
    pos = torch.arange(blocks.shape[1], device=blocks.device)
    live = pos[None, :] < n_valid.to(torch.int64)[:, None]
    vals = table_vals.to(torch.int64).gather(1, c)
    nb = torch.where(live, table_bits.to(torch.int64).gather(1, c), 0)
    return pack_rows(vals, nb, n_words, start_bits=hdr_bits, arena=hdr_words)


def pack_bytes_blocks(blocks, n_valid, table_vals, table_bits, hdr_words, hdr_bits, n_words: int):
    """Fused encode: [B, bs] u8 blocks + per-block [B, 256] symbol tables
    (value, width) + header arenas [B, H] holding hdr_bits [B] bits ->
    (words [B, n_words] int32, bits [B] int32).

    The token of each live byte (pos < n_valid[b]) is (table_vals[b, byte],
    table_bits[b, byte]); the tokens follow the header from bit hdr_bits[b]
    on, MSB-first, with pack_blocks's masking and drop rule."""
    args = (blocks, n_valid, table_vals, table_bits, hdr_words, hdr_bits)
    if not on_cuda(*args):
        return pack_bytes_blocks_plain(*args, n_words)
    B, bs = blocks.shape
    if bs * 32 > _MAX_BITS:
        raise ValueError(f"blocks of {bs} bytes overflow the int32 bit offsets")
    if blocks.dtype != torch.uint8:
        raise TypeError(f"blocks must be uint8, not {blocks.dtype}")
    dev = blocks.device
    i32 = [t.to(torch.int32).contiguous() for t in (n_valid, table_vals, table_bits, hdr_bits)]
    words = torch.zeros((B, n_words), dtype=torch.int32, device=dev)
    k = min(hdr_words.shape[1], n_words)
    words[:, :k] = hdr_words[:, :k]
    if bs == 0 or B == 0:
        return words, i32[3].clone()
    bits = torch.empty(B, dtype=torch.int32, device=dev)
    tile_bits = torch.empty((B, -(-bs // TILE)), dtype=torch.int32, device=dev)
    if kernels.launch_flagged("tdc_pack_bytes_blocks", blocks.contiguous(), *i32, B, bs, n_words,
                              tile_bits, words, bits):
        raise ValueError("token width outside [0, 32]")
    return words, bits
