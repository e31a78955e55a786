"""Kernels A and B: per-block token bit packing, with their plain versions.

`pack_blocks` (kernel A) packs [B, NT] (value, width <= 32) tokens into
per-block MSB-first u32 arenas; it replaces
tudocomp_tpu/ops/bitpack_pallas.py:pack_blocks_pallas. `pack_bytes_blocks`
(kernel B) is the fused encode: per live byte it looks up (codeword, length)
in the block's table and packs it after the block's pre-packed header; it
replaces pack_bytes_blocks_pallas (both its pack=1 and its folded pack>1
kernels, whose outputs are bit-identical). The CUDA sources are
csrc/pack.cu: a CTA a tile (A: TILE_A tokens, B: TILE_B bytes), every tile
at once, each arena word stored once by the tile that owns it. So the arena
is allocated with torch.empty and nothing zeroes it: the kernel writes
every word, the words past a row's bits as zeros, and kernel B writes the
header words itself.
Kernel A's rows of one tile (the Huffman headers) take one launch and no
scratch; kernel B and A's longer rows take a first pass that sums the
widths of each tile (and, for B, of each thread's tokens) into a scratch
tensor, also from torch.empty.

Each wrapper picks its route by the device of its input tensors: CPU
tensors go to the plain PyTorch version beside it, CUDA tensors to the
kernel, anything else raises. A width outside [0, 32] is reported in the
launch path's mapped flag word (`kernels.launch_flagged`) and raises
ValueError. Arenas are int32 tensors holding u32 bit patterns. A table or
header that is one row broadcast over the batch (`expand`, the shared
table) reaches kernel B as that one row, with a row stride of 0.
"""

from __future__ import annotations

import torch

from .. import kernels
from .bitpack import pack_rows

__all__ = [
    "launch_args_a",
    "launch_args_b",
    "pack_blocks",
    "pack_blocks_plain",
    "pack_bytes_blocks",
    "pack_bytes_blocks_plain",
]

# csrc/pack.cu's THREADS, ITEMS_A and ITEMS_B (tests/test_torch_pack_tiles.py
# holds the two files to the same values): the tiles size the scratch
THREADS = 256  # threads a CTA
TILE_A = THREADS * 4  # kernel A's tokens a CTA, 4 a thread
TILE_B = THREADS * 32  # kernel B's bytes a CTA, 32 a thread
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


def _i32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    return x if x.is_contiguous() else x.contiguous()


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """x as int32 with unit stride along its last axis, and its row stride
    (0 for one row broadcast over the batch)."""
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    if x.dim() > 1 and x.shape[-1] > 1 and x.stride(-1) != 1:
        x = x.contiguous()
    return x, x.stride(0)


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
    args = launch_args_a(values, nbits, n_words)
    if args[2] and kernels.launch_flagged("tdc_pack_blocks", *args):
        raise ValueError("token width outside [0, 32]")
    return args[-2], args[-1]


def launch_args_a(values, nbits, n_words: int) -> tuple:
    """Kernel A's launcher arguments for CUDA tensors, after the checks,
    casts and allocations; the outputs (words, bits) are the last two."""
    B, NT = nbits.shape
    if NT * 32 > _MAX_BITS:
        raise ValueError(f"{NT} tokens per block overflow the int32 bit offsets")
    dev = nbits.device
    tiles = -(-NT // TILE_A)
    tile_bits = torch.empty((B, tiles), dtype=torch.int32, device=dev) if tiles > 1 else None
    return (_i32(values), _i32(nbits), B, NT, n_words, tile_bits,
            torch.empty((B, n_words), dtype=torch.int32, device=dev), torch.empty(B, dtype=torch.int32, device=dev))


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
    on, MSB-first, with pack_blocks's masking and drop rule. The first
    min(H, n_words) words hold the header's words ORed in."""
    args = (blocks, n_valid, table_vals, table_bits, hdr_words, hdr_bits)
    if not on_cuda(*args):
        return pack_bytes_blocks_plain(*args, n_words)
    args = launch_args_b(*args, n_words)
    if args[10] and kernels.launch_flagged("tdc_pack_bytes_blocks", *args):
        raise ValueError("token width outside [0, 32]")
    return args[-2], args[-1]


def launch_args_b(blocks, n_valid, table_vals, table_bits, hdr_words, hdr_bits, n_words: int) -> tuple:
    """Kernel B's launcher arguments for CUDA tensors, after the checks,
    casts and allocations; the outputs (words, bits) are the last two."""
    B, bs = blocks.shape
    if bs * 32 > _MAX_BITS:
        raise ValueError(f"blocks of {bs} bytes overflow the int32 bit offsets")
    if blocks.dtype != torch.uint8:
        raise TypeError(f"blocks must be uint8, not {blocks.dtype}")
    if (table_vals.shape != (B, 256) or table_bits.shape != (B, 256) or n_valid.shape != (B,)
            or hdr_bits.shape != (B,) or hdr_words.dim() != 2 or hdr_words.shape[0] != B):
        raise ValueError("tables must be [B, 256], n_valid and hdr_bits [B], hdr_words [B, H]")
    dev = blocks.device
    tv, tv_stride = _rows(table_vals)
    tb, tb_stride = _rows(table_bits)
    if tv_stride != tb_stride:
        tv, tb = tv.contiguous(), tb.contiguous()
        tv_stride = 256
    hw, hw_stride = _rows(hdr_words)
    hb, hb_stride = _rows(hdr_bits)
    # the first pass's tile totals and each thread's widths
    scratch = torch.empty(B * max(1, -(-bs // TILE_B)) * (THREADS + 1), dtype=torch.int32, device=dev)
    return (blocks if blocks.is_contiguous() else blocks.contiguous(), _i32(n_valid), tv, tb, tv_stride, hw,
            hw_stride, hw.shape[1], hb, hb_stride, B, bs, n_words, scratch,
            torch.empty((B, n_words), dtype=torch.int32, device=dev), torch.empty(B, dtype=torch.int32, device=dev))
