"""Kernels E and F: the LZ78 and LZW parses of many blocks, with their plain versions.

`lz78_parse_blocks` (kernel E, csrc/lz78.cu) parses each block of a [B, bs]
uint8 batch into LZ78 factors (parent node, char), the trailing partial
factor included. It replaces tudocomp_tpu/ops/lz78_pallas.py:_lz78_kernel
(blocks of at most 8 KiB) and tudocomp_tpu/ops/lz78_bucket_pallas.py:
_lz78_bucket_kernel (at most 256 KiB), which compute the same function.
`lzw_parse_blocks` (kernel F) gives each block's LZW codes; it replaces
lz78_pallas.py:_lzw_kernel. Every block's output equals the host parse of
its first n_valid bytes (tudocomp_tpu.compressors.lz78.lz78_parse,
lzw.lzw_parse). The parse takes only bytes: no table or other state
crosses between the two packages.

Each wrapper picks its route by the device of its inputs: CPU tensors go
to the plain PyTorch version beside it, CUDA tensors to the kernel. Rows
hold zeros past each block's count. Both kernels run a warp a block and
keep one hash table a block in device memory, keyed by a hash of the
phrase's bytes and sized by what a block's trie can hold: kernel E's by
`z_max` (`table_log2`), kernel F's by `lzw_z_max` (`lzw_table_log2`).
Tables of at most 2^BITMAP_LOG2 slots come with an occupancy bitmap in
shared memory and are not filled; larger ones are filled with ones.

`lz78_parse_blocks_device` and `lzw_parse_blocks_device` are the host
helpers of the blockwise path: numpy blocks in, per-block numpy lists out,
as the JAX package's functions of the same names return them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .bitpack_cuda import on_cuda

__all__ = [
    "lz78_parse_blocks",
    "lz78_parse_blocks_device",
    "lz78_parse_blocks_plain",
    "lzw_parse_blocks",
    "lzw_parse_blocks_device",
    "lzw_parse_blocks_plain",
    "lzw_table_log2",
    "lzw_z_max",
    "parse_occupancy",
    "table_log2",
    "z_max",
]

MAX_BS = (1 << 24) - 512  # node ids, at most 256 + bs, fit the 24 bits of a dictionary key
BITMAP_LOG2 = 15  # csrc/lz78.cu: tables of at most 2^15 slots keep a bitmap and are not filled
_SCRATCH_BYTES = 1 << 31  # dictionary scratch per launch of the host helpers


def _check(blocks, n_valid) -> None:
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise TypeError(f"blocks must be a [B, bs] uint8 tensor, not {blocks.dtype} {tuple(blocks.shape)}")
    B, bs = blocks.shape
    if tuple(n_valid.shape) != (B,):
        raise ValueError(f"n_valid has shape {tuple(n_valid.shape)}, not ({B},)")
    if bs > MAX_BS:
        raise ValueError(f"blocks of {bs} bytes overflow the 24-bit node ids of the dictionary")
    if B and (int(n_valid.min()) < 0 or int(n_valid.max()) > bs):
        raise ValueError(f"n_valid outside [0, {bs}]")


def z_max(bs: int) -> int:
    """The most nodes the LZ78 trie of a block of bs bytes can hold: the most
    distinct non-empty strings whose lengths sum to at most bs, that is all
    256 strings of one byte, then all 65,536 of two bytes, and so on (a
    factor but the trailing one creates a node, and the nodes' strings are
    distinct)."""
    z, left, length, count = 0, bs, 1, 256
    while left >= length:
        k = min(count, left // length)
        z, left, length, count = z + k, left - k * length, length + 1, count * 256
    return z


def _slots_log2(entries: int) -> int:
    """log2 of the least power of two of slots (16 or more) that is at most
    55% full at `entries` entries."""
    need = -(-20 * entries // 11)
    return max(4, (need - 1).bit_length())


def table_log2(bs: int) -> int:
    """log2 of kernel E's slots a block of bs bytes: at most 55% full at
    z_max(bs) + 1 entries."""
    return _slots_log2(z_max(bs) + 1)


def lzw_z_max(bs: int) -> int:
    """The most entries the LZW dictionary of a block of bs bytes can hold.
    Every phrase but the last inserts one entry, the phrase and the next
    byte, so the entries are distinct strings of 2 bytes or more whose
    lengths less one sum to at most bs - 1 (the last phrase has a byte):
    at most all 65,536 strings of two bytes, then three-byte strings at two
    bytes each, and so on."""
    z, left, cost, count = 0, max(bs - 1, 0), 1, 1 << 16
    while left >= cost:
        k = min(count, left // cost)
        z, left, cost, count = z + k, left - k * cost, cost + 1, count * 256
    return z


def lzw_table_log2(bs: int) -> int:
    """log2 of kernel F's slots a block of bs bytes: at most 55% full at
    lzw_z_max(bs) + 1 entries."""
    return _slots_log2(lzw_z_max(bs) + 1)


def parse_occupancy(lzw: bool, bs: int) -> dict:
    """Kernel E's (lzw False) or F's registers a thread and CTAs of four
    blocks an SM holds at once on blocks of bs bytes (the bitmap's shared
    memory follows bs), as the CUDA runtime reports them (a card is
    needed)."""
    import ctypes

    log2 = (lzw_table_log2 if lzw else table_log2)(bs)
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    rc = kernels.helper("tdc_parse_occupancy")(int(lzw), log2, ctypes.byref(regs), ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(f"tdc_parse_occupancy: CUDA error {rc}")
    return {"registers": regs.value, "ctas_per_sm": ctas.value, "blocks_per_cta": 4}


def _table(B: int, log2: int, dev) -> torch.Tensor:
    """The kernels' hash tables, 2^log2 slots a block: all ones (empty),
    or left unfilled where the kernel keeps an occupancy bitmap and never
    reads an empty slot."""
    if log2 <= BITMAP_LOG2:
        return torch.empty((B, 1 << log2), dtype=torch.int64, device=dev)
    return torch.full((B, 1 << log2), -1, dtype=torch.int64, device=dev)


def _compact(emit, width: int):
    """Per row, the entries of emit that are >= 0, in order, from slot 0 of
    a [B, width] int64 tensor of zeros; and their count per row."""
    hit = emit >= 0
    out = torch.zeros((emit.shape[0], width), dtype=torch.int64, device=emit.device)
    rows, cols = hit.nonzero(as_tuple=True)
    out[rows, hit.cumsum(1)[rows, cols] - 1] = emit[rows, cols]
    return out, hit.sum(1)


def lz78_parse_blocks_plain(blocks, n_valid):
    """Plain version of lz78_parse_blocks: all blocks advance one byte per
    step, with a dense child table [B, nodes, 256]."""
    _check(blocks, n_valid)
    B, bs = blocks.shape
    dev = blocks.device
    n = int(n_valid.max()) if B else 0
    nodes = n + 2
    child = torch.zeros(B * nodes * 256, dtype=torch.int32, device=dev)
    base = torch.arange(B, device=dev) * (nodes * 256)
    text = blocks[:, :n].to(torch.int64)
    live = torch.arange(n, device=dev)[None, :] < n_valid.to(torch.int64)[:, None]
    emit = torch.full((B, n), -1, dtype=torch.int64, device=dev)  # key of the factor ending at i
    node = torch.zeros(B, dtype=torch.int64, device=dev)
    next_id = torch.ones(B, dtype=torch.int32, device=dev)
    for i in range(n):
        key = node * 256 + text[:, i]
        idx = base + key
        ch = child[idx]
        miss = live[:, i] & (ch == 0)
        child[idx] = torch.where(miss, next_id, ch)
        emit[:, i] = torch.where(miss, key, -1)
        node = torch.where(live[:, i], ch, node)  # a miss reads 0: back to the root
        next_id += miss
    keys, nf = _compact(emit, bs + 1)
    parents, chars = keys >> 8, keys & 0xFF
    # trailing partial factor: node k > 0 was created by factor k - 1
    pend = node > 0
    parents[pend, nf[pend]] = parents[pend, node[pend] - 1]
    chars[pend, nf[pend]] = chars[pend, node[pend] - 1]
    nf = nf + pend
    return parents.to(torch.int32), chars.to(torch.uint8), nf.to(torch.int32)


def lz78_parse_blocks(blocks, n_valid):
    """[B, bs] uint8 blocks, n_valid [B] -> (parents [B, bs + 1] int32, chars
    [B, bs + 1] uint8, nf [B] int32): block b's nf[b] LZ78 factors of its
    first n_valid[b] bytes."""
    if not on_cuda(blocks, n_valid):
        return lz78_parse_blocks_plain(blocks, n_valid)
    _check(blocks, n_valid)
    B, bs = blocks.shape
    dev = blocks.device
    parents = torch.zeros((B, bs + 1), dtype=torch.int32, device=dev)
    chars = torch.zeros((B, bs + 1), dtype=torch.uint8, device=dev)
    nf = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0:
        return parents, chars, nf
    log2 = table_log2(bs)
    table = _table(B, log2, dev)
    kernels.launch(
        "tdc_lz78_parse", blocks.contiguous(), bs, n_valid.to(torch.int32).contiguous(), B,
        table, log2, parents, chars, nf,
    )
    return parents, chars, nf


def lzw_parse_blocks_plain(blocks, n_valid):
    """Plain version of lzw_parse_blocks: all blocks advance one byte per
    step, with a dense child table [B, nodes, 256] whose first 256 nodes
    are the roots."""
    _check(blocks, n_valid)
    B, bs = blocks.shape
    dev = blocks.device
    n = int(n_valid.max()) if B else 0
    nodes = n + 257
    child = torch.zeros(B * nodes * 256, dtype=torch.int32, device=dev)
    base = torch.arange(B, device=dev) * (nodes * 256)
    text = blocks[:, :n].to(torch.int64)
    live = torch.arange(n, device=dev)[None, :] < n_valid.to(torch.int64)[:, None]
    emit = torch.full((B, n), -1, dtype=torch.int64, device=dev)  # code emitted at position i
    node = text[:, 0].clone() if n else torch.zeros(B, dtype=torch.int64, device=dev)
    next_id = torch.full((B,), 256, dtype=torch.int32, device=dev)
    for i in range(1, n):
        c = text[:, i]
        idx = base + node * 256 + c
        ch = child[idx]
        miss = live[:, i] & (ch == 0)
        child[idx] = torch.where(miss, next_id, ch)
        emit[:, i] = torch.where(miss, node, -1)
        node = torch.where(live[:, i], torch.where(miss, c, ch), node)
        next_id += miss
    codes, nf = _compact(emit, bs)
    last = n_valid > 0  # the final phrase of a non-empty block
    codes[last, nf[last]] = node[last]
    nf = nf + last
    return codes.to(torch.int32), nf.to(torch.int32)


def lzw_parse_blocks(blocks, n_valid):
    """[B, bs] uint8 blocks, n_valid [B] -> (codes [B, bs] int32, nf [B]
    int32): block b's nf[b] LZW codes of its first n_valid[b] bytes."""
    if not on_cuda(blocks, n_valid):
        return lzw_parse_blocks_plain(blocks, n_valid)
    _check(blocks, n_valid)
    B, bs = blocks.shape
    dev = blocks.device
    codes = torch.zeros((B, bs), dtype=torch.int32, device=dev)
    nf = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0:
        return codes, nf
    log2 = lzw_table_log2(bs)
    table = _table(B, log2, dev)
    kernels.launch(
        "tdc_lzw_parse", blocks.contiguous(), bs, n_valid.to(torch.int32).contiguous(), B,
        table, log2, codes, nf,
    )
    return codes, nf


def _batches(blocks: np.ndarray, n_valid: np.ndarray, dev: torch.device, log2_slots):
    """Slices of the blocks on `dev`, each small enough that the parse's
    dictionaries (the kernels' hash tables of 2^log2_slots(bs) slots, or the
    plain versions' child tables on the CPU) stay within _SCRATCH_BYTES."""
    B, bs = blocks.shape
    per_block = 8 << log2_slots(bs) if dev.type == "cuda" else (bs + 257) * 1024
    per = max(1, _SCRATCH_BYTES // per_block)
    for lo in range(0, B, per):
        yield (
            torch.from_numpy(np.ascontiguousarray(blocks[lo : lo + per], np.uint8)).to(dev),
            torch.from_numpy(np.asarray(n_valid[lo : lo + per], np.int32)).to(dev),
        )


def _to_host(nf: torch.Tensor, *outs: torch.Tensor):
    """nf, and the host copies of the first max(nf) columns of each output."""
    nf = nf.cpu().numpy()
    used = int(nf.max()) if len(nf) else 0
    return nf, [o[:, :used].cpu().numpy() for o in outs]


def lz78_parse_blocks_device(blocks: np.ndarray, n_valid: np.ndarray, device) -> list:
    """Parse numpy blocks [B, bs] on `device` -> per block (parents uint32,
    chars uint8), equal to the host lz78_parse of each block."""
    out = []
    for b, nv in _batches(blocks, n_valid, torch.device(device), table_log2):
        parents, chars, nf = lz78_parse_blocks(b, nv)
        nf, (par, chr_) = _to_host(nf, parents, chars)
        out.extend((par[i, :k].astype(np.uint32), chr_[i, :k]) for i, k in enumerate(nf))
    return out


def lzw_parse_blocks_device(blocks: np.ndarray, n_valid: np.ndarray, device) -> list:
    """Parse numpy blocks [B, bs] on `device` -> per block its LZW codes
    (uint32), equal to the host lzw_parse of each block."""
    out = []
    for b, nv in _batches(blocks, n_valid, torch.device(device), lzw_table_log2):
        codes, nf = lzw_parse_blocks(b, nv)
        nf, (got,) = _to_host(nf, codes)
        out.extend(got[i, :k].astype(np.uint32) for i, k in enumerate(nf))
    return out
