"""Block-parallel canonical Huffman encode in PyTorch.

The port of tudocomp_tpu/ops/huffman_jax.py. Per block of a [B, bs] u8
batch it produces the byte stream of the host HuffmanCoder literal path
(coders/huffman.py, format of HuffmanCoder.hpp):
  flag bit | table (compressed_int longest, numl[], alphabet, symbols) | codes

Stages, all batched over blocks:
  1. histogram over each block's valid prefix   (block_histograms, plain)
  2. tables: sort, Moffat/Katajainen lengths,   (kernel C, table_kernels)
     canonical codes
  3. header tokens                               (huffman_table_tokens, plain)
  4. header pack                                 (kernel A, bitpack_cuda)
  5. fused codeword lookup + pack after header   (kernel B, bitpack_cuda)

With a shared table (shared_tables) stage 2 runs once, on the histogram
summed over all blocks: one launch of kernel C's int64 instance
(table_kernels.huffman_tables64).

code_lengths_batch and canonical_codes_batch are the plain table chain,
kernel C's reference. Blocks are capped at MAX_BLOCK = 2 MiB: a depth-d code
needs a block of at least Fibonacci(d + 1) symbols, so the cap keeps code
lengths at 31 bits or fewer and every token within the 32-bit pack limit.
A shared table has no such bound: code_lengths_batch raises where a code
would exceed 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitpack_cuda import pack_blocks, pack_bytes_blocks
from .table_kernels import MAX_LEN, HuffmanTables, depth_error, huffman_tables, huffman_tables64, moffat_phase12_plain

__all__ = [
    "MAX_BLOCK",
    "N_TABLE_TOKENS",
    "block_histograms",
    "canonical_codes_batch",
    "code_lengths_batch",
    "encode_blocks",
    "encode_blocks_from_lengths",
    "encode_blocks_with_hists",
    "huffman_table_tokens",
    "shared_tables",
    "tables_from_numpy",
]

MAX_BLOCK = 1 << 21  # keeps max code length <= 31 (Fibonacci bound)
N_TABLE_TOKENS = 1 + 4 + 4 * MAX_LEN + 4 + 256
_BIG = 0x3FFFFFFF
_ABSENT = 1 << 62  # above every (count << 9) | symbol key of counts below 2^53


def block_histograms(blocks, n_valid):
    """[B, bs] u8 + [B] valid counts -> [B, 256] int32 histograms."""
    B, bs = blocks.shape
    dev = blocks.device
    pos = torch.arange(bs, device=dev)
    live = pos[None, :] < n_valid.to(torch.int64)[:, None]
    row = 256 * torch.arange(B, device=dev)[:, None]
    idx = torch.where(live, blocks.to(torch.int64) + row, B * 256)  # dead bytes -> spare bin
    counts = torch.bincount(idx.reshape(-1), minlength=B * 256 + 1)
    return counts[: B * 256].reshape(B, 256).to(torch.int32)


def _rank(key):
    """rank[b, s] = #{j : key[b, j] < key[b, s]} (sort-free sorted position)."""
    return (key[:, None, :] < key[:, :, None]).sum(dim=2)


def _sort_hist(hists):
    """[B, 256] histograms -> (sorted weights [B, 256] int64, sigma [B]
    int32, rank [B, 256] int64): the counterpart of huffman_jax._sort_hist.

    Symbols rank by the key (count << 9) | symbol in int64, absent symbols
    after every present one: the order the JAX package means, without the
    wrap of its int32 key once a count reaches 2^22 (a shared table's
    summed histogram does). Slots past sigma hold 0."""
    h = hists.to(torch.int64)
    present = h > 0
    sym = torch.arange(256, device=h.device)
    key = torch.where(present, (h << 9) | sym, _ABSENT | sym)
    rank = _rank(key)  # a permutation: the keys are unique
    weights = torch.zeros_like(h).scatter_(1, rank, torch.where(present, h, 0))
    return weights, present.sum(dim=1).to(torch.int32), rank


def _check_depth(A, sigma) -> None:
    """Raise where a code would be longer than MAX_LEN bits: kernels A, B
    and D take codes of at most 32 bits. A block of at most MAX_BLOCK bytes
    never needs one; a skewed shared histogram can."""
    internal = torch.arange(256, device=A.device)[None, :] < (sigma.to(torch.int64) - 1)[:, None]
    if not bool(internal.any()):
        return
    longest = int(torch.where(internal, A, 0).max()) + 1
    if longest > MAX_LEN:
        raise depth_error(longest)


def _phase3(A, rank, sigma):
    """Internal depths -> per-symbol code lengths [B, 256] int32: the
    counterpart of huffman_jax._phase3. Leaf depths are read off the
    internal-depth histogram; blocks with sigma <= 1 get all zeros."""
    dev = A.device
    m = sigma.to(torch.int64)
    pos = torch.arange(256, device=dev)
    internal = pos[None, :] < (m - 1)[:, None]
    idepth = torch.where(internal, A.clamp(max=MAX_LEN + 1), MAX_LEN + 1)
    drange = torch.arange(MAX_LEN + 1, device=dev)
    nd = (idepth[:, None, :] == drange[None, :, None]).sum(dim=2)  # [B, 33]
    leaves = 2 * torch.cat([torch.zeros_like(nd[:, :1]), nd[:, :-1]], dim=1) - nd
    leaves[:, 0] = 0
    cum = torch.cumsum(leaves, dim=1)
    rankf = (m - 1)[:, None] - pos[None, :]  # rank from the most frequent symbol
    depth = (cum[:, None, :] <= rankf[:, :, None]).sum(dim=2)
    depth = torch.where(pos[None, :] < m[:, None], depth, 0)
    lengths = depth.gather(1, rank)
    return torch.where((m >= 2)[:, None], lengths, 0).to(torch.int32)


def code_lengths_batch(hists):
    """[B, 256] histograms (any integer type, counts below 2^53) -> [B, 256]
    int32 code lengths (0 = absent).

    _sort_hist, Moffat/Katajainen phases 1-2 (moffat_phase12_plain, kernel
    G's plain version; ties prefer the leaf), then _phase3, all in plain
    PyTorch on the tensors' device. Blocks with sigma <= 1 get all zeros.
    Raises ValueError where a code would exceed MAX_LEN bits."""
    weights, sigma, rank = _sort_hist(hists)
    A = moffat_phase12_plain(weights, sigma)
    _check_depth(A, sigma)
    return _phase3(A, rank, sigma)


def canonical_codes_batch(lengths):
    """[B, 256] code lengths -> (cw [B, 256] u32 bit patterns, numl [B, 32],
    ordered_sym [B, 256], sigma [B], longest [B]), all int32.

    Canonical codes (HuffmanCoder.hpp:192-218): firstcode[longest-1] = 0,
    firstcode[i-1] = (firstcode[i] + numl[i]) / 2; codewords are assigned in
    (length, symbol) order; ordered_sym is 0 past sigma."""
    B = lengths.shape[0]
    dev = lengths.device
    L = lengths.to(torch.int64)
    present = L > 0
    sigma = present.sum(dim=1)
    longest = L.max(dim=1).values if B else torch.zeros(0, dtype=torch.int64, device=dev)
    lrange = torch.arange(1, MAX_LEN + 1, device=dev)
    numl = (L[:, None, :] == lrange[None, :, None]).sum(dim=2)  # [B, 32]

    firstcode = torch.zeros((B, MAX_LEN + 1), dtype=torch.int64, device=dev)  # slot 32 reads 0
    fc = torch.zeros(B, dtype=torch.int64, device=dev)
    for i in range(MAX_LEN - 1, 0, -1):
        fc = torch.where(i < longest, (fc + numl[:, i]) >> 1, 0)
        firstcode[:, i - 1] = fc

    sym = torch.arange(256, device=dev)
    key = torch.where(present, (L << 9) | sym, 0x7FFF0000 + sym)
    rank = _rank(key)  # a permutation: the keys are unique
    ordered_sym = torch.zeros((B, 256), dtype=torch.int64, device=dev).scatter_(
        1, rank, sym.expand(B, 256)
    )
    ordered_len = torch.zeros((B, 256), dtype=torch.int64, device=dev).scatter_(
        1, rank, torch.where(present, L, _BIG)
    )
    num_shorter = torch.cat([torch.zeros_like(numl[:, :1]), torch.cumsum(numl, dim=1)], dim=1)
    slot = (ordered_len - 1).clamp(0, MAX_LEN)
    ordered_cw = firstcode.gather(1, slot) + (sym[None, :] - num_shorter.gather(1, slot))
    live = sym[None, :] < sigma[:, None]
    ordered_cw = torch.where(live, ordered_cw, 0)
    ordered_sym = torch.where(live, ordered_sym, 0)
    cw = ordered_cw.gather(1, rank)
    i32 = torch.int32
    return cw.to(i32), numl.to(i32), ordered_sym.to(i32), sigma.to(i32), longest.to(i32)


def tables_from_numpy(lengths, cw, numl, ordered_sym, sigma, longest, device="cpu") -> HuffmanTables:
    """The JAX package's table set (the numpy arrays that
    huffman_tables_pallas or canonical_codes_batch return, cw as u32) as the
    port's HuffmanTables on `device`."""

    def t(a):
        a = np.array(a)  # a writable copy
        a = a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)
        return torch.from_numpy(a).to(device)

    return HuffmanTables(t(lengths), t(cw), t(numl), t(ordered_sym), t(sigma), t(longest))


def _compressed_int_tokens(v):
    """[...] values < 2^14 -> ([..., 4] values, [..., 4] widths) of
    write_compressed_int(v) (io/bitio.py)."""
    more = (v >= 128).to(torch.int32)
    zero = torch.zeros_like(v)
    vals = torch.stack([more, v & 127, zero, v >> 7], dim=-1)
    bits = torch.stack([torch.ones_like(v), torch.full_like(v, 7), more, 7 * more], dim=-1)
    return vals, bits


def huffman_table_tokens(numl, ordered_sym, sigma, longest):
    """Token slots [B, N_TABLE_TOKENS] (values, widths) of each block's
    serialized table, leading flag bit included (coders/huffman.py:109-114,
    HuffmanCoder.hpp:264). Degenerate blocks (sigma <= 1) emit only the
    flag-0 bit; slots past a block's table have width 0."""
    i32 = torch.int32
    numl, ordered_sym, sigma, longest = (x.to(i32) for x in (numl, ordered_sym, sigma, longest))
    B = sigma.shape[0]
    dev = sigma.device
    normal = (sigma >= 2).to(i32)[:, None]
    vals = [normal]
    bits = [torch.ones((B, 1), dtype=i32, device=dev)]

    cv, cb = _compressed_int_tokens(longest)
    vals.append(cv)
    bits.append(cb * normal)
    cv, cb = _compressed_int_tokens(numl)  # [B, 32, 4]
    lidx = torch.arange(MAX_LEN, device=dev)
    live = (lidx[None, :] < longest[:, None]).to(i32) * normal
    vals.append(cv.reshape(B, -1))
    bits.append((cb * live[:, :, None]).reshape(B, -1))
    cv, cb = _compressed_int_tokens(sigma)
    vals.append(cv)
    bits.append(cb * normal)
    pos = torch.arange(256, device=dev)
    vals.append(ordered_sym)
    bits.append(8 * (pos[None, :] < sigma[:, None]).to(i32) * normal)
    return torch.cat(vals, dim=1), torch.cat(bits, dim=1)


def _encode_with_tables(blocks, n_valid, t: HuffmanTables, n_words: int):
    """Header tokens -> kernel A; per-byte lookup + pack -> kernel B. Tables
    of batch 1 (a shared table) code every block: the header is packed once
    and broadcast to the batch."""
    normal = (t.sigma >= 2)[:, None]
    iota = torch.arange(256, dtype=torch.int32, device=blocks.device)[None, :]
    # normal blocks use the canonical code, degenerate ones raw 8-bit literals
    tbl_v = torch.where(normal, t.cw, iota)
    tbl_nb = torch.where(normal, t.lengths, 8)
    tv, tb = huffman_table_tokens(t.numl, t.ordered_sym, t.sigma, t.longest)
    hdr_words, hdr_bits = pack_blocks(tv, tb, N_TABLE_TOKENS)
    B = blocks.shape[0]
    tbl_v, tbl_nb, hdr_words, hdr_bits = (x.expand(B, *x.shape[1:]) for x in (tbl_v, tbl_nb, hdr_words, hdr_bits))
    return pack_bytes_blocks(blocks, n_valid, tbl_v, tbl_nb, hdr_words, hdr_bits, n_words)


def _check_block_size(bs: int) -> None:
    if bs > MAX_BLOCK:
        raise ValueError(f"block of {bs} bytes is too large for 32-bit code tokens (max {MAX_BLOCK})")


def encode_blocks_from_lengths(blocks, n_valid, lengths, n_words: int):
    """[B, bs] blocks + [B, 256] code lengths -> ([B, n_words] int32 words,
    [B] int32 total bits), the tables derived with the plain chain."""
    _check_block_size(blocks.shape[1])
    tables = HuffmanTables(lengths.to(torch.int32), *canonical_codes_batch(lengths))
    return _encode_with_tables(blocks, n_valid, tables, n_words)


def encode_blocks_with_hists(blocks, n_valid, hists, n_words: int):
    """Encode blocks against given per-block histograms (kernel C builds the tables)."""
    _check_block_size(blocks.shape[1])
    return _encode_with_tables(blocks, n_valid, huffman_tables(hists), n_words)


def shared_tables(hist) -> HuffmanTables:
    """One table from a [256] histogram summed over blocks (counts below
    2^53): huffman_tables64 on a batch of one, kernel C's int64 instance
    on a CUDA tensor, its plain chain on a CPU tensor. A HuffmanTables of
    batch 1; raises ValueError where the code would need more than 32
    bits."""
    return huffman_tables64(hist.reshape(1, 256))


def encode_blocks(blocks, n_valid, n_words: int, shared_table: HuffmanTables | None = None):
    """Encode [B, bs] u8 blocks -> ([B, n_words] int32 words, [B] int32 total bits).

    n_valid [B] gives per-block byte counts; bytes past them are skipped,
    histogram included. Arenas hold u32 bit patterns; bits past n_words are
    dropped. With shared_table (batch 1, from shared_tables) that one table
    codes every block and stands in each block's header, so every block
    decodes on its own (huffman_jax.encode_blocks's shared mode). The caller
    builds it from the histogram of the whole input, which the runtime
    encodes in several calls."""
    if shared_table is not None:
        _check_block_size(blocks.shape[1])
        return _encode_with_tables(blocks, n_valid, shared_table, n_words)
    return encode_blocks_with_hists(blocks, n_valid, block_histograms(blocks, n_valid), n_words)
