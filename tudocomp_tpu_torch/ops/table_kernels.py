"""Kernels C and G: the canonical Huffman table stage, with their plain versions.

`huffman_tables` (kernel C) turns [B, 256] byte histograms into each
block's code lengths, canonical codewords, numl, length-ordered symbols,
sigma and longest in one launch. It replaces
tudocomp_tpu/ops/pallas_kernels.py:huffman_tables_pallas. Its plain
version is huffman_torch's code_lengths_batch followed by
canonical_codes_batch, the same chain the JAX package holds its kernel to. Counts must stay below 2^21 (blocks of at most MAX_BLOCK
bytes), where kernel C's int32 (count << 9) | symbol sort key is exact.

`huffman_tables64` is kernel C's int64 instance: the same tables from
histograms whose counts reach 2^53, as the shared-table path's histogram
summed over all blocks does (it passes 2^31 once the input passes 2 GiB).
It ranks by the int64 key and reports a code longer than 32 bits through
the launch path's mapped flag word, raising the ValueError of
code_lengths_batch; its plain version is the same chain as kernel C's.

`moffat_phase12` (kernel G) runs Moffat/Katajainen phases 1 and 2 alone
on [B, 256] sorted int64 weights. It replaces
pallas_kernels.py:moffat_phase12 (_moffat_lockstep_kernel); no user path
calls it since huffman_tables64 builds the shared table in one launch.
All three live in csrc/tables.cu and walk the phases through one
template, so they agree by construction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .bitpack_cuda import on_cuda

__all__ = [
    "HuffmanTables",
    "depth_error",
    "huffman_tables",
    "huffman_tables64",
    "huffman_tables_plain",
    "moffat_phase12",
    "moffat_phase12_plain",
]

MAX_LEN = 32  # code length slots 1..MAX_LEN: the longest code the pack and decode kernels take


class HuffmanTables(NamedTuple):
    """Per-block table set; every field is int32, cw holds u32 bit patterns."""

    lengths: torch.Tensor  # [B, 256] code length per symbol, 0 = absent
    cw: torch.Tensor  # [B, 256] canonical codeword per symbol
    numl: torch.Tensor  # [B, 32] symbols per code length 1..32
    ordered_sym: torch.Tensor  # [B, 256] symbols by (length, symbol), 0-padded
    sigma: torch.Tensor  # [B] coded symbols (0 for degenerate blocks)
    longest: torch.Tensor  # [B] longest code length


def huffman_tables_plain(hists) -> HuffmanTables:
    """Plain version of huffman_tables and huffman_tables64 (code_lengths_batch
    raises past MAX_LEN bits)."""
    from .huffman_torch import canonical_codes_batch, code_lengths_batch

    lengths = code_lengths_batch(hists)
    return HuffmanTables(lengths, *canonical_codes_batch(lengths))


def depth_error(longest: int) -> ValueError:
    """The error for a code that needs `longest` > MAX_LEN bits."""
    return ValueError(
        f"the Huffman code needs {longest}-bit codes, more than the {MAX_LEN} bits the pack and "
        "decode kernels take: the histogram is too skewed for one table"
    )


def _outputs(B: int, dev) -> HuffmanTables:
    i32 = torch.int32
    sq = [torch.empty((B, 256), dtype=i32, device=dev) for _ in range(3)]
    return HuffmanTables(sq[0], sq[1], torch.empty((B, MAX_LEN), dtype=i32, device=dev), sq[2],
                         torch.empty(B, dtype=i32, device=dev), torch.empty(B, dtype=i32, device=dev))


def huffman_tables(hists) -> HuffmanTables:
    """[B, 256] histograms -> the blocks' HuffmanTables.

    Degenerate blocks (sigma <= 1) get all-zero lengths, codewords and
    metadata; their bytes are coded raw."""
    if not on_cuda(hists):
        return huffman_tables_plain(hists)
    B = hists.shape[0]
    t = _outputs(B, hists.device)
    if B:
        kernels.launch("tdc_huffman_tables", hists.to(torch.int32).contiguous(), B, *t)
    return t


def huffman_tables64(hists) -> HuffmanTables:
    """[B, 256] histograms of counts below 2^53 -> their HuffmanTables, as
    huffman_tables gives them; raises ValueError (depth_error) where a
    code would need more than MAX_LEN bits. On a CUDA tensor: kernel C's
    int64 instance, one launch and one wait."""
    if not on_cuda(hists):
        return huffman_tables_plain(hists)
    B = hists.shape[0]
    t = _outputs(B, hists.device)
    if B and kernels.launch_flagged("tdc_huffman_tables64", hists.to(torch.int64).contiguous(), B, *t):
        raise depth_error(int(t.longest.max()))
    return t


def _check_moffat(weights, sigma) -> None:
    """Shapes and types only: reading sigma's values would wait for the
    device. Both versions clamp sigma to [0, 256]."""
    if weights.dim() != 2 or weights.shape[1] != 256 or weights.dtype != torch.int64:
        raise TypeError(f"weights must be a [B, 256] int64 tensor, not {weights.dtype} {tuple(weights.shape)}")
    if tuple(sigma.shape) != (weights.shape[0],):
        raise ValueError(f"sigma has shape {tuple(sigma.shape)}, not ({weights.shape[0]},)")


def moffat_phase12_plain(weights, sigma):
    """Plain version of moffat_phase12: every row advances one step of
    phase 1, then of phase 2, in lockstep (the TPU kernel's order)."""
    _check_moffat(weights, sigma)
    B = weights.shape[0]
    dev = weights.device
    m = sigma.to(torch.int64).clamp(0, 256)
    # column 256 stays 0, the value of an out-of-range read
    A = torch.cat([weights, torch.zeros((B, 1), dtype=torch.int64, device=dev)], dim=1)
    bi = torch.arange(B, device=dev)
    ok = m >= 2
    A[:, 0] = torch.where(ok, A[:, 0] + A[:, 1], A[:, 0])
    root = torch.zeros(B, dtype=torch.int64, device=dev)
    leaf = torch.full((B,), 2, dtype=torch.int64, device=dev)
    m_max = int(m.max()) if B else 0

    def pick(root, leaf, t, first):
        a_root = A[bi, root]
        a_leaf = A[bi, leaf.clamp(max=256)]
        use = (leaf >= m) | (a_root < a_leaf) if first else (
            (leaf >= m) | ((root < t) & (a_root < a_leaf))
        )
        return torch.where(use, a_root, a_leaf), use

    for t in range(1, max(m_max - 1, 1)):
        active = t < m - 1
        v1, use1 = pick(root, leaf, t, True)
        A[bi, root] = torch.where(active & use1, t, A[bi, root])
        root1, leaf1 = root + use1, leaf + ~use1
        A[:, t] = torch.where(active, v1, A[:, t])
        v2, use2 = pick(root1, leaf1, t, False)
        A[bi, root1] = torch.where(active & use2, t, A[bi, root1])
        root = torch.where(active, root1 + use2, root)
        leaf = torch.where(active, leaf1 + ~use2, leaf)
        A[:, t] = torch.where(active, v1 + v2, A[:, t])

    last = (m - 2).clamp(min=0)
    A[bi, last] = torch.where(ok, 0, A[bi, last])
    for j in range(max(m_max - 2, 0)):
        nxt = m - 3 - j
        nc = nxt.clamp(min=0)
        parent = A[bi, A[bi, nc].clamp(0, 256)]
        A[bi, nc] = torch.where(nxt >= 0, parent + 1, A[bi, nc])
    return A[:, :256]


def moffat_phase12(weights, sigma):
    """Moffat/Katajainen phases 1 and 2: weights [B, 256] int64, ascending
    over each row's first sigma[b] slots, and sigma [B] -> A [B, 256] int64
    whose slots 0..sigma-2 hold the internal nodes' depths. Other slots
    keep their weights, and rows with sigma <= 1 come back unchanged, as
    _moffat_lockstep_kernel leaves them. Ties prefer the leaf. sigma is
    clamped to [0, 256]."""
    if not on_cuda(weights, sigma):
        return moffat_phase12_plain(weights, sigma)
    _check_moffat(weights, sigma)
    B = weights.shape[0]
    out = torch.empty((B, 256), dtype=torch.int64, device=weights.device)
    if B:
        kernels.launch("tdc_moffat_phase12", weights.contiguous(), sigma.to(torch.int32).contiguous(), B, out)
    return out
