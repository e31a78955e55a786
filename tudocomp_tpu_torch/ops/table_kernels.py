"""Kernels C and G: the canonical Huffman table stage, with their plain versions.

`huffman_tables` (kernel C) turns [B, 256] byte histograms into each
block's code lengths, canonical codewords, numl, length-ordered symbols,
sigma and longest in one launch. It replaces
tudocomp_tpu/ops/pallas_kernels.py:huffman_tables_pallas. Its plain
version is huffman_torch's code_lengths_batch (with moffat_phase12_plain)
followed by canonical_codes_batch, the same chain the JAX package holds
its kernel to. Counts must stay below 2^21 (blocks of at most MAX_BLOCK
bytes), where kernel C's int32 (count << 9) | symbol sort key is exact.

`moffat_phase12` (kernel G) runs Moffat/Katajainen phases 1 and 2 on
[B, 256] sorted int64 weights: the table of the shared-table path, built
from a histogram summed over all blocks, whose counts pass 2^31 once the
input passes 2 GiB. It replaces pallas_kernels.py:moffat_phase12
(_moffat_lockstep_kernel). Both CUDA sources are csrc/tables.cu, and both
kernels walk the phases through one function, so they agree by
construction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .bitpack_cuda import on_cuda

__all__ = ["HuffmanTables", "huffman_tables", "huffman_tables_plain", "moffat_phase12", "moffat_phase12_plain"]


class HuffmanTables(NamedTuple):
    """Per-block table set; every field is int32, cw holds u32 bit patterns."""

    lengths: torch.Tensor  # [B, 256] code length per symbol, 0 = absent
    cw: torch.Tensor  # [B, 256] canonical codeword per symbol
    numl: torch.Tensor  # [B, 32] symbols per code length 1..32
    ordered_sym: torch.Tensor  # [B, 256] symbols by (length, symbol), 0-padded
    sigma: torch.Tensor  # [B] coded symbols (0 for degenerate blocks)
    longest: torch.Tensor  # [B] longest code length


def huffman_tables_plain(hists) -> HuffmanTables:
    """Plain version of huffman_tables."""
    from .huffman_torch import canonical_codes_batch, code_lengths_batch

    lengths = code_lengths_batch(hists, moffat_phase12_plain)
    return HuffmanTables(lengths, *canonical_codes_batch(lengths))


def huffman_tables(hists) -> HuffmanTables:
    """[B, 256] histograms -> the blocks' HuffmanTables.

    Degenerate blocks (sigma <= 1) get all-zero lengths, codewords and
    metadata; their bytes are coded raw."""
    if not on_cuda(hists):
        return huffman_tables_plain(hists)
    B = hists.shape[0]
    dev = hists.device
    out = [torch.empty((B, 256), dtype=torch.int32, device=dev) for _ in range(3)]
    numl = torch.empty((B, 32), dtype=torch.int32, device=dev)
    sigma = torch.empty(B, dtype=torch.int32, device=dev)
    longest = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        kernels.launch(
            "tdc_huffman_tables", hists.to(torch.int32).contiguous(), B,
            out[0], out[1], numl, out[2], sigma, longest,
        )
    return HuffmanTables(out[0], out[1], numl, out[2], sigma, longest)


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
