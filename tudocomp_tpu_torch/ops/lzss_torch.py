"""Device-side lzss_lcp factorization: parallel ANSV + greedy parse, in torch.

The port of tudocomp_tpu/ops/lzss_jax.py. The reference factorizer
(compressors/LZSSLCPCompressor.hpp:60-115) walks the text left to right and,
per position, scans the suffix array for the previous/next smaller value
(PSV/NSV) while folding the minimum LCP along the way. The host path does
that with O(n) monotone stacks (C++ tdc_lzss_lcp_factorize). This module is
the parallel formulation:

  1. ANSV with min-LCP: pointer doubling over the "previous/next smaller"
     candidate chain, O(log n) rounds of two gathers, carrying the range
     minimum of LCP alongside the candidate pointer.
  2. Greedy left-to-right factor selection: the walk i += max(len_i, 1) is
     an orbit of a jump function f; the visited set is computed by orbit
     doubling (v |= v∘f^(2^k); f^(2^(k+1)) = f^(2^k)∘f^(2^k)), O(log n)
     rounds of one gather and one scatter.

The JAX package drains its unresolved ANSV elements through work arrays of
fixed sizes, because its shapes are static; here each round simply keeps
the elements that are still unresolved (one host sync a round). Outputs
match tdc_lzss_lcp_factorize exactly: ties prefer PSV, factors need
len >= threshold, position n-1 never starts a factor. Everything is plain
torch on the tensors' device; index tensors are int64, results int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_host
from ..stats.phase import StatPhase

__all__ = ["ansv_minlcp", "greedy_visited", "lzss_lcp_candidates", "lzss_lcp_factorize_device"]


def _chase(sa, p, m, found):
    """Jump every unresolved candidate pointer along its chain until
    `found(p, sa[p], sa_own)` holds everywhere; m folds the min of the
    ranges jumped over. p, m: [n] int64, updated in place."""
    n = sa.shape[0]
    ids = torch.arange(n, dtype=torch.int64, device=sa.device)
    while True:
        pc = p[ids]
        live = ~found(pc, sa[pc.clamp(0, n - 1)], sa[ids])
        ids = ids[live]
        if ids.shape[0] == 0:
            return p, m
        c = pc[live]  # in range: an unresolved candidate is a real position
        p2 = p[c]
        m2 = torch.minimum(m[ids], m[c])
        p[ids] = p2
        m[ids] = m2


def ansv_minlcp(sa: torch.Tensor, lcp: torch.Tensor):
    """PSV/NSV over the SA with folded min-LCP, by chain jumps.

    Args: sa [n], lcp [n] (lcp[0] = 0), integer tensors on one device.
    Returns (psv_src, psv_lcp, nsv_src, nsv_lcp), each [n] int32;
    src = sa[psv/nsv position] or -1 where none exists, lcp = min LCP over
    the skipped SA range (0 where none).
    """
    sa = sa.to(torch.int64)
    lcp = lcp.to(torch.int64)
    n = sa.shape[0]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=sa.device)
        return z, z, z, z
    idx = torch.arange(n, dtype=torch.int64, device=sa.device)
    zero = torch.zeros((), dtype=torch.int64, device=sa.device)

    # PSV: candidate left neighbour; m covers lcp over (p, j]
    found1 = (idx == 0) | (torch.roll(sa, 1) < sa)
    p = torch.where(found1, idx - 1, idx - 2)
    m = torch.where(found1, lcp, torch.minimum(lcp, torch.roll(lcp, 1)))
    p, m = _chase(sa, p, m, lambda p, sa_p, sa_own: (p < 0) | (sa_p < sa_own))
    ok = p >= 0
    psv_src = torch.where(ok, sa[p.clamp(min=0)], -1)
    psv_lcp = torch.where(ok, m, zero)

    # NSV: candidate right neighbour; m covers lcp over (j, p]
    lcp_next = torch.where(idx + 1 < n, torch.roll(lcp, -1), zero)
    lcp_next2 = torch.where(idx + 2 < n, torch.roll(lcp, -2), zero)
    foundn = (idx == n - 1) | (torch.roll(sa, -1) < sa)
    p = torch.where(foundn, idx + 1, idx + 2)
    m = torch.where(foundn, lcp_next, torch.minimum(lcp_next, lcp_next2))
    p, m = _chase(sa, p, m, lambda p, sa_p, sa_own: (p >= n) | (sa_p < sa_own))
    ok = p < n
    nsv_src = torch.where(ok, sa[p.clamp(max=n - 1)], -1)
    nsv_lcp = torch.where(ok, m, zero)
    i32 = torch.int32
    return psv_src.to(i32), psv_lcp.to(i32), nsv_src.to(i32), nsv_lcp.to(i32)


def greedy_visited(step: torch.Tensor) -> torch.Tensor:
    """Visited set of the walk i_{k+1} = i_k + step[i_k] from 0.

    step [n] integer (values below 1 count as 1). Returns visited [n] bool,
    by orbit doubling.
    """
    n = step.shape[0]
    dev = step.device
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    g = torch.empty(n + 1, dtype=torch.int64, device=dev)  # g[n] = n: the sink
    g[:n] = (idx + step.to(torch.int64).clamp(min=1)).clamp(max=n)
    g[n] = n
    v = torch.zeros(n + 1, dtype=torch.int32, device=dev)  # v[n]: the sink's slot
    v[0] = 1
    for _ in range(max(1, (n - 1).bit_length()) + 1):
        # v' = v | image of v under g (indices collide: scatter-max); g' = g o g
        v.scatter_reduce_(0, g, v.clone(), "amax")
        g = g[g]
    return v[:n] > 0


def lzss_lcp_candidates(sa, isa, lcp, threshold: int):
    """Per text position: greedy-walk step, factor length and source.

    Returns (step, flen, fsrc), each [n] int32 in TEXT order:
    flen[i] >= threshold means position i would emit factor (i, fsrc, flen)
    if visited; step[i] = flen[i] or 1. Position n-1 never factors.
    """
    n = sa.shape[0]
    psv_src, psv_lcp, nsv_src, nsv_lcp = ansv_minlcp(sa, lcp)
    use_psv = psv_lcp >= nsv_lcp  # ties prefer PSV (reference)
    maxl = torch.where(use_psv, psv_lcp, nsv_lcp)
    msrc = torch.where(use_psv, psv_src, nsv_src)
    # to text order
    isa = isa.to(torch.int64)
    maxl_t = maxl[isa]
    msrc_t = msrc[isa]
    idx = torch.arange(n, dtype=torch.int64, device=sa.device)
    is_factor = (maxl_t >= threshold) & (idx + 1 < n)
    one = torch.ones((), dtype=torch.int32, device=sa.device)
    step = torch.where(is_factor, maxl_t, one)
    flen = torch.where(is_factor, maxl_t, one - 1)
    return step, flen, msrc_t


def lzss_lcp_factorize_device(sa, isa, lcp, threshold: int):
    """Full device factorization; returns host arrays (pos, src, len), int64.

    Mirrors tdc_lzss_lcp_factorize output exactly.
    """
    n = int(sa.shape[0])
    if n == 0:
        e = np.zeros(0, np.int64)
        return e, e, e
    step, flen, fsrc = lzss_lcp_candidates(sa, isa, lcp, threshold)
    pos = torch.nonzero(greedy_visited(step) & (flen > 0)).squeeze(1)
    with StatPhase("Factors to host"):
        return (
            to_host(pos),
            to_host(fsrc[pos].to(torch.int64)),
            to_host(flen[pos].to(torch.int64)),
        )
