"""Device-side lcpcomp: the PLCP-peaks factorization and the chain-resolving
decode, in torch on an explicit device.

The port of tudocomp_tpu/ops/lcpcomp_jax.py. Both stages are plain torch:
the JAX package holds no Pallas kernel here.

Compress: the priority-queue strategies (arrays, heap, bheap, max_lcp,
plcp) change the LCP array after every pick and stay on the host. The
`plcppeaks` strategy (lcpcomp/compress/PLCPPeaksStrategy.hpp:33-80) is a
greedy left-to-right walk i += plcp[i] over a peak test that each position
decides alone: the peak test is elementwise, and the walk is the orbit
doubling of ops/lzss_torch.greedy_visited. The factors equal the host
strategy's (tdc_lcpcomp_plcppeaks_factorize).

Decompress: every decoder of the `dec` axis (scan, compact, QueueListBuffer,
MultimapListBuffer) writes the same bytes; the axis trades time for space on
a pointer machine. Here every position's source chain (p -> src + (p - tgt),
factor after factor, until a literal) collapses by pointer doubling: the map
is built on the device (repeat_interleave and a cumsum), then ceil(log2 n)
+ 1 rounds of m = m[m], a fixed count with no host sync between rounds,
then one gather of the literals.
"""

from __future__ import annotations

import numpy as np
import torch

from .lzss_torch import greedy_visited

__all__ = ["plcppeaks_candidates", "plcppeaks_factorize_device", "resolve_factors_device"]


def plcppeaks_candidates(plcp: torch.Tensor, threshold: int):
    """Peak test and walk step of every position (PLCPPeaksStrategy.hpp:33-80).

    C(0) = plcp[0] > plcp[1] (the i == last_replacement_pos clause, live
    only at i = 0); C(i > 0) = plcp[i] > plcp[i-1] and plcp[i] > plcp[i+1];
    both also need plcp[i] >= threshold and i + 1 < n. step = max(plcp, 1)
    where C holds, 1 elsewhere. Returns (cond [n] bool, step [n] int64).
    """
    plcp = plcp.to(torch.int64)
    n = plcp.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=plcp.device)
    zero = plcp.new_zeros(1)
    prv = torch.cat([zero, plcp[:-1]])
    nxt = torch.cat([plcp[1:], zero])
    rising = (idx == 0) | (plcp > prv)
    cond = rising & (plcp > nxt) & (plcp >= threshold) & (idx + 1 < n)
    step = torch.where(cond, plcp.clamp(min=1), torch.ones_like(plcp))
    return cond, step


def plcppeaks_factorize_device(sa: torch.Tensor, isa: torch.Tensor, plcp: torch.Tensor, threshold: int):
    """The factors of tdc_lcpcomp_plcppeaks_factorize, from the SA, ISA and
    PLCP on their device. Returns host int64 arrays (pos, src, len) in
    position order (the walk emits left to right), in one transfer."""
    n = int(sa.shape[0])
    if n == 0:
        e = np.zeros(0, np.int64)
        return e, e, e
    cond, step = plcppeaks_candidates(plcp, threshold)
    sel = greedy_visited(step) & cond
    pos = torch.nonzero(sel).squeeze(1)
    src = sa.to(torch.int64)[(isa.to(torch.int64)[pos] - 1).clamp(min=0)]
    out = torch.stack([pos, src, plcp.to(torch.int64)[pos]]).cpu().numpy()
    return out[0], out[1], out[2]


def resolve_factors_device(buffer: np.ndarray, tgt, src, lens, device) -> np.ndarray:
    """Fill the positions that the factors produce by collapsing their
    source chains on `device`.

    buffer: [n] uint8 on the host with the literals placed, 0 where a
    factor writes. The factors' target ranges are disjoint (lcpcomp
    replaces disjoint ranges of the text); chains run forward or backward
    and end at literals in a well-formed stream. A chain that ends nowhere
    leaves a 0, which the caller reports (ScanDec.hpp's undecodable check).
    Returns the filled buffer, a new host array.
    """
    n = len(buffer)
    if n == 0 or len(tgt) == 0:
        return buffer
    device = torch.device(device)
    lens_h = np.asarray(lens, np.int64)
    if np.any(np.asarray(src, np.int64) + lens_h > n):
        raise ValueError("corrupt lcpcomp stream: a factor's source runs past the text")
    total = int(lens_h.sum())

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    tgt_d, src_d, lens_d = up(tgt), up(src), up(lens_h)
    # target positions: arange(total) shifted, factor by factor, from the
    # factor's offset among the targets to its target; sources sit at a
    # fixed distance (src - tgt) from their targets
    offs = torch.cumsum(lens_d, 0) - lens_d
    pos = torch.arange(total, dtype=torch.int64, device=device)
    pos += torch.repeat_interleave(tgt_d - offs, lens_d, output_size=total)
    dist = torch.repeat_interleave(src_d - tgt_d, lens_d, output_size=total)
    # the map stays int32; index_select takes an int32 index as it is
    m = torch.arange(n, dtype=torch.int32, device=device)
    m[pos] = (pos + dist).to(torch.int32)
    for _ in range(max(1, (n - 1).bit_length()) + 1):
        m = torch.index_select(m, 0, m)
    buf = torch.from_numpy(np.ascontiguousarray(buffer, np.uint8)).to(device)
    return torch.index_select(buf, 0, m).cpu().numpy()
