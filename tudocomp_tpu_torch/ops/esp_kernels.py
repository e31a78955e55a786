"""Kernel I: the ESP adjust pass's queue machine, a lane a span.

`esp_adjust_windows` runs the 3-slot queue of compressors/esp.py:
_adjust_blocks (the reference's BlockAdjust.hpp:38-131) over each span of a
round's blocks, in place: CUDA tensors go to kernel I (csrc/esp.cu: a
persistent grid, a warp a group of 32 spans staged in shared memory, a lane
a span, the queue in registers, one launch a round), CPU tensors to
`esp_adjust_windows_plain`, the JAX package's _sim_window
(tudocomp_tpu/ops/esp_jax.py:87-199) batched over all spans in torch, with
masked steps until every span drains. The spans come from
ops/esp_torch.adjust_spans.
"""

from __future__ import annotations

import torch

from .. import kernels
from .bitpack_cuda import on_cuda

__all__ = ["esp_adjust_windows", "esp_adjust_windows_plain"]

_I32 = torch.int32
SLOT = 64  # csrc/esp.cu: the widest span a warp stages in shared memory
CAP = 1024  # csrc/esp.cu: the blocks a warp stages; wider or later spans walk device memory


def _check(lens, typs, ws, we, ns) -> None:
    for t in (lens, typs, ws, we, ns):
        if t.dtype != _I32 or t.dim() != 1:
            raise ValueError("expected 1-d int32 tensors")
    if typs.shape != lens.shape or we.shape != ws.shape or ns.shape != (1,):
        raise ValueError("expected lens, typs [size], ws, we [spans] and ns [1]")
    if not (lens.is_contiguous() and typs.is_contiguous()):
        raise ValueError("lens and typs are adjusted in place: expected contiguous tensors")


def esp_adjust_windows(lens, typs, ws, we, ns) -> None:
    """Runs the queue machine over each span [ws[s], we[s]) for s < ns[0]
    (ws, we int32 [spans], disjoint; ns int32 [1]) of the blocks (lens,
    typs), int32 [size], which it overwrites: each span's output blocks at
    its start, its slots freed by merges with length 0, every other block
    as it was."""
    _check(lens, typs, ws, we, ns)
    if not on_cuda(lens, typs, ws, we, ns):
        esp_adjust_windows_plain(lens, typs, ws, we, ns)
        return
    kernels.launch("tdc_esp_adjust", lens, typs, ws.contiguous(), we.contiguous(), ns, int(ws.shape[0]))


def esp_adjust_windows_plain(lens, typs, ws, we, ns) -> None:
    """Plain version of esp_adjust_windows, in place as well: the queue
    machine of every span stepped together in torch (a host sync a step
    for the drain test)."""
    _check(lens, typs, ws, we, ns)
    dev = lens.device
    size = int(lens.shape[0])
    S = int(ws.shape[0])
    L = torch.cat([lens, torch.zeros(1, dtype=_I32, device=dev)])  # slot `size`: writes of idle lanes
    T = torch.cat([typs, torch.zeros(1, dtype=_I32, device=dev)])
    live = torch.arange(S, device=dev) < ns.to(torch.int64)
    base = ws.to(torch.int64)
    navail = torch.where(live, we - ws, 0)
    z = torch.zeros(S, dtype=_I32, device=dev)
    l0, l1, l2, t0, t1, t2, qn, ip, op = (z.clone() for _ in range(9))
    while True:
        act = (qn > 0) | (ip < navail)
        if not bool(act.any()):
            break
        can_fill = act & (qn < 3) & (ip < navail)
        any1 = ((l0 == 1) & (qn > 0)) | ((l1 == 1) & (qn > 1)) | ((l2 == 1) & (qn > 2))
        n01 = (l0 == 1) | (l1 == 1)
        n12 = (l1 == 1) | (l2 == 1)
        cond_a = (qn == 3) & any1 & n12 & (t1 == 2) & (t2 == 2)
        cond_b = (qn >= 2) & any1 & n01 & (t0 == 2) & (t1 == 2)
        cond_c = (qn >= 2) & any1 & n01 & (t0 == 3)
        cond_d = (qn >= 2) & any1 & n01 & ((t0 == 1) | (t1 == 1))
        can_merge = act & ~can_fill & (cond_a | cond_b | cond_c | cond_d)
        can_pop = act & ~can_fill & ~can_merge & (qn > 0)
        mt = torch.where(cond_a | cond_b, 2, torch.where(cond_c, 3, 1)).to(_I32)

        # fill: slot qn gets block ws + ip
        fidx = torch.where(can_fill, base + ip, size)
        bl, bt = L[fidx], T[fidx]
        f = [(torch.where(qn == k, bl, lk), torch.where(qn == k, bt, tk))
             for k, (lk, tk) in enumerate(((l0, t0), (l1, t1), (l2, t2)))]

        # merge at (mi, mi + 1): mi = 1 for cond_a, else 0
        s = torch.where(cond_a, l1 + l2, l0 + l1)
        small = s <= 3
        two = torch.full_like(s, 2)
        m_l0 = torch.where(cond_a, l0, torch.where(small, s, two))
        m_t0 = torch.where(cond_a, t0, mt)
        m_l1 = torch.where(small, torch.where(cond_a, s, l2), two)
        m_t1 = torch.where(small & ~cond_a, t2, mt)
        m_l2 = torch.where(small | ~cond_a, l2, two)
        m_t2 = torch.where(small | ~cond_a, t2, mt)

        # pop: emit q[0] at ws + op, shift down
        pidx = torch.where(can_pop, base + op, size)
        L[pidx] = l0
        T[pidx] = t0

        def sel(fv, mv, pv, cur):
            return torch.where(can_fill, fv, torch.where(can_merge, mv, torch.where(can_pop, pv, cur)))

        l0, t0, l1, t1, l2, t2 = (
            sel(f[0][0], m_l0, l1, l0), sel(f[0][1], m_t0, t1, t0),
            sel(f[1][0], m_l1, l2, l1), sel(f[1][1], m_t1, t2, t1),
            sel(f[2][0], m_l2, l2, l2), sel(f[2][1], m_t2, t2, t2),
        )
        qn = qn + can_fill.to(_I32) - (can_merge & small).to(_I32) - can_pop.to(_I32)
        ip = ip + can_fill.to(_I32)
        op = op + can_pop.to(_I32)
    # the slots [ws + op, we) that merges freed get length 0
    edge = torch.zeros(size + 2, dtype=_I32, device=dev)
    one = torch.ones(S, dtype=_I32, device=dev)
    edge.index_add_(0, torch.where(live, base + op, size + 1), one)
    edge.index_add_(0, torch.where(live, we.to(torch.int64), size + 1), -one)
    freed = torch.cumsum(edge[:size], 0) > 0
    lens.copy_(torch.where(freed, 0, L[:size]))
    typs.copy_(T[:size])
