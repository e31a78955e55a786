"""Device PLCP: kernel H on the card, lockstep segment walks in plain torch.

The port of tudocomp_tpu/ops/plcp_jax.py. `plcp_device` picks its route by
the device of its input: CUDA tensors go to kernel H (csrc/plcp.cu: phi
from the SA on the card, then one chain of positions per lane running the
sequential algorithm, in levels; one launch a call), CPU tensors to
`plcp_device_plain`, the JAX function's formulation in torch, described
below. Kärkkäinen's phi-algorithm
(reference ds/PLCPFromPhi.hpp:38-44) is sequential: plcp[i] starts at
plcp[i-1]-1, so the character comparisons telescope to O(n + max_lcp). A
naive parallel version loses that (every member of a repeat run grinds its
own full lcp).

This formulation keeps the amortization: the text is cut into S segments;
each segment is walked SEQUENTIALLY by one lane (keeping the l >= l_prev - 1
bound within the segment), and the S lanes step together. Each step does
one 4-byte word compare per lane (two gathers), takes the exact byte advance
from the XOR (big-endian packing), and either extends l or finalizes the
position and moves on. Only segment leaders re-grind. On a GPU every step is
a dozen small launches and one host sync, so the plain walk is launch-bound:
hence the kernel. TextDS takes its PLCP and LCP from here when its suffix
array was built on the device and lies there still (ds/textds.py); the JAX
package's TextDS always takes the C++ PLCP.

Exactness requires the TextDS contract: the text's last byte is its unique
0 sentinel (escaped input), so 0-padded out-of-range words can never
compare equal to an in-range window and word equality == 4 matching bytes.
"""

from __future__ import annotations

import torch

from .. import kernels
from .bitpack_cuda import on_cuda

__all__ = ["lcp_device", "lcp_from_plcp_device", "plcp_device", "plcp_device_plain"]

# Segment length of the plain walk when plcp_device runs it on the CPU
# (TextDS under TDC_DEVICE_SA=1 with device="cpu"). Each step is a dozen
# torch calls over all lanes, so the walk's length (seg steps and more)
# costs more there than its width: 256 keeps texts of a few KiB to a few
# hundred KiB to a few hundred steps, where 4096 walks thousands. The PLCP
# is the same at every seg.
CPU_SEG = 256


def _phi(sa: torch.Tensor) -> torch.Tensor:
    """phi[sa[i]] = sa[i-1]; phi[sa[0]] = sa[n-1] (PhiFromSA.hpp:37-45)."""
    phi = torch.empty_like(sa)
    phi[sa] = torch.roll(sa, 1)
    return phi


def plcp_device(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """[n] u8 text (unique 0 sentinel last) + [n] SA -> [n] i32 PLCP.

    Bit-exact twin of plcp_from_phi_numpy / C++ tdc_plcp_from_phi.
    """
    if not on_cuda(text, sa):
        return plcp_device_plain(text, sa, seg=CPU_SEG)
    if text.dtype != torch.uint8 or text.dim() != 1 or sa.shape != text.shape:
        raise ValueError("expected a [n] uint8 text and its [n] suffix array")
    n = int(text.shape[0])
    plcp = torch.empty(n, dtype=torch.int32, device=text.device)
    if n == 0:
        return plcp
    text = text.contiguous()
    if text.data_ptr() % 8:  # the kernel reads the text as aligned 8-byte words
        text = text.clone()
    phi = torch.empty_like(plcp)  # scratch: the kernel writes phi from the SA
    # chains 0: the kernel sizes each level's chains from its positions
    kernels.launch("tdc_plcp_segments", text, sa.to(torch.int32).contiguous(), n, 0, phi, plcp)
    return plcp


def plcp_device_plain(text: torch.Tensor, sa: torch.Tensor, seg: int = 4096) -> torch.Tensor:
    """Plain version of plcp_device: S lanes walking their segments of
    `seg` positions in lockstep; the result does not depend on `seg`."""
    n = int(text.shape[0])
    dev = text.device
    I64 = torch.int64
    if n <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    seg = max(64, min(seg, n))
    S = (n + seg - 1) // seg
    sa = sa.to(I64)

    phi = _phi(sa)

    # big-endian 4-byte windows, zero past the end; int64 holds the 32 bits
    t = torch.zeros(n + 3, dtype=I64, device=dev)
    t[:n] = text.to(I64)
    w4 = (t[:n] << 24) | (t[1 : n + 1] << 16) | (t[2 : n + 2] << 8) | t[3 : n + 3]

    base = torch.arange(S, dtype=I64, device=dev) * seg
    p = torch.zeros(S, dtype=I64, device=dev)
    l = torch.zeros(S, dtype=I64, device=dev)
    ph = phi[base]
    plcp = torch.zeros(n + 1, dtype=torch.int32, device=dev)  # slot n: the sink
    while True:
        i = base + p
        running = (p < seg) & (i < n)
        if not bool(running.any()):
            break
        # i == n-1 keeps plcp 0 (reference loop bound i < n-1)
        active = running & (i < n - 1)
        x = w4[(i + l).clamp(max=n - 1)] ^ w4[(ph + l).clamp(max=n - 1)]
        adv = (x < (1 << 24)).to(I64) + (x < (1 << 16)) + (x < (1 << 8)) + (x == 0)
        l = torch.where(active, l + adv, l)
        fin = active & (adv < 4)
        plcp[torch.where(fin, i, n)] = torch.where(fin, l, 0).to(torch.int32)
        skip = running & (i >= n - 1)
        stepping = fin | skip
        p = torch.where(stepping, p + 1, p)
        ph = torch.where(stepping, phi[(base + p).clamp(max=n - 1)], ph)
        l = torch.where(fin, (l - 1).clamp(min=0), l)
        l = torch.where(skip, 0, l)
    return plcp[:n]


def lcp_from_plcp_device(plcp: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """LCP[i] = PLCP[sa[i]], LCP[0] = 0 (LCPFromPLCP.hpp:38-49), device."""
    if plcp.shape[0] == 0:
        return plcp.clone()
    lcp = plcp[sa.to(torch.int64)]
    lcp[0] = 0
    return lcp


def lcp_device(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """[n] u8 text + [n] SA -> [n] i32 LCP, through plcp_device."""
    return lcp_from_plcp_device(plcp_device(text, sa), sa)
