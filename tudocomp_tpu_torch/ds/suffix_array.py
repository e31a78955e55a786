"""Suffix array construction: prefix doubling, host (numpy) and device (torch).

The port's copy of tudocomp_tpu/ds/suffix_array.py. Output contract of the
reference's divsufsort (util/divsufsort.hpp:46-286, ds/SADivSufSort.hpp):
SA[i] = start of the i-th lexicographically smallest suffix, a shorter
suffix before every longer one it prefixes. The suffixes of a text are all
distinct, so its SA is unique: every construction here returns the same
array as the C++ SA-IS (csrc/host/tdc_host.cpp, tdc_sais), which TextDS
prefers on the host.

`suffix_array_device` is Larsson-Sadakane prefix doubling on a torch device.
The JAX package's version sorts four rank keys a round and drains its
active set through work arrays of fixed sizes, the answer to a machine
where shapes are static and a gather is dear. Here shapes are dynamic and a
gather is a load: each round sorts only the suffixes whose group is not yet
a singleton, by one int64 key (group head rank, rank at offset k), with
`torch.sort`, as the JAX package leaves its sorts to `lax.sort`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..stats import counters
from ..stats.phase import StatPhase


def suffix_array_numpy(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling SA on host. O(n log^2 n)."""
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    rank = text.astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r_ord = rank[order]
        k2_ord = key2[order]
        new_group = np.ones(n, dtype=np.int64)
        new_group[0] = 0
        new_group[1:] = (r_ord[1:] != r_ord[:-1]) | (k2_ord[1:] != k2_ord[:-1])
        ranks_sorted = np.cumsum(new_group)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = ranks_sorted
        if ranks_sorted[-1] == n - 1:
            return order.astype(np.int32)
        k *= 2


_CHARS0 = 7  # characters in the first sort key: 7 x 9 bits fill a positive int64


def suffix_array_device(text: torch.Tensor, return_isa: bool = False):
    """Prefix-doubling SA on `text.device`. [n] u8 -> [n] i32 (and the ISA).

    Ranks use the head-rank convention (rank = SA index of the group's
    first member), so a suffix alone in its group holds its final SA
    position, the finished rank array is the ISA, and SA is its inverse.
    One host sync a round (the count of suffixes still active). Counts its
    rounds and the keys they sort, summed over the rounds, from host
    integers the loop holds: into the registry (`sa.rounds`, `sa.keys` in
    stats/counters.py) and as the stats `rounds` and `keys` of the open
    StatPhase (TextDS's "Construct SA"), which --stats shows.
    """
    n = int(text.shape[0])
    dev = text.device
    if n <= 1:
        out = torch.zeros(n, dtype=torch.int32, device=dev)
        return (out, out.clone()) if return_isa else out
    I64 = torch.int64
    # first key: _CHARS0 characters, each +1 so the 0 pad past the end
    # orders a shorter suffix first
    cp1 = torch.zeros(n + _CHARS0, dtype=I64, device=dev)
    cp1[:n] = text.to(I64) + 1
    key = cp1[:n].clone()
    for j in range(1, _CHARS0):
        key = (key << 9) | cp1[j : n + j]
    del cp1
    key, pos = torch.sort(key)
    rank = torch.empty(n, dtype=I64, device=dev)
    g = None  # group head rank of each active suffix, in sorted order
    k = _CHARS0
    rounds = keys = 0
    while True:
        m = key.shape[0]
        rounds += 1
        keys += m
        j = torch.arange(m, dtype=I64, device=dev)
        d = torch.ones(m, dtype=torch.bool, device=dev)
        d[1:] = key[1:] != key[:-1]
        sub_head = torch.cummax(torch.where(d, j, 0), 0).values
        if g is None:
            g_new = sub_head  # first round: all n suffixes, slot = SA index
        else:
            gchg = torch.ones(m, dtype=torch.bool, device=dev)
            gchg[1:] = g[1:] != g[:-1]
            g_head = torch.cummax(torch.where(gchg, j, 0), 0).values
            g_new = g + (sub_head - g_head)
        rank[pos] = g_new
        single = d.clone()
        single[:-1] &= d[1:]  # a group of one: head, and the next slot is a head
        keep = ~single
        pos = pos[keep]
        if pos.shape[0] == 0:
            break
        g = g_new[keep]
        # second key: the rank k characters on, -1 (here 0 after +1) past the end
        off = pos + k
        r2 = torch.where(off < n, rank[off.clamp(max=n - 1)] + 1, 0)
        key, order = torch.sort(g * (n + 1) + r2)
        pos = pos[order]
        g = g[order]
        k *= 2
    counters.add("sa.rounds", rounds)
    counters.add("sa.keys", keys)
    ph = StatPhase.current()
    if ph is not None:
        ph.log("rounds", rounds)
        ph.log("keys", keys)
    isa = rank.to(torch.int32)
    sa = torch.empty(n, dtype=torch.int32, device=dev)
    sa[rank] = torch.arange(n, dtype=torch.int32, device=dev)
    return (sa, isa) if return_isa else sa


def _lib_with(fn_name: str):
    from .. import native

    lib = native.get_lib()
    return lib if lib is not None and hasattr(lib, fn_name) else None


def inverse_permutation(sa: np.ndarray) -> np.ndarray:
    """ISA[sa[i]] = i (ds/ISAFromSA.hpp:12-61); prefetched C++ scatter."""
    n = len(sa)
    isa = np.empty(n, dtype=np.int32)
    lib = _lib_with("tdc_inverse_perm") if n else None
    if lib is not None:
        lib.tdc_inverse_perm(np.ascontiguousarray(sa, np.int32), n, isa)
        return isa
    isa[sa] = np.arange(n, dtype=np.int32)
    return isa


def phi_from_sa(sa: np.ndarray) -> np.ndarray:
    """phi[sa[i]] = sa[i-1]; phi[sa[0]] = sa[n-1] (ds/PhiFromSA.hpp:37-45)."""
    n = len(sa)
    phi = np.empty(n, dtype=np.int32)
    if n == 0:
        return phi
    lib = _lib_with("tdc_phi_from_sa")
    if lib is not None:
        lib.tdc_phi_from_sa(np.ascontiguousarray(sa, np.int32), n, phi)
        return phi
    phi[sa[1:]] = sa[:-1]
    phi[sa[0]] = sa[n - 1]
    return phi


def plcp_from_phi_numpy(text: np.ndarray, phi: np.ndarray) -> np.ndarray:
    """Kärkkäinen phi-algorithm (ds/PLCPFromPhi.hpp:38-44), vectorized.

    Chunked compare-and-extend with a max-plus scan propagating the
    plcp[i] >= plcp[i-1]-1 bound between rounds; total compare work stays
    O(n) amortized like the sequential original.
    """
    text = np.asarray(text, dtype=np.uint8)
    n = len(text)
    plcp = np.zeros(n, dtype=np.int64)
    if n <= 1:
        return plcp.astype(np.int32)
    idx = np.arange(n, dtype=np.int64)
    l = np.zeros(n, dtype=np.int64)
    # positions to solve: 0..n-2 (reference loop bound i < n-1)
    active = np.ones(n, dtype=bool)
    active[n - 1] = False
    phi = phi.astype(np.int64)
    chunk = 64
    while active.any():
        # propagate lower bounds: l[i] >= max_j<=i (l[j] + j) - i
        l = np.maximum(l, np.maximum.accumulate(l + idx) - idx)
        ai = np.flatnonzero(active)
        # compare a chunk of characters at i+l vs phi[i]+l
        for _ in range(1):
            a = ai[:, None]
            off = l[ai][:, None] + np.arange(chunk)[None, :]
            p1 = a + off
            p2 = phi[ai][:, None] + off
            ok = (p1 < n) & (p2 < n)
            c1 = text[np.minimum(p1, n - 1)]
            c2 = text[np.minimum(p2, n - 1)]
            eq = ok & (c1 == c2)
            # first mismatch within the chunk (chunk if none)
            adv = np.argmin(eq, axis=1)
            full = eq.all(axis=1)
            adv[full] = chunk
            l[ai] += adv
            still = full
        active[ai] = still
        chunk = min(chunk * 2, 1 << 20)
    plcp[: n - 1] = l[: n - 1]
    return plcp.astype(np.int32)


def lcp_from_plcp(plcp: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """LCP[i] = PLCP[sa[i]], LCP[0] = 0 (ds/LCPFromPLCP.hpp:38-49)."""
    n = len(sa)
    lib = _lib_with("tdc_gather_i32") if n else None
    if lib is not None:
        lcp = np.empty(n, dtype=np.int32)
        lib.tdc_gather_i32(
            np.ascontiguousarray(plcp, np.int32),
            np.ascontiguousarray(sa, np.int32),
            n,
            lcp,
        )
        lcp[0] = 0
        return lcp
    lcp = plcp[sa].astype(np.int32)
    if len(lcp):
        lcp[0] = 0
    return lcp
