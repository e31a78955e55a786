"""Plain reference of `lzss_lcp(coder=huff)` (tudocomp's LZSSLCPCompressor): the container.

1. The text: every 0 byte becomes 0xFF 0xFE and every 0xFF byte 0xFF 0xFF
   (tudocomp's escape map for a text that must hold no 0), then one 0 is
   appended as the sentinel. n counts it.
2. Suffix array, ranks and LCP by prefix doubling with a full sort a
   round: rank_j[i] is the dense rank of text[i : i + 2^j]; the round
   that leaves all ranks distinct gives the SA (its order) and the ISA.
   LCP[c] of the suffixes SA[c - 1], SA[c] is found by descending the
   levels: l grows by 2^j where rank_j agrees at SA[c - 1] + l and SA[c] + l.
3. For SA index c the previous and next smaller values (PSV, NSV: the
   nearest index on each side whose SA value, a text position, is
   smaller), each with the least LCP between, by a binary descent over
   sparse tables of range minima. A position takes the longer of the two
   (the PSV where they tie) as a factor if it is at least `threshold`
   long; the last position never starts one.
4. The greedy parse from position 0 steps over a factor, or one
   literal: its positions are the path 0, next(0), ... of next(i) = i +
   step(i), found by doubling: next^(2^k) for every k, and the path
   expanded from the top level down.
5. The stream (tudocomp's lzss::encode_text): the Huffman table of the
   uncovered bytes; n in 32 bits; the shortest and longest factor and the
   longest gap, each in bits_for(n) bits; per factor a bit for "a gap
   comes first", the gap in bits_for(longest gap) bits and its literals'
   codes, the source in bits_for(n) bits, the length less the shortest in
   bits_for(longest - shortest) bits; then the last gap in the same way.

Plain PyTorch on `device`; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitstream import bits_for, pack
from .huffman import Table

I64 = torch.int64
LEN_MAX = 0xFFFFFFFF  # the shortest factor of an empty factor list


def escaped_text(data: bytes) -> np.ndarray:
    a = np.frombuffer(data, np.uint8)
    esc = (a == 0) | (a == 0xFF)
    out = np.empty(len(a) + int(esc.sum()) + 1, np.uint8)
    pos = np.arange(len(a)) + np.cumsum(esc)  # each byte after its escape
    out[pos] = np.where(a == 0, 0xFE, a)
    out[pos[esc] - 1] = 0xFF
    out[-1] = 0
    return out


def suffix_ranks(text: torch.Tensor):
    """(SA, ISA, ranks by level) of a text whose last byte is a unique 0."""
    n = int(text.numel())
    rank = text.to(I64)
    levels = [rank.to(torch.int32)]
    order = torch.argsort(rank, stable=True)
    k = 1
    mult = max(n, 256) + 1
    while k < n:
        nxt = torch.full((n,), -1, dtype=I64, device=text.device)
        nxt[: n - k] = rank[k:]
        key, order = torch.sort(rank * mult + nxt + 1)
        new = torch.ones(n, dtype=I64, device=text.device)
        new[0] = 0
        new[1:] = key[1:] != key[:-1]
        rank = torch.empty_like(rank)
        rank[order] = torch.cumsum(new, 0)
        levels.append(rank.to(torch.int32))
        if int(rank.max()) == n - 1:
            break
        k *= 2
    return order, rank, levels


def lcp_array(sa: torch.Tensor, levels: list) -> torch.Tensor:
    """lcp[c] = LCP of suffixes sa[c - 1] and sa[c]; lcp[0] = 0."""
    n = int(sa.numel())
    a, b = sa[:-1].to(I64), sa[1:].to(I64)
    l = torch.zeros(n - 1, dtype=I64, device=sa.device)
    for j in range(len(levels) - 2, -1, -1):
        pa, pb = a + l, b + l
        ok = (pa < n) & (pb < n)
        r = levels[j]
        same = ok & (r[pa.clamp(max=n - 1)] == r[pb.clamp(max=n - 1)])
        l += same.to(I64) << j
    return torch.cat([torch.zeros(1, dtype=I64, device=sa.device), l])


def sparse_min(x: torch.Tensor) -> list:
    """t[k][i] = min(x[i : i + 2^k])."""
    t = [x]
    span = 1
    while 2 * span <= x.numel():
        p = t[-1]
        t.append(torch.minimum(p[:-span], p[span:]))
        span *= 2
    return t


def smaller_values(sa: torch.Tensor, lcp: torch.Tensor):
    """(psv_src, psv_lcp, nsv_src, nsv_lcp) per SA index; src -1 where none."""
    n = int(sa.numel())
    dev = sa.device
    sa = sa.to(torch.int32)
    lcp = lcp.to(torch.int32)
    ts, tl = sparse_min(sa), sparse_min(lcp)  # int32: n < 2^31
    c = torch.arange(n, device=dev)
    # PSV: the longest run sa[c - d : c] of values above sa[c]
    d = torch.zeros(n, dtype=I64, device=dev)
    m = lcp.clone()
    for k in range(len(ts) - 1, -1, -1):
        lo = c - d - (1 << k)
        ok = lo >= 0
        lo = lo.clamp(min=0)
        take = ok & (ts[k][lo.clamp(max=ts[k].numel() - 1)] > sa)
        m = torch.where(take, torch.minimum(m, tl[k][lo.clamp(max=tl[k].numel() - 1)]), m)
        d += take.to(I64) << k
    p = c - d - 1
    has = p >= 0
    psv_src = torch.where(has, sa[p.clamp(min=0)], -1).to(I64)
    psv_lcp = torch.where(has, m, 0).to(I64)
    # NSV: the longest run sa[c + 1 : c + 1 + d] of values above sa[c]
    d = torch.zeros(n, dtype=I64, device=dev)
    m = torch.full((n,), (1 << 31) - 1, dtype=torch.int32, device=dev)
    for k in range(len(ts) - 1, -1, -1):
        lo = c + 1 + d
        ok = lo + (1 << k) <= n
        lo = lo.clamp(max=ts[k].numel() - 1)
        take = ok & (ts[k][lo] > sa)
        m = torch.where(take, torch.minimum(m, tl[k][lo]), m)
        d += take.to(I64) << k
    p = c + 1 + d
    has = p < n
    pc = p.clamp(max=n - 1)
    nsv_src = torch.where(has, sa[pc], -1).to(I64)
    nsv_lcp = torch.where(has, torch.minimum(m, lcp[pc]), 0).to(I64)
    return psv_src, psv_lcp, nsv_src, nsv_lcp


def greedy_path(step: torch.Tensor) -> torch.Tensor:
    """Positions 0, next(0), ... below n of next(i) = i + step[i]."""
    n = int(step.numel())
    dev = step.device
    first = torch.cat([torch.arange(n, device=dev) + step, torch.tensor([n], device=dev)])
    jump = [first.clamp(max=n).to(torch.int32)]  # n < 2^31
    while (1 << len(jump)) < n + 1:
        j = jump[-1]
        jump.append(torch.index_select(j, 0, j))
    path = torch.zeros(1, dtype=torch.int32, device=dev)
    for j in reversed(jump):
        path = torch.cat([path, torch.index_select(j, 0, path)])
        path = path[path < n]
    return torch.sort(path.to(I64)).values


def factorize(text: torch.Tensor, threshold: int, prefer_nsv: bool = False):
    """Factors (pos, src, len) of the greedy parse, sorted by pos."""
    n = int(text.numel())
    sa, isa, levels = suffix_ranks(text)
    lcp = lcp_array(sa, levels)
    del levels
    psv_src, psv_lcp, nsv_src, nsv_lcp = smaller_values(sa, lcp)
    use_psv = (psv_lcp > nsv_lcp) if prefer_nsv else (psv_lcp >= nsv_lcp)
    best = torch.where(use_psv, psv_lcp, nsv_lcp)[isa]
    src = torch.where(use_psv, psv_src, nsv_src)[isa]
    pos = torch.arange(n, device=text.device)
    is_factor = (best >= threshold) & (pos + 1 < n)
    path = greedy_path(torch.where(is_factor, best, 1))
    path = path[is_factor[path]]
    return path, src[path], best[path]


def stream_tokens(text: torch.Tensor, fpos, fsrc, flen, table_fn=Table):
    """The lzss stream's tokens (values, widths), Huffman-coded literals."""
    n = int(text.numel())
    dev = text.device
    nf = int(fpos.numel())
    delta = torch.zeros(n + 1, dtype=I64, device=dev)
    delta[fpos] += 1
    delta[fpos + flen] -= 1
    covered = torch.cumsum(delta[:n], 0) > 0
    lit_pos = torch.nonzero(~covered).squeeze(1)
    lits = text[lit_pos].to(I64)
    table = table_fn(torch.bincount(lits, minlength=256).cpu().numpy())
    code = torch.from_numpy(table.code).to(dev)
    clen = torch.from_numpy(table.length).to(dev)

    shortest = int(flen.min()) if nf else LEN_MAX
    longest = int(flen.max()) if nf else 0
    prev_end = torch.cat([torch.zeros(1, dtype=I64, device=dev), fpos + flen])
    gaps = torch.cat([fpos, torch.tensor([n], device=dev)]) - prev_end
    gap_max = int(gaps.max())
    wn, wgap, wlen = bits_for(n), bits_for(gap_max), bits_for(longest - shortest)
    head = list(table.header) + [(n, 32), (shortest & ((1 << wn) - 1), wn), (longest, wn), (gap_max, wn)]

    # segment f < nf: flag, [gap], literals, src, len; segment nf: the
    # trailing gap, written only where there is one
    has_gap = gaps > 0
    live = torch.ones(nf + 1, dtype=torch.bool, device=dev)
    live[nf] = bool(has_gap[nf])
    is_fac = torch.ones(nf + 1, dtype=I64, device=dev)
    is_fac[nf] = 0
    per = torch.where(live, 1 + has_gap.to(I64) + gaps + 2 * is_fac, 0)
    seg0 = len(head) + torch.cumsum(per, 0) - per
    total = len(head) + int(per.sum())
    values = torch.zeros(total, dtype=I64, device=dev)
    widths = torch.zeros(total, dtype=I64, device=dev)
    values[: len(head)] = torch.tensor([v for v, _ in head], dtype=I64, device=dev)
    widths[: len(head)] = torch.tensor([w for _, w in head], dtype=I64, device=dev)
    segs = torch.nonzero(live).squeeze(1)
    values[seg0[segs]] = has_gap[segs].to(I64)
    widths[seg0[segs]] = 1
    g = torch.nonzero(live & has_gap).squeeze(1)
    values[seg0[g] + 1] = gaps[g]
    widths[seg0[g] + 1] = wgap
    seg = torch.searchsorted(fpos, lit_pos, right=True)
    at = seg0[seg] + 2 + lit_pos - prev_end[seg]
    values[at] = code[lits]
    widths[at] = clen[lits]
    if nf:
        f = torch.arange(nf, device=dev)
        at = seg0[f] + 1 + has_gap[f].to(I64) + gaps[f]
        values[at] = fsrc
        widths[at] = wn
        values[at + 1] = flen - shortest
        widths[at + 1] = wlen
    return values, widths


def compress(algorithm: str, data: bytes, config: dict, device, prefer_nsv: bool = False, table_fn=Table) -> bytes:
    """The container `driver.compress(algorithm, data)` must return."""
    text = torch.from_numpy(escaped_text(data)).to(device)
    fpos, fsrc, flen = factorize(text, int(config.get("threshold", 3)), prefer_nsv)
    values, widths = stream_tokens(text, fpos, fsrc, flen, table_fn)
    return algorithm.encode() + b"%" + pack(values, widths)


def control(algorithm: str, data: bytes, config: dict, device) -> bytes:
    """The control: the same parse with ties of the two candidate factors
    going to the NSV, a valid LZSS stream that is not tudocomp's."""
    return compress(algorithm, data, config, device, prefer_nsv=True)
