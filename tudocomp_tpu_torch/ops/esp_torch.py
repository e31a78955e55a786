"""Device ESP grammar construction in PyTorch, on an explicit torch.device.

The port of tudocomp_tpu/ops/esp_jax.py. Each round of the edit-sensitive
parse (EspContextImpl.hpp:14-165 in the reference) is a fixed sequence of
whole-array passes over a padded size that halves from round to round, so
the rounds chain on the device with one host sync at the end: the valid
length, the rule count and the overflow flag of each round stay on the
device. The output is bit-identical to compressors/esp.generate_grammar:
the formulation is the JAX package's numpy specification
(tudocomp_tpu/ops/esp_vec.py), and the tests hold this module to the host
rounds and to the JAX package.

Per round:
1. `stage_blocks`: segmentation into run (type-1) and non-repeating
   (type-2) metablocks, the closed-form eager_mb13 block starts of runs and
   type-3 prefixes, the alphabet reduction (label), the 3/4/5 -> mex
   replacement, the high/low landmarks and the landmark block starts; the
   starts are compacted into (lens, types) with a cumsum and a scatter;
2. `adjust_pass`: the _adjust_blocks queue, identity away from length-1
   blocks; `adjust_spans` cuts the blocks into spans around the length-1
   blocks and kernel I (ops/esp_kernels.py) runs the exact queue machine
   over each span, one thread a span, in one launch; a stable compaction
   (cumsum and scatter) drops the slots that merges freed;
3. `_stage_naming`: GrammarRules naming by sorted first-appearance ranks,
   the two-level keys (a, b) and (inner group, c) packed into one int64
   sort key each.

`_stage_naming` and the next round hold the adjusted blocks in size // 2
slots. They fit: for m >= 2 every adjusted block spans at least two
symbols, so nb <= m // 2 <= size // 2. The queue merges a length-1 block
with its neighbour unless that pair is a type-2 block before a type-3 one
(the only pair with no merge type), and no such pair arises: type-3 blocks
are the prefix of a non-run segment, which follows a run or the start;
type-2 blocks end a non-run segment, which a run or the end follows; and a
merge gives both its blocks one type. A length-1 block is thus left only
where it is the whole string (m = 1, a round that passes through). Each
round still sets an overflow flag where nb > size // 2, read in the one
sync; a set flag raises (the host rounds are never run in its place).
Kernel I takes spans of any width, so the JAX package's lane caps and
their host fallbacks are gone.
"""

from __future__ import annotations

import numpy as np
import torch

from .esp_kernels import esp_adjust_windows

__all__ = ["adjust_pass", "adjust_spans", "esp_grammar_device", "esp_round_device", "padded",
           "round_body", "stage_blocks"]

_I32 = torch.int32
_I64 = torch.int64
_I32MAX = 2**31 - 1
_NEG = -(1 << 30)
_BIG = 1 << 30


def _shift_left(a: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([a[1:], torch.full((1,), fill, dtype=a.dtype, device=a.device)])


def _shift_right(a: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([torch.full((1,), fill, dtype=a.dtype, device=a.device), a[:-1]])


def _exclusive_cumsum(a: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(a, 0, dtype=_I32)
    return c - a.to(_I32)


def _compact(keep: torch.Tensor, *values: torch.Tensor, fill: int = 0) -> list[torch.Tensor]:
    """Each of `values` with its kept entries moved to the front in order
    (a stable compaction by cumsum and scatter), `fill` after them."""
    size = keep.shape[0]
    dst = torch.where(keep, torch.cumsum(keep, 0) - 1, size)
    out = []
    for v in values:
        o = torch.full((size + 1,), fill, dtype=v.dtype, device=v.device)
        out.append(o.scatter_(0, dst, v)[:size])
    return out


def _ranked(mask: torch.Tensor, rank: torch.Tensor, values: torch.Tensor, fill: int) -> torch.Tensor:
    """[size + 2]: values[j] at slot rank[j] for each j in mask (rank: the
    inclusive cumsum of mask, less 1), `fill` in the slots after the last;
    slot size + 1 takes the writes of the positions outside mask."""
    size = mask.shape[0]
    out = torch.full((size + 2,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_(0, torch.where(mask, rank, size + 1).to(_I64), values)


def _ctz(x: torch.Tensor) -> torch.Tensor:
    """Trailing zeros of int32 x > 0: log2 of its lowest set bit, read off
    that power of two's float32 exponent, which frexp gives exactly (torch
    has no popcount for integer tensors)."""
    return (torch.frexp((x & -x).to(torch.float32)).exponent - 1).to(_I32)


def _iter_log(alphabet: torch.Tensor) -> torch.Tensor:
    return torch.where(
        alphabet < 7, 0,
        torch.where(alphabet < 9, 1, torch.where(alphabet < 17, 2, torch.where(alphabet < 257, 3, 4))),
    ).to(_I32)


def _label(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    diff = left ^ right
    l = torch.where(diff != 0, _ctz(diff), 0).to(_I32)
    return 2 * l + ((right >> l) & 1)


def _mb13_starts(off: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    mod = r % 3
    m0 = (mod == 0) & (off % 3 == 0)
    m2 = (mod == 2) & (off % 3 == 0)
    m1 = (mod == 1) & (r > 1) & (((off % 3 == 0) & (off < r - 4)) | (off == r - 4) | (off == r - 2))
    return m0 | m2 | m1 | ((r == 1) & (off == 0))


# ---------------------------------------------------------------------------
# one round at a static padded size


def stage_blocks(src, m, alphabet):
    """Pre-adjust blocks of src [size] (valid prefix m): (lens, types, nb),
    lens and types int32 [size] with the nb blocks first, 0 after."""
    size = src.shape[0]
    dev = src.device
    i = torch.arange(size, dtype=_I32, device=dev)
    inb = i < m
    t = _iter_log(alphabet)

    # --- segmentation
    eq = inb & (i + 1 < m) & (src == _shift_left(src, 0))
    run_member = eq | _shift_right(eq, False)
    prev_rm = _shift_right(run_member, False)
    changed = (src != _shift_right(src, -1)) | (i == 0)
    seg_start = inb & ((run_member != prev_rm) | (run_member & prev_rm & changed) | (i == 0))
    # each position's segment start and the next segment's (its end, at most
    # m), looked up in the compacted starts by segment id: a cumsum, a
    # scatter and gathers (on 16M int32 on an H100, torch's cummax and cummin
    # take ~10 ms a call, a cumsum well under 1 ms)
    sid = torch.cumsum(seg_start, 0, dtype=_I32) - 1
    starts = _ranked(seg_start, sid, i, _I32MAX)
    pos_start = starts[sid.clamp(min=0).to(_I64)]
    seg_len = torch.minimum(starts[(sid + 1).to(_I64)], m) - pos_start
    off = i - pos_start
    is_t2 = inb & ~run_member
    t3 = torch.minimum(t, seg_len)
    B = seg_len - t3

    # --- type-1 runs and type-3 prefixes (closed-form mb13)
    run_sel = inb & run_member & _mb13_starts(off, seg_len)
    pre_sel = is_t2 & (off < t3) & _mb13_starts(off, t3)

    # --- alphabet reduction, mex and landmarks over the reduced buffer
    cur = src
    for k in range(4):
        mask = is_t2 & (k < t) & (off <= seg_len - k - 2)
        cur = torch.where(mask, _label(cur, _shift_left(cur, 0)), cur)
    bvalid = is_t2 & (off < B)
    has_l = bvalid & (off > 0)
    has_r = bvalid & (off + 1 < B)
    for v in (3, 4, 5):
        lv = torch.where(has_l, _shift_right(cur, -1), -1)
        rv = torch.where(has_r, _shift_left(cur, -1), -1)
        e = torch.zeros_like(cur)
        for _ in range(4):
            e = torch.where((lv == e) | (rv == e), e + 1, e)
        cur = torch.where(bvalid & (cur == v), e, cur)
    left = _shift_right(cur, -1)
    right = _shift_left(cur, -1)
    high = bvalid & ~(has_l & (left > cur)) & ~(has_r & (right > cur))
    low = (
        bvalid
        & ~(has_l & (left < cur))
        & ~(has_r & (right < cur))
        & ~(has_l & _shift_right(high, False))
        & ~(has_r & _shift_left(high, False))
    )
    lm = high | low
    lm1 = _shift_left(lm, False)
    starts_buf = (bvalid & (off > 0) & lm1 & (off + 1 < B)) | (
        bvalid & (off == 0) & (lm | (lm1 & (off + 1 < B)))
    )
    # a buffer start b is a block start at source offset t3 + b
    tgt = torch.where(starts_buf, i + t3, size).to(_I64)
    lm_src = torch.zeros(size + 1, dtype=torch.bool, device=dev).scatter_(0, tgt, True)[:size]
    is_start = run_sel | pre_sel | lm_src
    btype = torch.where(run_sel, 1, torch.where(pre_sel, 3, torch.where(lm_src, 2, 0))).to(_I32)

    # --- compact the starts into blocks
    nb = is_start.sum(dtype=_I32)
    bpos, btyp = _compact(is_start, i, btype, fill=_I32MAX)
    btyp = torch.where(bpos < _I32MAX, btyp, 0)
    lens = torch.where(bpos < _I32MAX, torch.minimum(_shift_left(bpos, _I32MAX), m) - bpos, 0)
    return lens, btyp, nb


def adjust_spans(lens, nb):
    """The spans the adjust pass replays: the unions of the [i - 3, i + 4)
    windows around the length-1 blocks i < nb, as esp_jax._adjust_dev
    builds them (a new span where a length-1 block lies 7 or more blocks
    past the previous one). Returns ws, we int32 [size // 7 + 1] (each
    span's [start, end), clipped to [0, nb); spans past the count are 0)
    and ns int32 [1], the count, on the device: heads are at least 7 blocks
    apart, so the count stays within the static size."""
    size = lens.shape[0]
    bidx = torch.arange(size, dtype=_I32, device=lens.device)
    is_one = (bidx < nb) & (lens == 1)
    # each length-1 block's neighbours among the length-1 blocks, from their
    # compacted positions
    oid = torch.cumsum(is_one, 0, dtype=_I32) - 1
    opos = _ranked(is_one, oid, bidx, _BIG)
    prev_one = torch.where(oid > 0, opos[(oid - 1).clamp(min=0).to(_I64)], _NEG)
    next_one = opos[(oid + 1).clamp(min=0).to(_I64)]
    head = is_one & (bidx - prev_one >= 7)  # a span's first length-1 block
    tail = is_one & (next_one - bidx >= 7)  # and its last: the k-th tail closes the k-th span
    S = size // 7 + 1
    z = torch.zeros(S + 1, dtype=_I32, device=lens.device)
    ws = z.clone().scatter_(0, torch.where(head, torch.cumsum(head, 0) - 1, S), torch.clamp(bidx - 3, min=0))[:S]
    we = z.scatter_(0, torch.where(tail, torch.cumsum(tail, 0) - 1, S), torch.minimum(bidx + 4, nb))[:S]
    return ws, we, head.sum(dtype=_I32).reshape(1)


def adjust_pass(lens, typs, nb):
    """The _adjust_blocks pass over a round's blocks: the queue machine over
    each span (kernel I on a CUDA device), then the kept blocks compacted.
    Returns (lens, typs, nb), nb a device scalar; lens and typs are
    adjusted in place on the way."""
    size = lens.shape[0]
    ws, we, ns = adjust_spans(lens, nb)
    esp_adjust_windows(lens, typs, ws, we, ns)
    keep = (torch.arange(size, device=lens.device) < nb) & (lens > 0)
    out_l, out_t = _compact(keep, lens, typs)
    return out_l, out_t, keep.sum(dtype=_I32)


def _packed(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 sort key of two int32 keys in [0, 2^31): hi, then lo."""
    return (hi.to(_I64) << 32) | lo.to(_I64)


def _stage_naming(src, alphabet, lens, nb):
    """GrammarRules naming by sorted first-appearance ranks, over the first
    half of the blocks (nb <= size // 2, the module's docstring; the caller
    flags a round where not). Returns
    (nxt [size // 2], rl [size], rr [size], K)."""
    size = src.shape[0]
    H = size // 2
    dev = src.device
    lens = lens[:H]
    bi = torch.arange(H, dtype=_I32, device=dev)
    bvalid = bi < nb
    bpos = _exclusive_cumsum(lens).to(_I64)
    is3 = bvalid & (lens == 3)
    base = _exclusive_cumsum(torch.where(bvalid, 1 + is3.to(_I32), 0))

    ga = torch.where(bvalid, src[bpos.clamp(0, size - 1)], _I32MAX)
    gb = torch.where(bvalid, src[(bpos + 1).clamp(0, size - 1)], _I32MAX)
    gc = src[(bpos + 2).clamp(0, size - 1)]

    # inner groups: blocks sorted by (a, b), ties in block order (so by call
    # position); a group's head holds its first call
    skey, sblk = torch.sort(_packed(ga, gb), stable=True)
    sa = (skey >> 32).to(_I32)
    sb = (skey & 0xFFFFFFFF).to(_I32)
    sbase = base[sblk]
    head = ((bi == 0) | (skey != _shift_right(skey, -1))) & (sa < _I32MAX)
    gid = torch.cumsum(head, 0, dtype=_I32) - 1
    inv_inner = torch.zeros(H + 1, dtype=_I32, device=dev).scatter_(
        0, torch.where(sa < _I32MAX, sblk, H), gid)[:H]

    # outer groups of 3-blocks: key (inner group, c)
    okey, oblk = torch.sort(
        _packed(torch.where(is3, inv_inner, _I32MAX), torch.where(is3, gc, _I32MAX)), stable=True)
    oa = (okey >> 32).to(_I32)
    oc = (okey & 0xFFFFFFFF).to(_I32)
    obase = base[oblk] + 1
    ohead = ((bi == 0) | (okey != _shift_right(okey, -1))) & (oa < _I32MAX)
    ogid = torch.cumsum(ohead, 0, dtype=_I32) - 1
    inv_outer = torch.zeros(H + 1, dtype=_I32, device=dev).scatter_(
        0, torch.where(oa < _I32MAX, oblk, H), ogid)[:H]

    # rank the groups' first calls over both levels; after the sort, row r
    # is rule r (first calls are distinct; only padding rows tie)
    firsts = torch.cat([torch.where(head, sbase, _I32MAX), torch.where(ohead, obase, _I32MAX)])
    sf, order = torch.sort(firsts, stable=True)
    isout = (order >= H).to(_I32)
    ca = torch.cat([sa, oa])[order]  # inner: symbol a; outer: its inner group
    cb = torch.cat([sb, oc])[order]
    cg = torch.cat([gid, ogid])[order]
    K = (firsts < _I32MAX).sum(dtype=_I32)
    rvalid = sf < _I32MAX
    r = torch.arange(2 * H, dtype=_I32, device=dev)
    # group -> rule id (inner groups at [0, H), outer at [H, 2H))
    idtab = torch.zeros(2 * H + 1, dtype=_I32, device=dev).scatter_(
        0, torch.where(rvalid, (cg + isout * H).to(_I64), 2 * H), r)[: 2 * H]
    rl_s = torch.where(isout == 1, alphabet + idtab[ca.clamp(0, H - 1).to(_I64)], ca)
    rl = torch.where(rvalid, rl_s, 0)
    rr = torch.where(rvalid, cb, 0)
    nxt = torch.where(is3, idtab[H:][inv_outer.clamp(0, H - 1).to(_I64)],
                      idtab[:H][inv_inner.clamp(0, H - 1).to(_I64)])
    return torch.where(bvalid, nxt, 0), rl, rr, K


def round_body(src, m, alphabet):
    """One ESP round. src: int32 [size] (valid prefix m), m and alphabet
    int32 device scalars. Returns (nxt [size // 2], nb, rl [size],
    rr [size], K, overflow), the scalars on the device; overflow: nb >
    size // 2, which the module's docstring shows cannot happen. A round
    with m <= 1 passes src through (the host loop stops at length 1)."""
    half = src.shape[0] // 2
    lens, typs, nb = stage_blocks(src, m, alphabet)
    lens, typs, nb = adjust_pass(lens, typs, nb)
    nxt, rl, rr, K = _stage_naming(src, alphabet, lens, nb)
    done = m <= 1
    nxt = torch.where(done, src[:half], nxt)
    overflow = (nb > half) & ~done
    # past an overflow the length is clipped to the next round's size, so
    # the rounds chained after it stay in bounds until the sync raises
    return nxt, torch.where(done, m, torch.clamp(nb, max=half)), rl, rr, torch.where(done, 0, K), overflow


def _overflowed(size: int) -> RuntimeError:
    return RuntimeError(f"ESP round of padded size {size}: more than size // 2 adjusted blocks")


def padded(values, size: int, device) -> torch.Tensor:
    """values as int32 [size] on `device`, zeros after; bytes cross as bytes
    and widen on the device."""
    arr = np.asarray(values)
    if arr.dtype != np.uint8 or not arr.flags.writeable:
        arr = arr.astype(np.int32 if arr.dtype != np.uint8 else np.uint8)
    src = torch.zeros(size, dtype=_I32, device=device)
    src[: len(arr)] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return src


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=_I32, device=device)


def esp_round_device(src, alphabet: int, device="cpu"):
    """One round on `device` (the single-round entry of the tests): mirrors
    compressors/esp.esp_round_python bit for bit. Returns (nxt, rl, rr) as
    uint32 arrays; raises RuntimeError where the round set its overflow
    flag."""
    m = len(src)
    size = 8
    while size < m:
        size *= 2
    dev = torch.device(device)
    nxt, nb, rl, rr, K, fb = round_body(padded(src, size, dev), _scalar(m, dev), _scalar(alphabet, dev))
    if bool(fb):
        raise _overflowed(size)
    nb, K = int(nb), int(K)
    return tuple(x.cpu().numpy().astype(np.uint32) for x in (nxt[:nb], rl[:K], rr[:K]))


def esp_grammar_device(data, threshold: int = 1 << 15, device="cuda"):
    """Grammar construction: device rounds on `device` while the padded
    size is at least 2 * threshold, then the host rounds on the residual
    string. Bit-identical to compressors/esp.generate_grammar, which it
    runs instead for inputs of at most 2 * threshold bytes. Raises
    RuntimeError where a round set its overflow flag."""
    from ..compressors.esp import esp_round, generate_grammar

    data = np.asarray(data, np.uint8)
    n = len(data)
    if n <= 1 or n <= 2 * threshold:
        return generate_grammar(data)
    dev = torch.device(device)
    size = 1
    while size < n:
        size *= 2
    src, m, alphabet = padded(data, size, dev), _scalar(n, dev), _scalar(256, dev)
    rules_dev, scalars, sizes = [], [], []
    while size // 2 >= threshold:
        sizes.append(size)
        nxt, nb, rl, rr, K, fb = round_body(src, m, alphabet)
        rules_dev.append((rl, rr))
        scalars.append(torch.stack([K, nb, fb.to(_I32)]))
        src, m, alphabet = nxt, nb, K
        size //= 2

    # one sync: the rule counts, lengths and flags of every round
    counts, nbs, flags = torch.stack(scalars).cpu().numpy().T
    if flags.any():
        raise _overflowed(sizes[int(np.argmax(flags))])

    all_rules = []
    slp_counter = 256
    prev_slp_counter = 0
    cur_m = n
    parts = []
    for idx, (rl, rr) in enumerate(rules_dev):
        if cur_m == 1:
            break
        k = int(counts[idx])
        parts.append(torch.stack([rl[:k], rr[:k]], 1).to(_I64) + prev_slp_counter)
        prev_slp_counter = slp_counter
        slp_counter += k
        cur_m = int(nbs[idx])
    tail = src[:cur_m].cpu().numpy().astype(np.uint32)
    if parts:
        all_rules.append(torch.cat(parts).cpu().numpy())
    if cur_m == 1:
        root = int(tail[0]) + prev_slp_counter
    else:
        # host finish on the residual string
        string = tail
        alpha = int(counts[len(parts) - 1]) if parts else 256
        while True:
            if len(string) == 1:
                root = int(string[0]) + prev_slp_counter
                break
            nxt_h, rl_h, rr_h = esp_round(string, alpha)
            all_rules.append(np.stack([rl_h, rr_h], axis=1).astype(np.int64) + prev_slp_counter)
            prev_slp_counter = slp_counter
            slp_counter += len(rl_h)
            string = nxt_h
            alpha = len(rl_h)
    rules = np.concatenate(all_rules) if all_rules else np.zeros((0, 2), np.int64)
    return rules, root, False
