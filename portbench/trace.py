"""What the traced run reads from torch.profiler's trace of the window.

The harness runs the window under `torch.profiler.profile` (CPU and CUDA
activities) and wraps every call of the program in a
`record_function("portbench.<op>")` range. The trace, exported as Chrome
trace JSON, gives the ranges (category `user_annotation`) and every
operation on the card: kernels (`kernel`), copies (`gpu_memcpy`) and fills
(`gpu_memset`), each with its start and length in microseconds on one
clock. From them, per call: the time some operation ran on the card (the
union of their intervals inside the call), the summed kernel time, and the
idle gaps, each named by what the host was doing then (the innermost
StatPhase of the program open in it).
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_PREFIX = "portbench."


def short_name(name: str) -> str:
    """A kernel's name without `void` and its argument list, at most 160
    characters (template arguments kept up to the first parenthesis)."""
    s = name[5:] if name.startswith("void ") else name
    i = 0
    while (j := s.find("(", i)) >= 0:
        if s.startswith("(anonymous namespace)", j):
            i = j + 1
            continue
        s = s[:j]
        break
    return s[:160]


def load(path: str):
    """(ranges, device ops) of a Chrome trace: ranges [(op, start, end)]
    in start order, ops [(start, end, name, cat)] sorted, in microseconds."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ranges, ops = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start = float(e["ts"])
        end = start + float(e["dur"])
        if cat == "user_annotation" and name.startswith(RANGE_PREFIX):
            ranges.append((name[len(RANGE_PREFIX):], start, end))
        elif cat in DEVICE_CATS:
            ops.append((start, end, short_name(name) if cat == "kernel" else name, cat))
    ranges.sort(key=lambda r: r[1])
    ops.sort()
    return ranges, ops


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def phase_segments(phases, lo, hi):
    """[(start, end, label)] covering [lo, hi): the innermost phase open in
    each stretch. phases: [(start, end, path)] on the trace's clock, path
    the titles from the outermost phase in."""
    cuts = sorted({lo, hi, *(t for s, e, _ in phases for t in (s, e) if lo < t < hi)})
    segs = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        open_ = [p for p in phases if p[0] <= mid < p[1]]
        label = "/".join(max(open_, key=lambda p: len(p[2]))[2]) if open_ else "(no phase)"
        segs.append((a, b, label))
    return segs


def summarize(ranges, ops, calls):
    """Per call (matched to the ranges in order): busy and kernel
    microseconds, idle gaps by label; and the window's totals.

    calls: the harness's records, each with `op`, `t0` (host monotonic
    seconds at the range's start) and `phases` [(start_s, end_s, path)]
    on the host clock. Returns None where the trace holds no device op."""
    if not ops or len(ranges) != len(calls):
        return None
    busy_all = merge((s, e) for s, e, _, _ in ops)
    per_call = []
    gaps_by = defaultdict(float)
    by_name = defaultdict(float)
    lo_all, hi_all = ranges[0][1], max(r[2] for r in ranges)
    for s, e, name, cat in ops:
        if e > lo_all and s < hi_all:
            by_name[name] += min(e, hi_all) - max(s, lo_all)
    i = 0
    for (op, lo, hi), call in zip(ranges, calls):
        busy = clip(busy_all, lo, hi)
        kern = 0.0
        while i < len(ops) and ops[i][0] < lo:
            i += 1
        j = i
        while j < len(ops) and ops[j][0] < hi:
            if ops[j][3] == "kernel":
                kern += min(ops[j][1], hi) - ops[j][0]
            j += 1
        shift = lo - call.t0 * 1e6  # host clock -> trace clock
        phases = [(a * 1e6 + shift, b * 1e6 + shift, p) for a, b, p in call.phases]
        gaps, t = [], lo
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        segs = phase_segments(phases, lo, hi)
        k = 0
        for gs, ge in gaps:
            while k < len(segs) and segs[k][1] <= gs:
                k += 1
            m = k
            while m < len(segs) and segs[m][0] < ge:
                a, b, label = segs[m]
                gaps_by[f"{op}>{label}"] += min(b, ge) - max(a, gs)
                m += 1
        per_call.append({"wall_us": hi - lo, "busy_us": sum(e - s for s, e in busy), "kernel_us": kern})
    window = clip(busy_all, lo_all, hi_all)
    return {
        "calls": per_call,
        "busy_s": sum(e - s for s, e in window) / 1e6,
        "window_s": (hi_all - lo_all) / 1e6,
        "device_ops": sorted(((n, v / 1e6) for n, v in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(((n, v / 1e6) for n, v in gaps_by.items()), key=lambda x: -x[1])[:10],
    }
