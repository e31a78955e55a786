"""The port's tracing on the CPU: the counter registry, the copy funnel,
the counters StatPhase logs, the spans of an lzss_lcp compress call and
their coverage, and the phases' ranges in a torch.profiler trace.

The device branches of lzss_lcp (the suffix array, kernel H's plain
version, the factorization) run on the CPU with TDC_DEVICE_SA=1 and
TDC_DEVICE_LZSS=1; there the funnel moves nothing between a card and the
host, so it counts no bytes. The copies on a card are counted in
tests/test_torch_cuda.py.
"""

import json
import mmap

import numpy as np
import pytest
import torch

from tudocomp_tpu_torch import device, kernels
from tudocomp_tpu_torch.driver import compress
from tudocomp_tpu_torch.stats import counters
from tudocomp_tpu_torch.stats import phase
from tudocomp_tpu_torch.stats.phase import StatPhase

from tests import torch_cases as tc

LZSS = "lzss_lcp(coder=huff)"

# the spans of a compress call of LZSS with the device branches, by parent
TREE = {
    (): ["Select algorithm", "Escape input", "Construct Text DS", "Factorize", "Encode", "Join output"],
    ("Construct Text DS",): ["Construct SA", "Construct ISA", "Construct LCP Array"],
    ("Construct Text DS", "Construct SA"): ["Text to device", "SA to host"],
    ("Construct Text DS", "Construct ISA"): ["ISA to host"],
    ("Construct Text DS", "Construct LCP Array"): ["LCP to host"],
    ("Factorize",): ["Upload SA ISA LCP", "Factors to host"],
    ("Encode",): ["Literal feed", "Coder setup", "Stream columns", "Tokens", "Pack bits", "Join"],
}


@pytest.fixture
def device_branches(monkeypatch):
    monkeypatch.setenv("TDC_DEVICE_SA", "1")
    monkeypatch.setenv("TDC_DEVICE_LZSS", "1")


def _tree(p, path=()):
    out = {path: [c.title for c in p.children]} if p.children else {}
    for c in p.children:
        out.update(_tree(c, path + (c.title,)))
    return out


def _walk(p):
    yield p
    for c in p.children:
        yield from _walk(c)


def _ms(p):
    return p.time_end - p.time_start


def _stats(p):
    return {s["key"]: s["value"] for s in p.to_dict()["stats"]}


def test_registry_add_snapshot_reset():
    counters.reset()
    assert counters.snapshot() == {} and counters.get("a") == 0
    counters.add("a")
    counters.add("a", 41)
    counters.add("b.c", 7)
    snap = counters.snapshot()
    assert snap == {"a": 42, "b.c": 7} and counters.get("a") == 42
    snap["a"] = 0  # a copy
    assert counters.get("a") == 42
    counters.reset()
    assert counters.snapshot() == {} and counters.get("b.c") == 0


def test_threads_lose_no_count_and_leave_no_phase_open():
    """More threads than cores, each adding to the registry and opening and
    closing phases, with a short switch interval: no add is lost, and the
    count of open phases is back at 0 when they are done."""
    import os
    import sys
    import threading

    workers, rounds = 2 * (os.cpu_count() or 4), 2000
    counters.reset()

    def work():
        for _ in range(rounds):
            counters.add("stress")
            with StatPhase("outer"):
                with StatPhase("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counters.get("stress") == workers * rounds
    assert phase._open == 0


def test_reset_counts_resets_every_counter_and_counts_gives_launches_alone():
    names = {name for name, _ in kernels.KERNELS.values()}
    counters.add("launch.plcp_segments", 3)
    counters.add("copy.to_host_bytes", 100)
    counters.add("sa.keys", 5)
    got = kernels.counts()
    assert set(got) == names and got["plcp_segments"] == 3
    assert sum(got.values()) == 3
    kernels.reset_counts()
    assert counters.snapshot() == {}
    assert kernels.counts() == {name: 0 for name in names}


def test_the_funnel_counts_no_bytes_between_the_cpu_and_itself():
    counters.reset()
    a = np.arange(1000, dtype=np.int32)
    t = device.to_device(a, "cpu")
    assert t.device.type == "cpu" and torch.equal(t, torch.from_numpy(a))
    back = device.to_host(t)
    assert isinstance(back, np.ndarray) and np.array_equal(back, a)
    assert device.to_host(torch.zeros(5, dtype=torch.int64)).dtype == np.int64
    assert counters.snapshot() == {}


@pytest.fixture(params=["profiler", "track_memory"])
def readings_on(request, monkeypatch):
    """The resident set is read where someone consumes it: under
    torch.profiler (the benchmark's traced run) or with track_memory
    (--stats)."""
    if request.param == "track_memory":
        import tracemalloc

        was = tracemalloc.is_tracing()
        monkeypatch.setattr(StatPhase, "track_memory", True)
        yield
        if not was:
            tracemalloc.stop()
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        yield


def test_a_phase_logs_its_copies_and_its_fresh_pages(readings_on):
    counters.reset()
    # the funnel's count of a copy between a card and the host (the CPU makes none)
    with StatPhase("outer") as outer:
        device._count_copy("copy.to_host_bytes", "toHostBytes", 100)
        with StatPhase("inner") as inner:
            device._count_copy("copy.to_device_bytes", "toDeviceBytes", 30)
            device._count_copy("copy.to_host_bytes", "toHostBytes", 5)
            # 64 MiB of pages mapped and touched for the first time (an
            # allocation by malloc may reuse pages the process already holds)
            fresh = mmap.mmap(-1, 64 << 20)
            np.frombuffer(fresh, np.uint8)[:] = 1
        fresh.close()
        with StatPhase("quiet") as quiet:
            pass
    assert _stats(outer)["toHostBytes"] == "105" and _stats(outer)["toDeviceBytes"] == "30"
    assert _stats(outer)["copies"] == "3" and _stats(inner)["copies"] == "2"
    assert _stats(inner)["toHostBytes"] == "5" and _stats(inner)["toDeviceBytes"] == "30"
    assert not {"toHostBytes", "toDeviceBytes", "copies"} & set(_stats(quiet))
    inner_fresh, outer_fresh = int(_stats(inner)["hostFreshBytes"]), int(_stats(outer)["hostFreshBytes"])
    assert inner_fresh >= 63 << 20  # the array, less what else went back meanwhile
    # the outer phase sums the growth of its stretches: the inner one's
    # though the array went back before it closed
    assert outer_fresh >= inner_fresh
    # the nested phases are counted once: the registry holds the outer phase's growth
    assert counters.get("host.fresh_bytes") == outer_fresh
    assert counters.get("copy.to_host_bytes") == 105 and counters.get("copy.to_device_bytes") == 30
    assert counters.get("copy.count") == 3


def test_without_a_reader_no_phase_reads_the_resident_set(monkeypatch):
    """With track_memory off and the profiler off, a phase reads no
    resident set, logs no hostFreshBytes and counts no host.fresh_bytes,
    even where it touches fresh pages."""
    reads = []

    def spy():
        reads.append(1)
        return 0

    monkeypatch.setattr(phase, "_resident", spy)
    monkeypatch.setattr(StatPhase, "track_memory", False)
    assert torch.autograd.profiler._is_profiler_enabled is False
    counters.reset()
    with StatPhase("outer") as outer:
        with StatPhase("inner") as inner:
            fresh = mmap.mmap(-1, 16 << 20)
            np.frombuffer(fresh, np.uint8)[:] = 1
        fresh.close()
    assert reads == []
    assert "hostFreshBytes" not in outer.stats and "hostFreshBytes" not in inner.stats
    assert counters.get("host.fresh_bytes") == 0


def test_compress_opens_the_named_spans_and_leaves_little_outside(device_branches):
    data = tc.english(2 << 20, seed=3)
    want = compress(LZSS, data, device="cpu")
    runs = []
    for _ in range(2):  # the better of two calls, against a busy host
        with StatPhase("root") as root:
            assert compress(LZSS, data, device="cpu") == want
        runs.append(root)
    for root in runs:
        assert _tree(root) == TREE
    outside = min((_ms(r) - sum(_ms(c) for c in r.children)) / _ms(r) for r in runs)
    enc = [next(c for c in r.children if c.title == "Encode") for r in runs]
    encode_self = min((_ms(e) - sum(_ms(c) for c in e.children)) / _ms(e) for e in enc)
    assert outside <= 0.02, outside
    assert encode_self <= 0.05, encode_self
    # the CPU moves nothing between a card and the host
    assert not any("toHostBytes" in p.stats or "toDeviceBytes" in p.stats for r in runs for p in _walk(r))


def test_the_suffix_array_counts_its_rounds_and_keys(device_branches):
    from tudocomp_tpu_torch.ds.suffix_array import suffix_array_device, suffix_array_numpy

    text = np.frombuffer(tc.english(20_000, seed=4) + b"\0", np.uint8).copy()
    counters.reset()
    with StatPhase("Construct SA") as ph:
        sa = suffix_array_device(torch.from_numpy(text))
    assert np.array_equal(sa.numpy(), suffix_array_numpy(text))
    rounds, keys = counters.get("sa.rounds"), counters.get("sa.keys")
    # the first round sorts every suffix, each later one those still tied
    assert rounds >= 2 and len(text) < keys <= rounds * len(text)
    # the open phase logs them too, for --stats
    assert ph.stats["rounds"] == rounds and ph.stats["keys"] == keys


def _annotations(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"][len(phase.RANGE_PREFIX):], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(phase.RANGE_PREFIX)]


def test_under_the_profiler_each_phase_is_one_range_nested_as_the_phases(device_branches, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    data = tc.english(300 << 10, seed=5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with StatPhase("root") as root:
            compress(LZSS, data, device="cpu")
    ranges = _annotations(prof, tmp_path)
    phases = list(_walk(root))
    assert sorted(t for t, _, _ in ranges) == sorted(p.title for p in phases)
    assert len({p.title for p in phases}) == len(phases)  # each title once: the ranges match by title
    at = {t: (a, b) for t, a, b in ranges}

    def check(p):
        a, b = at[p.title]
        for c in p.children:
            ca, cb = at[c.title]
            assert a <= ca <= cb <= b, (p.title, c.title)
        for x, y in zip(p.children, p.children[1:]):
            assert at[x.title][1] <= at[y.title][0], (x.title, y.title)
        for c in p.children:
            check(c)

    check(root)


def test_with_the_profiler_off_no_range_is_opened(device_branches, monkeypatch):
    opened = []

    class Spy:
        def __init__(self, name):
            opened.append(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Spy)
    assert torch.autograd.profiler._is_profiler_enabled is False
    with StatPhase("root") as root:
        compress(LZSS, tc.english(300 << 10, seed=6), device="cpu")
    assert len(list(_walk(root))) > 10 and opened == []
