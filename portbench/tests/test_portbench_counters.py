"""The readers of the program's counters and driver spans, from a hand-built
Run and registry snapshot; and None where the program has neither."""

import pytest

from conftest import ROOT
from portbench import counters as pc
from portbench.bench import Bench
from portbench.harness import Call, Run

reg = pytest.importorskip("tudocomp_tpu_torch.stats.counters")
MiB = 1 << 20


def _call(op="compress", size=2 * MiB, phases=(), failed=False):
    return Call(op, 0, size, size, size // 7, 1.0, 0.0, list(phases), failed=failed)


def _run(calls):
    return Run({"roofline_bytes": {}}, calls, None)


def _read(name, run):
    return Bench(ROOT).module("metrics", name).read(run)


@pytest.fixture
def registry():
    reg.reset()
    yield reg
    reg.reset()


def test_copy_bytes_per_byte(registry):
    calls = [_call(), _call(), _call("decompress"), _call(failed=True)]
    registry.add("copy.to_host_bytes", 50 * MiB)
    registry.add("copy.to_device_bytes", 54 * MiB)
    registry.add("copy.count", 20)
    registry.add("launch.plcp_segments", 2)
    assert _read("copy_bytes_per_byte.encode", _run(calls)) == pytest.approx(104 / 4)


def test_host_fresh_bytes_per_byte(registry):
    registry.add("host.fresh_bytes", 30 * MiB)
    registry.add("copy.to_host_bytes", 1)
    assert _read("host_fresh_bytes_per_byte.encode", _run([_call(size=3 * MiB)])) == pytest.approx(10)


def test_sa_keys_per_byte(registry):
    registry.add("sa.keys", 5 * MiB)
    registry.add("sa.rounds", 9)
    assert _read("sa_keys_per_byte", _run([_call(), _call(size=MiB)])) == pytest.approx(5 / 3)


@pytest.mark.parametrize("name", ["copy_bytes_per_byte.encode", "host_fresh_bytes_per_byte.encode",
                                  "sa_keys_per_byte"])
def test_counter_readers_read_nothing_without_counters(registry, monkeypatch, name):
    registry.add("unrelated", 5)
    assert _read(name, _run([_call()])) is None  # counters at zero: the path did not run
    registry.add("copy.to_host_bytes", 1)
    registry.add("host.fresh_bytes", 1)
    registry.add("sa.keys", 1)
    assert _read(name, _run([])) is None  # no compress call
    assert _read(name, _run([_call()])) > 0
    # a program without the registry
    monkeypatch.setattr(pc, "SNAPSHOT", "tudocomp_tpu_torch.stats.no_such_module:snapshot")
    assert pc.snapshot() is None
    assert _read(name, _run([_call()])) is None


def test_driver_ms_per_MiB():
    spans = [(0.0, 0.010, ("Select algorithm",)), (0.010, 0.300, ("Escape input",)),
             (0.300, 2.000, ("Construct Text DS",)), (2.9, 2.902, ("Encode", "Join")),
             (2.950, 2.990, ("Join output",))]
    calls = [_call(size=50 * MiB, phases=spans), _call(size=50 * MiB, phases=spans[:2])]
    # (10 + 290 + 40 + 10 + 290) ms over 100 MiB
    assert _read("driver_ms_per_MiB.encode", _run(calls)) == pytest.approx(640 / 100)
    # the parent's program opens none of the three
    assert _read("driver_ms_per_MiB.encode", _run([_call(phases=spans[2:4])])) is None
