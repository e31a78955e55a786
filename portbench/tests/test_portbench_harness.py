"""The harness on the CPU: a throwaway cell resolved from data alone, the check
failing under each fault the cells can have and under the control, the
trace's reading, the refusals, and (on a card) one short run of each cell."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from conftest import ROOT, make_throwaway, manifest
from portbench import trace as tr
from portbench.bench import Bench
from portbench.harness import loaded_forbidden, main, run_cell

port = pytest.importorskip("tudocomp_tpu_torch.driver")
CELLS = ["tiny-lzss.encode", "tiny-huff.roundtrip"]


def run(root, cell, traced=False, entries=None, seed=2**31 + 77):
    b = Bench(root)
    return run_cell(b, b.cell(cell), seed, 0.2, traced, "cpu", time.monotonic(), entries=entries)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_throwaway_cell_runs_from_data_alone(throwaway, cell, traced):
    r = run(throwaway, cell, traced)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= len(Bench(throwaway).traffic(Bench(throwaway).cell(cell)["traffic"])["ops"])
    assert r["failed"] == 0 and list(r)[-1] == "checks"
    assert all(v == {"value": 0, "limit": 0} for v in r["checks"].values())
    names = set(r["metrics"])
    if traced:
        # on the CPU the trace holds no device op: only the program's spans
        if cell.startswith("tiny-lzss"):
            assert names == {"textds_ms_per_MiB", "factorize_ms_per_MiB", "coder_ms_per_MiB.lzss"}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    else:
        want = {"encode_MBps", "setup_s"} | ({"decode_MBps"} if "huff" in cell else set())
        assert names == want
        assert all(v["value"] > 0 for v in r["metrics"].values())


def _flip_stream(monkeypatch):
    from tudocomp_tpu_torch.io import bitio

    orig = bitio.BitWriter.getvalue

    def altered(self):
        b = bytearray(orig(self))
        b[len(b) // 2] ^= 0x10
        return bytes(b)

    monkeypatch.setattr(bitio.BitWriter, "getvalue", altered)


def _flip_output(monkeypatch):
    from tudocomp_tpu_torch.io import inout

    orig = inout.Output.getvalue

    def altered(self):
        b = bytearray(orig(self))
        if b:
            b[len(b) // 3] ^= 0x01
        return bytes(b)

    monkeypatch.setattr(inout.Output, "getvalue", altered)


def _half_batch(monkeypatch):
    from tudocomp_tpu_torch.compressors import blockwise, lzss_common, lzss_lcp

    split = blockwise.split_blocks

    def half_blocks(data, bs):
        blocks, n_valid = split(data, bs)
        keep = max(1, len(blocks) // 2)
        return blocks[:keep], n_valid[:keep]

    factorize = lzss_lcp.lcp_factorize

    def half_factors(*a, **k):
        f = factorize(*a, **k)
        keep = slice(0, len(f), 2)
        return lzss_common.Factors(f.pos[keep], f.src[keep], f.len[keep])

    monkeypatch.setattr(blockwise, "split_blocks", half_blocks)
    monkeypatch.setattr(lzss_lcp, "lcp_factorize", half_factors)


FAULTS = {
    "token_altered": (_flip_stream, None),
    "answer_altered": (_flip_output, None),
    "half_the_batch": (_half_batch, None),
    "state_unchanged": (None, {"compress": lambda alg, data, device: data, "decompress": lambda data, device: data}),
}


# the lzss cell decompresses nothing, so no output of it can be altered
@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in sorted(FAULTS)
                                        if not (f == "answer_altered" and "lzss" in c)])
def test_each_fault_makes_the_run_incorrect(throwaway, monkeypatch, cell, fault):
    patch, entries = FAULTS[fault]
    if patch is not None:
        patch(monkeypatch)
    r = run(throwaway, cell, entries=entries)
    assert r["correct"] is False, r["checks"]
    assert any(v["value"] > v["limit"] for v in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_incorrect(throwaway, cell):
    b = Bench(throwaway)
    config = b.config(b.cell(cell)["config"])
    ref = b.module("reference", config["reference"])
    entries = {
        "compress": lambda alg, data, device: ref.control(alg, data, config, device),
        "decompress": port.decompress,
    }
    r = run(throwaway, cell, entries=entries)
    assert r["correct"] is False
    # every container differs; every output still decodes to its file
    assert r["checks"]["answers_wrong"]["value"] == r["attempted"] // len(
        b.traffic(b.cell(cell)["traffic"])["ops"]
    )


def test_without_a_card_main_refuses(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["--workload", manifest()["workloads"][0]["name"], "--seed", "1", "--seconds", "1"], time.monotonic(), ROOT)
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "CUDA" in out.err


def test_without_the_program_a_run_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/: the run ends
    in an error and prints no result, even where it finds a card."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell = manifest()["workloads"][0]["name"]
    code = (
        "import sys, time, torch\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 4\n"
        "torch.cuda.set_device = lambda d: None\n"
        "sys.path.insert(0, %r)\n"
        "from portbench.harness import main\n"
        "sys.exit(main(['--workload', %r, '--seed', '5', '--seconds', '1'], time.monotonic(), %r))\n"
    ) % (str(tmp_path), cell, str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "tudocomp_tpu_torch" in r.stderr


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "tudocomp_tpu_torch_x", types.ModuleType("tudocomp_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    before = loaded_forbidden()
    assert "tudocomp_tpu_torch_x" not in before and "jaxtyping" not in before
    monkeypatch.setitem(sys.modules, "tudocomp_tpu.ops", types.ModuleType("tudocomp_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert {"tudocomp_tpu", "jax"} <= set(loaded_forbidden())


def test_trace_summary():
    ranges = [("compress", 100.0, 200.0), ("decompress", 300.0, 500.0)]
    ops = sorted([
        (110.0, 130.0, "k1", "kernel"),
        (120.0, 140.0, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
        (180.0, 190.0, "k2", "kernel"),
        (310.0, 320.0, "k1", "kernel"),
        (490.0, 520.0, "k2", "kernel"),
    ])
    calls = [
        types.SimpleNamespace(op="compress", t0=1.0, phases=[(1.0 + 50e-6, 1.0 + 100e-6, ("Encode",))]),
        types.SimpleNamespace(op="decompress", t0=2.0, phases=[]),
    ]
    s = tr.summarize(ranges, ops, calls)
    c, d = s["calls"]
    assert c == {"wall_us": 100.0, "busy_us": 40.0, "kernel_us": 30.0}
    assert d == {"wall_us": 200.0, "busy_us": 20.0, "kernel_us": 20.0}
    assert s["window_s"] == pytest.approx(400e-6) and s["busy_s"] == pytest.approx(60e-6)
    gaps = dict(s["idle_gaps"])
    # compress: idle 100-110 and 140-150 outside a phase, 150-180 and 190-200 in Encode
    assert gaps["compress>(no phase)"] == pytest.approx(20e-6)
    assert gaps["compress>Encode"] == pytest.approx(40e-6)
    assert gaps["decompress>(no phase)"] == pytest.approx(180e-6)
    names = dict(s["device_ops"])
    assert names["k2"] == pytest.approx(20e-6) and names["k1"] == pytest.approx(30e-6)
    assert tr.summarize(ranges, [], calls) is None
    assert tr.short_name("void a::b<int>(int*, long)") == "a::b<int>"


def test_trace_load(tmp_path):
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.compress", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "void k<1>(int)", "ts": 11, "dur": 1},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 12, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 11, "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 11},
    ]}
    p = tmp_path / "t.json"
    p.write_text(json.dumps(doc))
    ranges, ops = tr.load(str(p))
    assert ranges == [("compress", 10.0, 15.0)]
    assert ops == [(11.0, 12.0, "k<1>", "kernel"), (12.0, 13.0, "Memset (Device)", "gpu_memset")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_a_short_run_of_each_cell_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 3), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
