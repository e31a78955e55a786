"""BENCHMARK.json against the benchmark's contract, and every part it names present."""

import json
import os
import re

import pytest

from conftest import BENCH_DIR, ROOT, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


M = manifest()


def test_keys_and_sizes():
    assert set(M) == KEYS["top"]
    assert len(json.dumps(M)) <= 64 * 1024
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and ".." not in p.split("/") for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(line(w) for w in M["command"])
    assert all(not w.startswith("/") for w in M["command"])
    assert 1 <= len(M["configs"]) <= 24 and 1 <= len(M["workloads"]) <= 24
    assert 1 <= len(M["end_to_end"]) <= 16 and 1 <= len(M["per_layer"]) <= 128
    for c in M["configs"]:
        assert set(c) == KEYS["config"]
    for w in M["workloads"]:
        assert set(w) == KEYS["workload"]
    for m in M["end_to_end"]:
        assert set(m) <= KEYS["end_to_end"] and set(m) >= KEYS["end_to_end"] - {"workloads"}
    for m in M["per_layer"]:
        assert set(m) <= KEYS["per_layer"] and set(m) >= KEYS["per_layer"] - {"workloads"}


def test_names_units_and_text_fields():
    for group in (M["configs"], M["workloads"], M["end_to_end"] + M["per_layer"]):
        assert len({x["name"] for x in group}) == len(group)
    for n in (x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]):
        assert NAME.match(n), n
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and line(w["why"]) and w["chips"] in (1, 4)
    for c in M["configs"]:
        assert line(c["source"]) and c["source"].startswith(("http://", "https://")) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_setup_bound_and_cells_report_enough():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in M["workloads"]:
        reported = [m for m in M["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2, w["name"]
        moved = {m["name"] for m in reported}
        layers = [m for m in M["per_layer"] if w["name"] in m.get("workloads", [w["name"]]) and m["moves"] in moved]
        assert layers, w["name"]


def test_each_metric_moves_an_end_to_end_metric_of_each_of_its_cells():
    cells = {w["name"] for w in M["workloads"]}
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)
    for m in M["end_to_end"]:
        assert set(m.get("workloads", [])) <= cells


def test_layer_names_agree():
    by_layer = {}
    for m in M["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


def test_pairs_chips_and_budget():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)
    # a full check of 24 cells fits: 2 + 14 x 24 runs of run_seconds + 60,
    # 2 x 90 s of compiling a cell, 1200 s spare, in 43200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = os.path.join(ROOT, cfg["file"])
    assert cfg["file"].startswith(M["paths"][0] + "/")
    with open(path) as f:
        c = json.load(f)
    assert c["name"] == cfg["name"] and c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
    for key in ("algorithm", "entry", "reference", "corpus", "file_bytes", "roofline_bytes", "assumed"):
        assert key in c, key
    assert os.path.exists(os.path.join(BENCH_DIR, "reference", f"{c['reference']}.py"))
    assert os.path.exists(os.path.join(BENCH_DIR, "corpora", f"{c['corpus']}.py"))
    assert "%" not in c["algorithm"]
    files = [x["file"] for x in M["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_cell_parts(cell):
    assert cell["config"] in {c["name"] for c in M["configs"]}
    with open(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json")) as f:
        t = json.load(f)
    assert t["name"] == cell["traffic"] and t["loop"] == "closed" and t["clients"] == 1
    assert t["files"] >= 1 and t["ops"] and set(t["ops"]) <= {"compress", "decompress"}
    with open(os.path.join(ROOT, next(c["file"] for c in M["configs"] if c["name"] == cell["config"]))) as f:
        c = json.load(f)
    assert set(t["ops"]) <= set(c["entry"]) and set(t["ops"]) <= set(c["roofline_bytes"])


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_metric_files_declare_what_the_manifest_says(metric):
    from portbench.bench import Bench

    mod = Bench(ROOT).module("metrics", metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"]
    )
    assert callable(mod.read)


def test_files_under_paths_are_named_from_name_characters():
    for p in M["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(ROOT, p)):
            dirs[:] = [d for d in dirs if d not in ("__pycache__", ".pytest_cache")]
            for f in files:
                if f.endswith(".pyc"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                assert PATH.match(rel), rel
