"""Shared fixtures of the benchmark's tests: the repository on sys.path, the
`cuda` marker, and a throwaway benchmark (its own BENCHMARK.json, configs
and mixes at small sizes, the harness's readers, corpora and references
copied beside them) that the harness resolves without an edit. Its second
cell is the Huffman roundtrip, whose files wait under portbench/ for a
manifest entry (PERF.md, Open questions)."""

import importlib.util
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "portbench")
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is false"
    )


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def make_throwaway(tmp, file_bytes=48_000, block_size=8192):
    """A benchmark rooted at `tmp` with two small cells of its own, named
    apart from the real ones; returns the root."""
    bdir = os.path.join(tmp, "throwaway")
    for kind in ("metrics", "corpora", "reference"):
        shutil.copytree(os.path.join(BENCH_DIR, kind), os.path.join(bdir, kind))
    os.makedirs(os.path.join(bdir, "configs"))
    os.makedirs(os.path.join(bdir, "traffic"))
    real = manifest()
    configs = []
    for name, cfg_file in (("tiny-lzss", "lzss_lcp-english50"), ("tiny-huff", "huff-bw256k-english50")):
        with open(os.path.join(BENCH_DIR, "configs", f"{cfg_file}.json")) as f:
            cfg = json.load(f)
        cfg["name"] = name
        cfg["file_bytes"] = file_bytes
        if cfg["block_size"]:
            cfg["block_size"] = block_size
            cfg["algorithm"] = f"blockwise(encode(huff),bs={block_size})"
        with open(os.path.join(bdir, "configs", f"{name}.json"), "w") as f:
            json.dump(cfg, f)
        configs.append({"name": name, "source": cfg["source"], "file": f"throwaway/configs/{name}.json",
                        "reduced": [], "why": "a test"})
    for mix in ("encode-2files", "roundtrip-4files"):
        with open(os.path.join(BENCH_DIR, "traffic", f"{mix}.json")) as f:
            t = json.load(f)
        t["name"] = "tiny-" + mix
        with open(os.path.join(bdir, "traffic", f"tiny-{mix}.json"), "w") as f:
            json.dump(t, f)
    lz, hf = "tiny-lzss.encode", "tiny-huff.roundtrip"
    workloads = [
        {"name": lz, "config": "tiny-lzss", "traffic": "tiny-encode-2files", "chips": 1, "why": "a test"},
        {"name": hf, "config": "tiny-huff", "traffic": "tiny-roundtrip-4files", "chips": 1, "why": "a test"},
    ]
    # every reader under metrics/, with the cells it reads in
    cells_of = {"textds_ms_per_MiB": [lz], "factorize_ms_per_MiB": [lz], "coder_ms_per_MiB.lzss": [lz],
                "device_idle_pct.encode": [lz, hf], "kernels_roofline.encode": [lz, hf]}
    per_layer = []
    for f in sorted(os.listdir(os.path.join(BENCH_DIR, "metrics"))):
        if not f.endswith(".py") or f == "__init__.py":
            continue
        name = f[:-3]
        spec = importlib.util.spec_from_file_location("m", os.path.join(BENCH_DIR, "metrics", f))
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        per_layer.append({"name": name, "unit": m.UNIT, "better": "lower", "source": m.SOURCE, "layer": m.LAYER,
                          "moves": m.MOVES, "workloads": cells_of.get(name, [hf])})
    end_to_end = real["end_to_end"] + [
        {"name": "decode_MBps", "unit": "MB/s", "better": "higher", "bound": 0.25, "source": "host_clock",
         "workloads": [hf]}
    ]
    doc = dict(real, paths=["throwaway"], configs=configs, workloads=workloads, end_to_end=end_to_end,
               per_layer=per_layer)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    return tmp


@pytest.fixture
def throwaway(tmp_path):
    return make_throwaway(str(tmp_path))
