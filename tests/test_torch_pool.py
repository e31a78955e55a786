"""Blockwise's worker pools and TDC_BLOCKWISE_PROCS on the CPU.

A spawned pool re-imports its parent's __main__, which a pytest-xdist
worker does not have as a file (the pool then takes its sequential arm),
so each pool runs in a subprocess whose __main__ is a script written here.
The script encodes host inners of 8 blocks or more with
TDC_BLOCKWISE_PROCS=2 (the spawn pool of processes) and =0, and decodes
each container with =2 (the thread pool) and =0, and reports the worker
count each arm's StatPhase logged; the containers must equal the JAX
package's (computed here, its pool off) byte for byte, and the decodes the
input. The pool's children run on the parent's device, here the CPU: a
child that took the default "cuda" would raise on this machine, which has
no card. A pool whose children fail raises in the parent, and the command
line's --stats under TDC_MALLOC_HOOK=1 still reports the parent's phases
with a pool.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tudocomp_tpu.driver import compress as jax_compress
from tudocomp_tpu_torch.compressors import blockwise
from tudocomp_tpu_torch.driver import compress, decompress

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALGOS = {"blockwise(lzss(coder=bit),bs=1024)": 10 << 10, "blockwise(lz78u,bs=2048)": 18 << 10}

SCRIPT = """
import json, os, sys

sys.path.insert(0, %(repo)r)
if __name__ == "__mp_main__" and os.environ.get("POOL_TEST_CHILD_FAILS"):
    raise RuntimeError("this child fails to start")


def spans(doc, out):
    for c in doc["sub"]:
        stats = {s["key"]: s["value"] for s in c["stats"]}
        if "workers" in stats:
            out[c["title"]] = int(stats["workers"])
        spans(c, out)
    return out


def run(fn):
    from tudocomp_tpu_torch.stats.phase import StatPhase

    with StatPhase("root") as root:
        result = fn()
    return result, spans(root.to_dict(), {})


if __name__ == "__main__":
    from tudocomp_tpu_torch.driver import compress, decompress

    out = sys.argv[1]
    report = {}
    for i, algo in enumerate(sys.argv[2:]):
        with open(os.path.join(out, f"{i}.input"), "rb") as f:
            data = f.read()
        for procs in ("2", "0"):
            os.environ["TDC_BLOCKWISE_PROCS"] = procs
            container, enc = run(lambda: compress(algo, data, device="cpu"))
            with open(os.path.join(out, f"{i}.{procs}.bin"), "wb") as f:
                f.write(container)
            back, dec = run(lambda: decompress(container, device="cpu"))
            assert back == data, (algo, procs)
            report[f"{algo} {procs}"] = {"encode": enc, "decode": dec}
    assert "jax" not in sys.modules and "tudocomp_tpu" not in sys.modules
    print(json.dumps(report))
""" % {"repo": REPO}


def _text(n: int) -> bytes:
    rng = np.random.default_rng(9)
    words = [b"pool", b"block", b"worker", b"spawn", b"the", b"of", b"a", b"container", b"\n"]
    return b" ".join(words[i] for i in rng.integers(0, len(words), n))[:n]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "TDC_BLOCKWISE_PROCS" and not k.startswith("TDC_DEVICE_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2", **extra)
    return env


def _run_script(tmp, algos, **env):
    script = tmp / "pool_main.py"
    script.write_text(SCRIPT)
    for i, algo in enumerate(algos):
        (tmp / f"{i}.input").write_bytes(_text(ALGOS[algo]))
    return subprocess.run([sys.executable, str(script), str(tmp), *algos], capture_output=True, text=True,
                          timeout=300, env=_env(**env))


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pool")
    r = _run_script(tmp, list(ALGOS))
    assert r.returncode == 0, r.stderr[-3000:]
    return tmp, json.loads(r.stdout.splitlines()[-1])


@pytest.mark.parametrize("algo", list(ALGOS))
def test_pools_give_the_jax_package_bytes(pools, algo, monkeypatch):
    tmp, report = pools
    i = list(ALGOS).index(algo)
    data = _text(ALGOS[algo])
    assert len(data) // int(algo.split("bs=")[1][:-1]) >= blockwise.POOL_MIN_BLOCKS
    monkeypatch.setenv("TDC_BLOCKWISE_PROCS", "0")  # read by both packages: no pool in this process
    want = jax_compress(algo, data)
    assert (tmp / f"{i}.2.bin").read_bytes() == want
    assert (tmp / f"{i}.0.bin").read_bytes() == want
    assert compress(algo, data, device="cpu") == want
    assert decompress(want, device="cpu") == data
    # the arm that ran, as each StatPhase logged it
    assert report[f"{algo} 2"] == {"encode": {"host blockwise encode": 2}, "decode": {"blockwise decode": 2}}
    assert report[f"{algo} 0"] == {"encode": {"host blockwise encode": 0}, "decode": {"blockwise decode": 0}}


def test_a_failing_pool_raises(tmp_path):
    r = _run_script(tmp_path, ["blockwise(lz78u,bs=2048)"], POOL_TEST_CHILD_FAILS="1")
    assert r.returncode != 0
    assert "BrokenProcessPool" in r.stderr, r.stderr[-3000:]


def test_stats_with_a_pool_under_the_malloc_hook(tmp_path, monkeypatch):
    """-s with a pool of two under TDC_MALLOC_HOOK=1: the document holds the
    parent's phases, the pool's StatPhase with its workers among them; the
    heap columns are the parent's (each child has its own counters)."""
    src = tmp_path / "in.txt"
    data = _text(18 << 10)
    src.write_bytes(data)
    r = subprocess.run([sys.executable, "-m", "tudocomp_tpu_torch", "--device", "cpu", "-a",
                        "blockwise(lz78u,bs=2048)", "-s", "pool", str(src)], capture_output=True, text=True,
                       timeout=300, cwd=str(tmp_path),
                       env=_env(TDC_BLOCKWISE_PROCS="2", TDC_MALLOC_HOOK="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads(r.stdout.splitlines()[-1])

    def find(node, title):
        if node["title"] == title:
            return node
        return next((f for c in node["sub"] if (f := find(c, title)) is not None), None)

    phase = find(doc["data"], "host blockwise encode")
    assert phase is not None, doc
    assert {s["key"]: s["value"] for s in phase["stats"]}["workers"] == "2"
    assert doc["data"]["memPeak"] > 0
    monkeypatch.setenv("TDC_BLOCKWISE_PROCS", "0")
    assert (tmp_path / "in.txt.tdc").read_bytes() == compress("blockwise(lz78u,bs=2048)", data, device="cpu")


def test_pool_workers(monkeypatch):
    monkeypatch.delenv("TDC_BLOCKWISE_PROCS", raising=False)
    assert blockwise.pool_workers() == blockwise.DEFAULT_WORKERS
    monkeypatch.setenv("TDC_BLOCKWISE_PROCS", "3")
    assert blockwise.pool_workers() == 3
    monkeypatch.setenv("TDC_BLOCKWISE_PROCS", "0")
    assert blockwise.pool_workers() == 0
    monkeypatch.setenv("TDC_BLOCKWISE_PROCS", "many")
    with pytest.raises(ValueError, match="TDC_BLOCKWISE_PROCS"):
        blockwise.pool_workers()
