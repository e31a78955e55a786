"""The port's command line on the CPU: twins of tests/test_cli.py.

Each test drives `python -m tudocomp_tpu_torch ... --device cpu` the way its
twin drives `python -m tudocomp_tpu`, and holds the port to the JAX
package's command line run with the same flags: the output files and
streams must be equal byte for byte, and the --stats documents must have
the same keys. The port runs in this process (main(argv), which skips the
TDC_MALLOC_HOOK re-exec, as the JAX package's does) where stdin, stdout
and the exit code can be handed over, and in a subprocess where the test
needs the process itself: piped stdin/stdout, the malloc interposer's
re-exec, --device cuda on a machine without a card. The JAX package's
command line always runs in a subprocess.
"""

from __future__ import annotations

import io
import json
import logging
import os
import subprocess
import sys
import tracemalloc

import pytest
import torch

from tudocomp_tpu_torch import __main__ as cli
from tudocomp_tpu_torch.stats.phase import StatPhase

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module: str, args, data=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", module, *args], input=data, capture_output=True, env=env, timeout=300
    )


def jax_tdc(*args, data=None):
    """The JAX package's command line, in a subprocess."""
    return _run("tudocomp_tpu", args, data)


def port_tdc_process(*args, data=None):
    """The port's command line on the CPU, in a subprocess."""
    return _run("tudocomp_tpu_torch", [*args, "--device", "cpu"], data)


class _Result:
    def __init__(self, returncode, stdout, stderr):
        self.returncode, self.stdout, self.stderr = returncode, stdout, stderr


def port_tdc(*args, data=b""):
    """The port's command line on the CPU, in this process: main(argv) with
    stdin, stdout and stderr handed over, and the state it sets (StatPhase's
    switches, the package logger, tracemalloc) put back."""
    logger = logging.getLogger("tudocomp_tpu_torch")
    saved = (StatPhase.track_memory, StatPhase.track_device, logger.level, logger.propagate, list(logger.handlers))
    was_tracing = tracemalloc.is_tracing()
    streams = sys.stdin, sys.stdout, sys.stderr
    out = io.BytesIO()
    sys.stdin = io.TextIOWrapper(io.BytesIO(data))
    sys.stdout = io.TextIOWrapper(out, write_through=True)
    sys.stderr = io.StringIO()
    try:
        rc = cli.main([*args, "--device", "cpu"])
        sys.stdout.flush()
        return _Result(rc, out.getvalue(), sys.stderr.getvalue().encode())
    finally:
        sys.stdin, sys.stdout, sys.stderr = streams
        StatPhase.track_memory, StatPhase.track_device, logger.level, logger.propagate, handlers = saved
        logger.handlers[:] = handlers
        if tracemalloc.is_tracing() and not was_tracing:
            tracemalloc.stop()


def keys(doc):
    """The key structure of a --stats document: its keys, its meta's, and
    the key set of each phase."""
    nodes, todo = set(), [doc["data"]]
    while todo:
        node = todo.pop()
        nodes.add(tuple(sorted(node)))
        todo += node["sub"]
    return sorted(doc), sorted(doc["meta"]), nodes


def test_roundtrip_file(tmp_path):
    f = tmp_path / "in.txt"
    f.write_bytes(b"abcabcabcabc hello hello")
    r = port_tdc("-a", "lz78", str(f))
    assert r.returncode == 0, r.stderr
    packed = (tmp_path / "in.txt.tdc").read_bytes()
    (tmp_path / "in.txt.tdc").unlink()
    assert jax_tdc("-a", "lz78", str(f)).returncode == 0
    assert (tmp_path / "in.txt.tdc").read_bytes() == packed
    r = port_tdc("-d", str(f) + ".tdc", "--usestdout")
    assert r.returncode == 0, r.stderr
    assert r.stdout == b"abcabcabcabc hello hello"


def test_header_emission(tmp_path):
    # header is `<id-string>%` (tudocomp_driver_tests.cpp:28-49)
    f = tmp_path / "x.txt"
    f.write_bytes(b"abc")
    r = port_tdc("-a", "lz78(coder=ascii)", str(f), "--usestdout")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(b"lz78(coder=ascii)%")
    assert r.stdout == jax_tdc("-a", "lz78(coder=ascii)", str(f), "--usestdout").stdout


def test_stdin_stdout():
    r = port_tdc_process("-a", "encode(huff)", "--usestdin", "--usestdout", data=b"tobeornottobe")
    assert r.returncode == 0, r.stderr
    assert r.stdout == jax_tdc("-a", "encode(huff)", "--usestdin", "--usestdout", data=b"tobeornottobe").stdout
    r2 = port_tdc("-d", "--usestdin", "--usestdout", data=r.stdout)
    assert r2.stdout == b"tobeornottobe"


def test_raw_mode():
    r = port_tdc("-a", "rle", "--raw", "--usestdin", "--usestdout", data=b"aaaabbbb")
    assert r.returncode == 0, r.stderr
    assert not r.stdout.startswith(b"rle%")
    assert r.stdout == jax_tdc("-a", "rle", "--raw", "--usestdin", "--usestdout", data=b"aaaabbbb").stdout
    r2 = port_tdc("-d", "-a", "rle", "--raw", "--usestdin", "--usestdout", data=r.stdout)
    assert r2.stdout == b"aaaabbbb"


def test_generator_input():
    r = port_tdc("-g", "fib(n=5)", "-a", "noop", "--raw", "--usestdout")
    assert r.returncode == 0, r.stderr
    assert r.stdout == b"abaab"
    want = jax_tdc("-g", "fib(n=12)", "-a", "lz78u", "--usestdout").stdout
    assert port_tdc("-g", "fib(n=12)", "-a", "lz78u", "--usestdout").stdout == want


def test_list():
    r = port_tdc("-l")
    assert r.returncode == 0
    out = r.stdout.decode()
    for name in ("lz78", "huff", "rle", "mtf", "chain", "fib", "lz78u", "lfs_comp", "lfs2bst", "blockwise"):
        assert name in out, name
    assert r.stdout == jax_tdc("-l").stdout


def test_stats_json(tmp_path):
    f = tmp_path / "s.txt"
    f.write_bytes(b"x" * 1000)
    r = port_tdc("-a", "rle", str(f), "-s", "mytitle")
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout)
    assert doc["meta"]["title"] == "mytitle"
    assert doc["meta"]["inputSize"] == 1000
    assert doc["meta"]["outputSize"] == os.path.getsize(str(f) + ".tdc")
    assert doc["meta"]["rate"] == doc["meta"]["outputSize"] / 1000
    assert doc["data"]["title"] == "root"
    packed = (tmp_path / "s.txt.tdc").read_bytes()
    (tmp_path / "s.txt.tdc").unlink()
    j = jax_tdc("-a", "rle", str(f), "-s", "mytitle")
    assert (tmp_path / "s.txt.tdc").read_bytes() == packed
    assert keys(json.loads(j.stdout)) == keys(doc)
    # on the CPU no phase carries a device memory column
    assert not any(s["key"].startswith("devMem") for s in doc["data"]["stats"])


def test_error_cases(tmp_path):
    assert port_tdc().returncode == 1
    assert port_tdc("-a", "nonexistent", "--usestdin", "--usestdout", data=b"x").returncode == 1
    f = tmp_path / "e.txt"
    f.write_bytes(b"abc")
    # existing output without -f
    (tmp_path / "e.txt.tdc").write_bytes(b"old")
    r = port_tdc("-a", "noop", str(f))
    assert r.returncode == 1
    assert b"already exists" in r.stderr
    # -f overwrites
    assert port_tdc("-a", "noop", str(f), "-f").returncode == 0
    assert (tmp_path / "e.txt.tdc").read_bytes() == b"noop%abc"
    # multiple inputs
    assert port_tdc("-a", "noop", "--usestdin", str(f), data=b"").returncode == 1
    # decompressing a generated string
    assert port_tdc("-d", "-g", "fib(n=3)", "--usestdout").returncode == 1
    # the same codes from the process, and the JAX package's
    for args in ((), ("-d", "-g", "fib(n=3)", "--usestdout")):
        assert port_tdc_process(*args).returncode == jax_tdc(*args).returncode == 1


def test_cuda_without_a_card_raises(tmp_path):
    """--device cuda, the default, does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this case checks the machine without one")
    f = tmp_path / "c.txt"
    f.write_bytes(b"abc" * 100)
    r = _run("tudocomp_tpu_torch", ["-a", "lz78u", str(f)])
    assert r.returncode == 1
    assert b"no CUDA device is available" in r.stderr
    assert not (tmp_path / "c.txt.tdc").exists()


def test_generators_library():
    from tudocomp_tpu.generators import generators as jax_generators
    from tudocomp_tpu_torch.generators.generators import (
        fibonacci_word,
        random_uniform,
        run_rich,
        thue_morse_word,
    )

    assert fibonacci_word(1) == b"b"
    assert fibonacci_word(2) == b"a"
    assert fibonacci_word(3) == b"ab"
    assert fibonacci_word(4) == b"aba"
    assert fibonacci_word(5) == b"abaab"
    assert fibonacci_word(6) == b"abaababa"

    assert thue_morse_word(0) == b"0"
    assert thue_morse_word(1) == b"0"
    assert thue_morse_word(2) == b"01"
    assert thue_morse_word(3) == b"0110"
    assert thue_morse_word(4) == b"01101001"
    with pytest.raises(ValueError):
        thue_morse_word(64)

    assert run_rich(0) == b"0110101101001011010"
    assert run_rich(1) == b"0110101101001"
    assert run_rich(2) == b"01101011010010110101101"
    assert run_rich(3) == b"01101011010010110101101" + b"0110101101001"
    assert run_rich(5).startswith(run_rich(4))

    s = random_uniform(100, seed=42)
    assert s == random_uniform(100, seed=42)
    assert all(ord("0") <= c <= ord("9") for c in s)
    s2 = random_uniform(50, seed=1, lo=ord("a"), hi=ord("c"))
    assert all(ord("a") <= c <= ord("c") for c in s2)

    for n in (7, 20):
        assert fibonacci_word(n) == jax_generators.fibonacci_word(n)
        assert thue_morse_word(n) == jax_generators.thue_morse_word(n)
        assert run_rich(n) == jax_generators.run_rich(n)
    assert random_uniform(500, seed=9) == jax_generators.random_uniform(500, seed=9)


@pytest.mark.parametrize("hook", ["0", "1"])
def test_stats_include_memory_columns(tmp_path, hook):
    """--stats runs carry the heap columns: from tracemalloc, or with
    TDC_MALLOC_HOOK=1 from the malloc interposer, which the process re-execs
    itself with once (the heap then counts every malloc, the interpreter's
    and PyTorch's included: memOff is far above what tracemalloc sees)."""
    src = tmp_path / "in.bin"
    src.write_bytes(b"memory column check " * 500)
    args = ("-a", "encode(huff)", str(src), "-o", str(tmp_path / "out.tdc"), "-f", "--stats")
    env = dict(os.environ, PYTHONPATH=REPO, TDC_MALLOC_HOOK=hook)
    proc = subprocess.run(
        [sys.executable, "-m", "tudocomp_tpu_torch", *args, "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    doc = json.loads([line for line in proc.stdout.splitlines() if line.startswith("{")][-1])
    root = doc["data"]
    assert {"memOff", "memPeak", "memFinal"} <= set(root)
    assert root["memPeak"] > 0
    if hook == "1":
        assert root["memOff"] > 16 << 20
    want = (tmp_path / "out.tdc").read_bytes()
    (tmp_path / "out.tdc").unlink()
    assert jax_tdc(*args).returncode == 0
    assert (tmp_path / "out.tdc").read_bytes() == want


def test_truncated_container_raises():
    """A container cut off mid-stream must raise, not silently produce a
    short output (the bit reader's overran flag marks reads past the valid
    end), as in the JAX package."""
    from tudocomp_tpu.driver import compress as jax_compress
    from tudocomp_tpu_torch.driver import compress, decompress

    data = b"the quick brown fox jumps over the lazy dog" * 4
    for algo in ("lcpcomp(coder=huff)", "lzss_lcp(coder=huff)", "lz78u", "lfs_comp", "lfs2"):
        c = compress(algo, data, device="cpu")
        assert c == jax_compress(algo, data)
        for cut in (len(c) // 3, len(c) // 2):
            with pytest.raises((ValueError, AssertionError, IndexError)):
                out = decompress(c[:cut], device="cpu")
                assert out == data


def test_stats_device_memory_columns(monkeypatch):
    """With StatPhase.track_device set, each phase carries devMemOff and
    devMemFinal as read when it opens and closes, and devMemPeak, the most
    above devMemOff that it or a phase inside it held; the reads go to the
    device that was set. (The reads are stood in for here: the card's are
    torch.cuda's, tests/test_torch_cuda.py::test_cli_stats_on_the_card.)"""
    from tudocomp_tpu_torch.stats import phase

    state = {"cur": 100, "peak": 100}
    asked = []

    def read(dev):
        asked.append(dev)
        return state["cur"], state["peak"]

    def reset(dev):
        state["peak"] = state["cur"]

    def alloc(n):
        state["cur"] += n
        state["peak"] = max(state["peak"], state["cur"])

    monkeypatch.setattr(phase, "_dev_read", read)
    monkeypatch.setattr(phase, "_dev_reset_peak", reset)
    monkeypatch.setattr(StatPhase, "track_device", "card 1")
    with StatPhase("root") as root:
        alloc(50)
        with StatPhase("inner") as inner:
            alloc(1000)
            alloc(-1000)
        alloc(-20)
    got = {s["key"]: s["value"] for s in inner.to_dict()["stats"]}
    assert got == {"devMemOff": "150", "devMemPeak": "1000", "devMemFinal": "150"}
    got = {s["key"]: s["value"] for s in root.to_dict()["stats"]}
    assert got == {"devMemOff": "100", "devMemPeak": "1050", "devMemFinal": "130"}
    assert set(asked) == {"card 1"}
