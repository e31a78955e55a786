"""One run of one cell: inputs from the seed, warm-up, the window, the check.

A run loads its cell from `BENCHMARK.json`, makes the configuration's
files from `--seed` with the configuration's corpus generator, and warms
up with one round of the traffic's operations on the first file: the
kernels build or load, the host library loads, the allocator grows.
Everything up to here is `setup_s`. Then the window: a closed loop with
one client that runs rounds, each the traffic's operations on the next
file (compress it; decompress what that returned), until a round ends
`--seconds` after the window began; the window closes when the last round
begun before then has ended. Each call is timed from entry until its
bytes are in host memory and the card has finished.

`encode_MBps` is the input bytes of every compress call over their summed
seconds, `decode_MBps` the bytes every decompress call returned over
theirs (MB = 10^6 bytes). With `--trace 1` the window runs under
torch.profiler and the program's StatPhase spans are kept per call; the
run then reports the cell's per-layer metrics, read by the files under
metrics/, in place of the end-to-end ones.

Correct means `answers_wrong` is 0: the calls that failed, the
containers unlike the one the configuration's plain reference
(reference/<family>.py) computes from the same file after the window and
the memory reading, and the decompressed outputs unlike their file. The
number is printed with its limit as the last line of standard error and
as the result's last key.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field

from .bench import Bench
from . import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "tudocomp_tpu")
# what the benchmark reads of the program beside its entry points: its spans
# and its kernel launch counters
PHASES = "tudocomp_tpu_torch.stats.phase:StatPhase"
COUNTS = "tudocomp_tpu_torch.kernels:counts"
RESET_COUNTS = "tudocomp_tpu_torch.kernels:reset_counts"
MiB = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


@dataclass
class Call:
    op: str
    file: int
    file_bytes: int  # the uncompressed file's size
    bytes_in: int
    bytes_out: int
    seconds: float
    t0: float  # host monotonic seconds at entry
    phases: list = field(default_factory=list)  # [(start_s, end_s, path)]
    cpu_s: float = 0.0  # this process's CPU seconds in the call
    same: bool = True  # equals the file (decompress), or the file's first container
    failed: bool = False


class Run:
    """What the per-layer readers (metrics/*.py) read."""

    def __init__(self, config: dict, calls: list, summary):
        self.config = config
        self.calls = calls
        self.trace = summary  # trace.summarize's, or None

    def of(self, op: str) -> list:
        return [c for c in self.calls if c.op == op and not c.failed]

    def phase_ms_per_mib(self, op: str, title: str):
        """Summed ms of the top-level StatPhase `title` in the op's calls,
        per MiB of their files; None where no call opened it."""
        calls = self.of(op)
        ms = [b - a for c in calls for a, b, p in c.phases if p == (title,)]
        if not ms:
            return None
        return 1e3 * sum(ms) / (sum(c.file_bytes for c in calls) / MiB)

    def _traced(self, op: str) -> list:
        if self.trace is None:
            return []
        return [t for c, t in zip(self.calls, self.trace["calls"]) if c.op == op and not c.failed]

    def device_idle_pct(self, op: str):
        """Share of the op's calls' wall time with nothing on the card."""
        t = self._traced(op)
        wall = sum(x["wall_us"] for x in t)
        if not wall:
            return None
        return 100.0 * (1.0 - sum(x["busy_us"] for x in t) / wall)

    def kernels_roofline_pct(self, op: str):
        """The least time for the bytes the configuration counts for the
        op (`roofline_bytes`: per byte in and per byte out, each read or
        written once) over 3.35 TB/s, against the op's summed kernel time."""
        t = self._traced(op)
        kern = sum(x["kernel_us"] for x in t) / 1e6
        coef = self.config["roofline_bytes"][op]
        calls = self.of(op)
        need = sum(coef["in"] * c.bytes_in + coef["out"] * c.bytes_out for c in calls)
        if kern <= 0 or need <= 0:
            return None
        return 100.0 * need / HBM_BYTES_PER_S / kern


def _flatten(phase, path=()) -> list:
    out = []
    for ch in phase.children:
        p = path + (ch.title,)
        out.append((ch.time_start / 1e3, ch.time_end / 1e3, p))
        out += _flatten(ch, p)
    return out


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit by nvidia-smi, or 'not measured'."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def run_cell(bench: Bench, cell: dict, seed: int, seconds: float, traced: bool, device, t0: float,
             entries=None, log=None) -> dict:
    """One run; returns the result object (without the forbidden-module
    check, which main makes). `entries` replaces the configuration's
    entry points ({op: fn}), for the control and the fault tests."""
    import torch

    log = log or sys.stderr
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    if traffic["loop"] != "closed" or traffic["clients"] != 1 or config.get("ranks", 1) != 1:
        raise ValueError("this harness drives a closed loop with one client, one process")
    ops = traffic["ops"]
    corpus = bench.module("corpora", config["corpus"])
    size = int(config["file_bytes"])
    files = [corpus.generate(seed, i, size) for i in range(int(traffic["files"]))]
    entries = entries or {op: bench.entry(config["entry"][op]) for op in ops}
    algorithm = config["algorithm"]
    cuda = torch.device(device).type == "cuda"
    phase_cls = bench.entry(PHASES) if traced else None

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def call(op, k, arg, timed_range):
        fn = entries[op]
        r_a = resource.getrusage(resource.RUSAGE_SELF)
        t_a = time.monotonic()
        root = None
        try:
            with timed_range(f"{tr.RANGE_PREFIX}{op}"):
                if phase_cls is not None:
                    root = phase_cls("portbench call")
                    root.__enter__()
                try:
                    out = fn(algorithm, arg, device=device) if op == "compress" else fn(arg, device=device)
                    sync()
                finally:
                    if root is not None:
                        root.__exit__(None, None, None)
        except Exception:
            traceback.print_exc(file=log)
            out = None
        secs = time.monotonic() - t_a
        r_b = resource.getrusage(resource.RUSAGE_SELF)
        cpu = r_b.ru_utime + r_b.ru_stime - r_a.ru_utime - r_a.ru_stime
        c = Call(op, k, size, len(arg), len(out) if out is not None else 0, secs, t_a,
                 _flatten(root) if root is not None else [], cpu, failed=out is None)
        return c, out

    def no_range(name):
        return contextlib.nullcontext()

    def rnd(k, sink, timed_range):
        arg = files[k]
        for op in ops:
            c, out = call(op, k, arg, timed_range)
            sink.append((c, out))
            if out is None:
                return
            arg = out

    warm = []
    rnd(0, warm, no_range)
    if any(c.failed for c, _ in warm):
        print("portbench: the warm-up call failed", file=log)
    del warm
    sync()
    bench.entry(RESET_COUNTS)()
    setup_s = time.monotonic() - t0

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        timed_range = record_function
    else:
        timed_range = no_range
    calls, kept = [], {}
    start = time.monotonic()
    r = 0
    while r == 0 or time.monotonic() - start < seconds:
        k = r % len(files)
        done = []
        rnd(k, done, timed_range)
        for c, out in done:
            if c.failed:
                pass
            elif c.op == "decompress":
                c.same = out == files[k]
            elif k in kept:
                c.same = out == kept[k]
            else:
                kept[k] = out  # the reference checks it after the window
            calls.append(c)
        r += 1
    window_s = time.monotonic() - start
    summary = None
    if prof is not None:
        sync()
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            ranges, dev_ops = tr.load(path)
        summary = tr.summarize(ranges, dev_ops, calls)
        if summary is None:
            print(f"portbench: the trace holds {len(dev_ops)} device ops and {len(ranges)} "
                  f"ranges for {len(calls)} calls: no trace metrics", file=log)
    launches = bench.entry(COUNTS)()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the check, after the window and the memory reading, with the
    # program's state gone
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference = bench.module("reference", config["reference"])
    t_ref = time.monotonic()
    kept_ok = {k: out == reference.compress(algorithm, files[k], config, device) for k, out in kept.items()}
    ref_s = time.monotonic() - t_ref
    failed = sum(c.failed for c in calls)
    bad_containers = sum(1 for c in calls if c.op == "compress" and not c.failed and not (c.same and kept_ok[c.file]))
    bad_outputs = sum(1 for c in calls if c.op == "decompress" and not c.failed and not c.same)
    checks = {"answers_wrong": {"value": failed + bad_containers + bad_outputs, "limit": 0}}
    correct = bool(calls) and all(v["value"] <= v["limit"] for v in checks.values())

    e2e = {}
    for op, name in (("compress", "encode_MBps"), ("decompress", "decode_MBps")):
        cs = [c for c in calls if c.op == op]
        if cs:
            moved = sum(c.file_bytes for c in cs)
            e2e[name] = moved / sum(c.seconds for c in cs) / 1e6
    e2e["setup_s"] = setup_s

    for i, c in enumerate(calls):
        print(f"portbench: call {i} {c.op} file {c.file} {c.seconds:.6f} s "
              f"{c.file_bytes / c.seconds / 1e6:.3f} MB/s in {c.bytes_in} out {c.bytes_out} "
              f"cpu {c.cpu_s:.2f} s"
              f"{' FAILED' if c.failed else ''}{'' if c.same else ' DIFFERS'}", file=log)
    print(f"portbench: calls failed {failed}, containers unlike the reference's {bad_containers}, "
          f"outputs unlike their file {bad_outputs}", file=log)
    print(f"portbench: window {window_s:.3f} s, {len(calls)} calls; reference {ref_s:.3f} s; "
          f"end to end {json.dumps(e2e)}; card {power_limit()}", file=log)
    print("launches " + json.dumps({k: v for k, v in launches.items() if v}), flush=True)

    units = {m["name"]: m["unit"] for m in bench.manifest["end_to_end"] + bench.manifest["per_layer"]}
    metrics = {}
    if traced:
        run = Run(config, calls, summary)
        for m in bench.per_layer(cell["name"]):
            v = bench.module("metrics", m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in bench.end_to_end(cell["name"]):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": correct, "attempted": len(calls), "failed": failed, "metrics": metrics, "device": dev}
    if traced and summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {
            "device_ops": [list(x) for x in summary["device_ops"]],
            "idle_gaps": [list(x) for x in summary["idle_gaps"]],
        }
    result["checks"] = checks
    return result


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float, root: str) -> int:
    args = parse(argv)
    bench = Bench(root)
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
