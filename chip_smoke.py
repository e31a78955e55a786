#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tudocomp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns PARENT   # kernels D, H, E, F and P7 of PARENT's checkout and this one, in turns
    python3 chip_smoke.py --dh ROOT        # kernels D, H, E, F and P7 of ROOT's checkout, one JSON line

Runs from the root of a checkout and needs one CUDA card. The reference
of every phase is the port's own host path: driver.compress(algo, data,
device="cpu") and decompress(container, device="cpu") with
TDC_DEVICE_HUFF=0, TDC_DEVICE_LZ78=0, TDC_DEVICE_SA=0 and TDC_DEVICE_LZSS=0,
which run the port's copies of the host coders, parses and suffix stack
(the CPU tests hold those byte-equal to the JAX package). Phases, one JSON
line each:
  1. build          compile the CUDA kernels from tudocomp_tpu_torch/csrc,
                    one nvcc per source, in parallel, and the C++ host
                    helpers (g++) beside them;
  2. kernels        kernels A-D against their plain PyTorch versions on the
                    card, at the shapes of the Huffman path, held to exact
                    equality (every stage is integer arithmetic); D also on
                    phase 3's input as 256 streams of 256 KiB (the CLI's
                    block size), held to the input, with the largest count
                    of synchronisation rounds at both shapes;
  3. roundtrip      a seeded 64 MiB input through
                    driver.compress / decompress("blockwise(encode(huff))",
                    device="cuda"); the container must equal, byte for byte,
                    the one the host path writes, and both decoders must
                    return the input; kernels A-D must have been launched;
  4. timing         CUDA-event times of kernels A-D and their plain versions
                    (D at both of phase 2's shapes), and the end-to-end
                    encode / decode rates of the roundtrip;
  5. shared         kernel G (Moffat phases 1-2, int64) against its plain
                    version, exactly, on the summed histogram of the 64 MiB
                    input, on phase 2's 69 histograms and on a row with
                    weights past 2^31; the 64 MiB input through
                    blockwise(encode(huff),shared=1) on the card, decoded
                    on the card and by the host decoder, block 0's table
                    holding Kraft's equality, G, A, B and D launched; the
                    card's container of a 16 MiB prefix equal to the port's
                    CPU run (plain versions); G's times, and the warm
                    encode / decode rates with and without shared;
  6. lz78 kernels   kernels E (LZ78 parse) and F (LZW parse) against their
                    plain versions and the host parses, exactly, at the
                    shapes phase 7 launches them with (the whole input as
                    [200, 262144] and [6400, 8192]; the plain version of the
                    first runs on its first 32 blocks, the host parse on all
                    200), at [128, 8192], at an odd batch of 131 blocks, and
                    E on [4, 262144] of one letter (phrases up to 724 bytes)
                    and of uniform random bytes (its table near its worst
                    load), and F on phase 8's 4 MiB blocks (the host parse
                    on all, the plain version on the first two blocks'
                    first 64 KiB); E's wrapper and device ms at both
                    main-path shapes, with the factors of the longest block
                    (the longest chain of rounds) and the ms per factor;
                    F's at [6400, 8192] and 4 MiB; both kernels' registers
                    a thread, CTAs an SM and waves at [6400, 8192];
  7. lz78 roundtrip 50 MiB of bench.py's English stand-in through
                    blockwise(lz78(coder=bit)) (bs 256 KiB),
                    blockwise(lz78(coder=bit),bs=8192) and
                    blockwise(lzw(coder=bit),bs=8192) on the card; each
                    container must equal the host path's and both decoders
                    must return the input; E and F must have been launched;
  8. lz78 timing    the device parse of phase 7's blocks against the host
                    parse of the same blocks, the stages of each lz78/lzw
                    encode and decode, the end-to-end rates, and the lz78
                    and lzw encodes at blocks of 1, 2, 4 and 8 MiB, and of
                    inputs of 1-128 blocks of 8 KiB to 8 MiB, with the
                    device parse and with the host parse (the numbers that
                    set the gate, device.use_parse_device), the containers
                    equal;
  9. probes         every kernel of csrc/probes.cu against its plain version
                    on the card at the probe scripts' own shapes, exactly;
                    the gather also on random indices over whole rows and
                    on probes.gather_cases's edge shapes, with the arm each
                    tile took (staged or direct) held to probes.gather_arms,
                    a bad index raising IndexError and the next call right;
                    a launch on a side stream; then `python -m
                    tudocomp_tpu_torch.probes` as a user runs it, every
                    probe kernel launched; their times (wrapper ms by CUDA
                    events, device ms by torch.profiler), bounds (the
                    gather's sector floor beside its bound) and, for the
                    gather and the two rolls, the one PyTorch call for the
                    same function (torch.gather, torch.roll) timed in
                    turns; the pack kernel of probe 7 by level (wrapper,
                    kernel and call device ms) with its wrapper's host
                    parts; the launch path's host cost;
 10. suffix stack   16 MiB of the English stand-in and 16 MiB of a seeded
                    4-letter DNA-like text: the suffix array and its inverse
                    built on the card equal the C++ SA-IS and its inverse;
                    the LCP array of kernel H equals the host's and its plain
                    version's, also on four 256 KiB blocks (kernel H timed
                    at both sizes); the device factorization equals the C++
                    factorizer's; each device stage timed, copies included,
                    against its host counterpart, and again at smaller sizes
                    (the numbers that set device.SA_MIN_N and LZSS_MIN_N) and
                    on two highly repetitive texts;
 11. lzss roundtrip lzss_lcp(coder=huff) on each 16 MiB text, and
                    blockwise(lzss_lcp(coder=huff),bs=262144) with and without
                    shared=1 on the English one, through driver.compress /
                    decompress(device="cuda"): each container equals the host
                    path's, both decoders return the input, kernel H launched
                    (TextDS takes its LCP from it where the card built the
                    SA), its launches counted by the size of their text; the
                    stages of the 16 MiB encode on the card and on the host.
Then the card's name and power limit (nvidia-smi), one line listing the
kernels (each with its launches on its path, its wrapper and device times,
its bound and its plain version's time), and the final line {"ok": true, "device": {...}}. Any
failure raises: the script then exits non-zero and prints no final line.
jax and the JAX package (tudocomp_tpu) are blocked from import for the
whole run.

--turns PARENT compares kernels D, H, E, F and P7 of two checkouts on one
card: it runs this script with --dh in a process of its own for PARENT,
this checkout, this checkout and PARENT, in that order. --dh ROOT builds
ROOT's kernels and times D at both of phase 2's shapes, H on 16 MiB of
English, 16 MiB of DNA and a 256 KiB block, phase 10's lcp_device stage on
the two repetitive texts, F at [6400, 8192] of the English stand-in and in
its blocks of 1 and 4 MiB, E at [6400, 8192] and [200, 262144], and P7 at
each level on the probe's tokens, each checked against the input, the host
or the plain version.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import subprocess
import sys
import threading
import time

sys.modules["jax"] = None  # the port runs without jax
sys.modules["tudocomp_tpu"] = None  # and without the JAX package

ROOT = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
BS = 1 << 18  # the CLI's default block size
BENCH_BLOCKS = 64  # bench.py's encode batch: 64 blocks of 256 KiB
DEC_BS = 1 << 14  # bench.py's decode streams: 16 KiB
ROUNDTRIP_BYTES = 64 * MIB
TEXT_BYTES = 16 * MIB
ALGO = "blockwise(encode(huff))"
SHARED_ALGO = "blockwise(encode(huff),shared=1)"
SHARED_PREFIX = 16 * MIB  # where the JAX package's int32 sort key wraps (counts >= 2^22)
LZ78_BYTES = 50 * MIB  # BASELINE config 2's english.50MB, as bench.py synthesizes it
LZ78_ALGOS = {  # id -> (block size, the kernel of its parse)
    "blockwise(lz78(coder=bit))": (BS, "lz78_parse"),
    "blockwise(lz78(coder=bit),bs=8192)": (8192, "lz78_parse"),
    "blockwise(lzw(coder=bit),bs=8192)": (8192, "lzw_parse"),
}
LZSS_BYTES = 16 * MIB  # BASELINE config 3's and BENCH_r05's lzss shapes
LZSS_ALGO = "lzss_lcp(coder=huff)"
PLAIN_BLOCKS = 32  # blocks of 256 KiB that kernel E's plain version is run on
LZW_BIG_BS = 4 * MIB  # phase 6 runs F on phase 8's blocks of 4 MiB too
LZW_PLAIN_PREFIX = 1 << 16  # bytes of those blocks the plain version steps through
GATE_BS = (1 * MIB, 2 * MIB, 4 * MIB, 8 * MIB)  # phase 8's block sizes for the parse gate
# phase 8's inputs of few blocks, (block size, blocks): where the card's
# parallel blocks stop paying for its longer chain per block
FEW_BLOCKS = ((8192, 1), (8192, 16), (8192, 128), (BS, 1), (BS, 2), (BS, 4), (BS, 8),
              *((bs, n) for bs in GATE_BS for n in (1, 2)))
HUFF_KERNELS = ("pack_blocks", "pack_bytes_blocks", "huffman_tables", "decode_payloads")
SHARED_KERNELS = ("moffat_phase12", "pack_blocks", "pack_bytes_blocks", "decode_payloads")
# the least time the card could take: bytes over the HBM3 rate and
# operations over the rate outside the tensor cores, the larger of the two
# (NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3, 67 TFLOP/s in float32
# outside the tensor cores; the float32 figure stands for the integer work
# of these kernels, whose own peak is lower, so the bound is if anything
# low)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

KERNEL_INFO = {
    "pack_blocks": (
        "tudocomp_tpu_torch/csrc/pack.cu",
        "tudocomp_tpu/ops/bitpack_pallas.py:217",
    ),
    "pack_bytes_blocks": (
        "tudocomp_tpu_torch/csrc/pack.cu",
        "tudocomp_tpu/ops/bitpack_pallas.py:243",
    ),
    "huffman_tables": (
        "tudocomp_tpu_torch/csrc/tables.cu",
        "tudocomp_tpu/ops/pallas_kernels.py:100",
    ),
    "moffat_phase12": (
        "tudocomp_tpu_torch/csrc/tables.cu",
        "tudocomp_tpu/ops/pallas_kernels.py:20",
    ),
    "decode_payloads": (
        "tudocomp_tpu_torch/csrc/decode.cu",
        "tudocomp_tpu/ops/huffman_decode_pallas.py:113",
    ),
    "lz78_parse": (
        "tudocomp_tpu_torch/csrc/lz78.cu",
        "tudocomp_tpu/ops/lz78_pallas.py:45, tudocomp_tpu/ops/lz78_bucket_pallas.py:52",
    ),
    "lzw_parse": (
        "tudocomp_tpu_torch/csrc/lz78.cu",
        "tudocomp_tpu/ops/lz78_pallas.py:126",
    ),
    "plcp_segments": (
        "tudocomp_tpu_torch/csrc/plcp.cu",
        "tudocomp_tpu/ops/plcp_jax.py:29 (plain JAX there, no Pallas kernel: a kernel the port added)",
    ),
    **{
        name: ("tudocomp_tpu_torch/csrc/probes.cu", replaces)
        for name, replaces in {
            "probe3_gather": "etc/probe3.py:120",
            "probe6_roll_lane": "etc/probe6.py:39",
            "probe6_roll_sublane": "etc/probe6.py:47",
            "probe6_extract": "etc/probe6.py:56",
            "probe6_bid": "etc/probe6.py:65",
            "probe6_dot3": "etc/probe6.py:74",
            "probe6_rmw": "etc/probe6.py:92",
            "probe6_shift": "etc/probe6.py:111",
            "probe7_pack": "etc/probe7.py:36",
            "probe8_a": "etc/probe8.py:63",
            "probe8_b": "etc/probe8.py:78",
            "probe8_c": "etc/probe8.py:103",
            "probe8_d": "etc/probe8.py:126",
        }.items()
    },
}
# counter name -> the __global__ functions its launcher runs, as the profiler names them
DEVICE_FNS = {
    "pack_blocks": ("tile_sums_kernel<false>", "scatter_kernel<false>"),
    "pack_bytes_blocks": ("tile_sums_kernel<true>", "scatter_kernel<true>"),
    "huffman_tables": ("huffman_tables_kernel",),
    "moffat_phase12": ("moffat_phase12_kernel",),
    "decode_payloads": ("decode_kernel",),
    "lz78_parse": ("lz78_kernel",),
    "lzw_parse": ("lzw_kernel",),
    "plcp_segments": ("phi_kernel", "plcp_upper_kernel", "plcp_level_kernel"),
    "probe3_gather": ("gather_kernel",),
    "probe6_roll_lane": ("p6_roll_lane_kernel",),
    "probe6_roll_sublane": ("p6_roll_sublane_kernel",),
    "probe6_extract": ("p6_extract_kernel",),
    "probe6_bid": ("p6_bid_kernel",),
    "probe6_dot3": ("p6_dot3_kernel",),
    "probe6_rmw": ("p6_rmw_kernel",),
    "probe6_shift": ("p6_shift_kernel",),
    "probe7_pack": ("p7_pack_kernel",),
    "probe8_a": ("p8_a_kernel",),
    "probe8_b": ("p8_b_kernel",),
    "probe8_c": ("p8_c_kernel",),
    "probe8_d": ("p8_d_kernel",),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def zipf_bytes(seed: int, n: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = np.empty(n, np.uint8)
    step = 16 * MIB
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[lo:hi] = rng.zipf(1.3, hi - lo).clip(0, 255)
    return out


def text_bytes(n: int):
    import numpy as np

    text = b"".join(open(p, "rb").read() for p in sorted(glob.glob(os.path.join(ROOT, "*.md"))))
    if not text:
        raise RuntimeError("no *.md files beside chip_smoke.py")
    return np.frombuffer((text * (n // len(text) + 1))[:n], np.uint8)


def english_bytes(n: int):
    """bench.py's stand-in for Pizza&Chili english: a copy of
    etc/datasets.py:synth_english, seed 7 (uniform words, 10% sentence
    breaks)."""
    import numpy as np

    rng = np.random.default_rng(7)
    words = [w.encode() for w in (
        "the quick brown fox jumps over lazy dog compression suffix array "
        "grammar factorization entropy huffman lempel ziv welch text data "
        "structure algorithm framework parallel device kernel"
    ).split()]
    seps = (b". ", b" ")
    avg = sum(len(w) for w in words) / len(words) + 1.1
    parts, total = [], 0
    while total < n:
        est = max(16, int((n - total) / avg) + 16)
        ids = rng.integers(0, len(words), est)
        dots = rng.random(est) <= 0.1
        chunk = b"".join(words[i] + seps[0 if d else 1] for i, d in zip(ids, dots))
        parts.append(chunk)
        total += len(chunk)
    return np.frombuffer(b"".join(parts)[:n], np.uint8)


GATES = ("TDC_DEVICE_HUFF", "TDC_DEVICE_LZ78", "TDC_DEVICE_SA", "TDC_DEVICE_LZSS")


def dna_bytes(n: int):
    """A seeded 4-letter DNA-like text (uniform A, C, G, T)."""
    import numpy as np

    return np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(7).integers(0, 4, n)]


@contextlib.contextmanager
def host_path():
    """The port's host coders and parses: no device stage runs (an id with
    shared=1 takes the kernels' plain versions on the CPU)."""
    os.environ.update({var: "0" for var in GATES})
    try:
        yield
    finally:
        for var in GATES:
            del os.environ[var]


def ref_compress(algo: str, data: bytes) -> bytes:
    """The reference container: the port's host path."""
    from tudocomp_tpu_torch.driver import compress

    with host_path():
        return compress(algo, data, device="cpu")


def ref_decompress(container: bytes) -> bytes:
    """The reference decode: the port's host decoders."""
    from tudocomp_tpu_torch.driver import decompress

    with host_path():
        return decompress(container, device="cpu")


def no_jax() -> None:
    loaded = [m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in ("jax", "tudocomp_tpu")]
    if loaded:
        raise AssertionError(f"imported: {loaded}")


def nbytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (tuple, list)):
        return sum(nbytes(y) for y in x)
    return 0


def kernel_ops(name: str, args) -> int:
    """Integer operations the kernel does on these inputs, counted per
    element at a few operations each (a lower estimate)."""
    import torch

    if name == "pack_blocks":  # per token: prefix sum, mask, two shifts, two ORs
        return 8 * args[1].numel()
    if name == "pack_bytes_blocks":  # per live byte: lookups, prefix sum, shifts, ORs
        return 10 * int(args[1].to(torch.int64).sum())
    if name == "huffman_tables":  # per table: two 256 x 256 ranks, Moffat, depths
        return args[0].shape[0] * (2 * 256 * 256 + 16 * 254 + 2 * 33 * 256)
    if name == "decode_payloads":  # per stream bit: a shift and a compare per length tried
        return 3 * int(args[1].to(torch.int64).sum())
    if name in ("lz78_parse", "lzw_parse"):  # per byte: hash, probe, compare, insert
        return 10 * int(args[1].to(torch.int64).sum())
    if name == "moffat_phase12":  # per step of the chain: two reads, compares, writes
        return 16 * int((args[1].to(torch.int64) - 2).clamp(min=0).sum())
    if name == "plcp_segments":  # per position: a phi read, ~2 byte compares, a store
        return 8 * args[0].numel()
    if name == "probe3_gather":  # per index: a bounds check and a load
        return 3 * args[1].numel()
    if name == "probe7_pack":  # per token, as kernel A, plus the segmented scan
        return 24 * args[1].numel()
    if name.startswith("probe"):  # per element of the tiles: a handful of operations
        return 8 * max(a.numel() for a in args if isinstance(a, torch.Tensor))
    raise KeyError(name)


def kernel_bytes(name: str, args, out) -> int:
    """Bytes the function must move: each input read once, each output
    written once. The pack kernels count their blocks' valid bytes and the
    32-bit words their bits fill, not the arenas' allocated size (kernel B's
    is sized for 9 bits a byte, kernel A's for 32 bits a token). The parses'
    hash tables are the implementation's scratch, not the function's: see
    table_bytes."""
    import torch

    def filled(bits):  # bytes of the words that `bits` [B] fill
        return 4 * int(((bits.to(torch.int64) + 31) // 32).sum())

    if name == "pack_blocks":
        values, nbits, _ = args
        return nbytes((values, nbits)) + filled(out[1]) + nbytes(out[1])
    if name == "pack_bytes_blocks":
        _, n_valid, tbl_v, tbl_nb, _, hdr_bits, _ = args
        live = int(n_valid.to(torch.int64).sum())
        return live + nbytes((n_valid, tbl_v, tbl_nb, hdr_bits)) + filled(hdr_bits) + filled(out[1]) + nbytes(out[1])
    if name == "probe3_gather":  # idx read, out written, the words of S that idx names read once
        S, idx = args
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None] * S.shape[1]
        return nbytes(idx) + nbytes(out) + 4 * int(torch.unique(idx.to(torch.int64) + rows).numel())
    return nbytes(args) + nbytes(out)


def table_bytes(name: str, args, out) -> dict:
    """The hash-table traffic of kernel E or F beside its bound, which does
    not count it: the fill of ones the wrapper writes (8 B a slot, tables of
    more than 2^BITMAP_LOG2 slots) and the slots the kernel writes, 8 B a
    phrase."""
    import torch

    from tudocomp_tpu_torch.ops import lz78_cuda as lc

    B, bs = args[0].shape
    log2 = (lc.table_log2 if name == "lz78_parse" else lc.lzw_table_log2)(bs)
    return {"table_fill_bytes": 8 * B << log2 if log2 > lc.BITMAP_LOG2 else 0,
            "table_slot_bytes": 8 * int(out[-1].to(torch.int64).sum())}


def bound(name: str, args, out) -> dict:
    """bound_ms: the larger of bytes (kernel_bytes) over PEAK_BYTES_PER_S
    and operations over PEAK_OPS_PER_S."""
    t_bytes = kernel_bytes(name, args, out) / PEAK_BYTES_PER_S * 1e3
    t_ops = kernel_ops(name, args) / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def max_abs_err(got, want) -> int:
    import torch

    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def cuda_ms(fn, budget_ms: float = 500.0, max_iters: int = 50) -> float:
    """Mean CUDA-event time of fn() in ms; fn has run before (warm)."""
    import torch

    def timed(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    t = timed(1)
    n = int(min(max_iters, budget_ms / max(t, 1e-3)))
    return timed(n) if n >= 2 else t


def device_time(fn, name, iters: int = 10) -> dict:
    """Device ms a call of fn() spends in the kernels of counter `name`
    (DEVICE_FNS; name None: in every kernel it runs), from torch.profiler's
    key_averages() over `iters` warm calls (None: the profiler saw no
    device time, not measured), and the kernel events it counted. A long
    run of profiler sessions in one process can drop events: with fewer
    events than calls the ms is the mean of the events seen, a call's time
    for a launcher of one kernel a call; for one of several (A, B, H) a
    short count leaves the ms low. For a launcher of several kernels,
    device_ms_by_kernel splits the ms by __global__ function (all of its
    launches in a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fns = DEVICE_FNS[name] if name else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total, events, by_fn = 0.0, 0, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        hit = [f for f in fns or () if f"::{f}(" in e.key or e.key.startswith(f"{f}(")]
        if fns is None or hit:
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            total += t
            events += e.count
            for f in hit:
                by_fn[f] = by_fn.get(f, 0.0) + t
    if total <= 0:
        return {"device_ms": None, "device_events": events}
    calls = min(events, iters)
    out = {"device_ms": total / calls / 1e3, "device_events": events}
    if fns and len(fns) > 1:
        out["device_ms_by_kernel"] = {f: by_fn.get(f, 0.0) / calls / 1e3 for f in fns}
    return out


def in_turns(kernel, library, **kw) -> dict:
    """CUDA-event ms of kernel() and library() timed in turns (kernel,
    library, library, kernel), and the library's device ms after."""
    k1 = cuda_ms(kernel, **kw)
    l1 = cuda_ms(library, **kw)
    l2 = cuda_ms(library, **kw)
    k2 = cuda_ms(kernel, **kw)
    lib = device_time(library, None)
    return {"ms_turns": [k1, k2], "library_ms_turns": [l1, l2], "ms": (k1 + k2) / 2,
            "library_ms": (l1 + l2) / 2, "library_device_ms": lib["device_ms"],
            "library_device_events": lib["device_events"]}


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds a call of fn() takes to return (launches queued,
    not waited for), over n calls after one warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def cuda_once(fn):
    """fn()'s result and the CUDA-event ms of that one run."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def synced(fn):
    """fn()'s result and its host seconds, the card synchronized after it."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rows_bytes(out, counts) -> bytes:
    """The bytes of kernel D's arena: row i's first counts[i], joined."""
    out = out.cpu().numpy()
    return b"".join(out[i, :c].tobytes() for i, c in enumerate(counts.tolist()))


def decode_inputs(raw: bytes, bs: int, dev):
    """Kernel D's arguments for the streams of blockwise(encode(huff),bs=bs)
    on `raw`: the container's payloads, their tables parsed on the host."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch.ops import huffman_decode_cuda as hd
    from tudocomp_tpu_torch.parallel.blocks import unframe_streams
    from tudocomp_tpu_torch.parallel.runtime import blockwise_huffman_compress

    _, payloads = unframe_streams(blockwise_huffman_compress(raw, bs, dev))
    parsed = [hd.parse_payload_tables(p) for p in payloads]
    W = max(len(p[3]) for p in parsed)
    words = np.zeros((len(parsed), W), np.uint32)
    for i, p in enumerate(parsed):
        words[i, : len(p[3])] = p[3]
    return (
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.tensor([p[4] for p in parsed], dtype=torch.int32, device=dev),
        torch.from_numpy(np.stack([p[0] for p in parsed])).to(dev),
        torch.from_numpy(np.stack([p[1] for p in parsed])).to(dev),
        torch.from_numpy(np.stack([p[2] for p in parsed])).to(dev),
        bs,
    )


def decode_timing(hd, args) -> dict:
    """Kernel D's wrapper ms (CUDA events), device ms (torch.profiler) and bound on args."""
    def fn():
        return hd.decode_payloads(*args)

    return {"ms": cuda_ms(fn), **device_time(fn, "decode_payloads"), **bound("decode_payloads", args, fn())}


def plcp_timing(plcp_torch, t, sa_d) -> dict:
    """Kernel H's wrapper ms (CUDA events), its kernels' device ms and that of
    every kernel the call runs (torch.profiler), and its bound."""
    def fn():
        return plcp_torch.plcp_device(t, sa_d)

    return {"ms": cuda_ms(fn, max_iters=200), **device_time(fn, "plcp_segments"),
            "call_device_ms": device_time(fn, None)["device_ms"], **bound("plcp_segments", (t, sa_d), fn())}


def host_sa(text):
    """The C++ SA-IS of a sentinel-terminated text."""
    import numpy as np

    from tudocomp_tpu_torch import native

    sa = np.empty(len(text), np.int32)
    if native.get_lib().tdc_sais(text, len(text), sa) != 0:
        raise RuntimeError("tdc_sais failed")
    return sa


def host_plcp(text, sa):
    """The C++ PLCP (tdc_plcp_from_phi) of a text and its SA."""
    import numpy as np

    from tudocomp_tpu_torch import native
    from tudocomp_tpu_torch.ds import suffix_array as sa_mod

    plcp = np.empty(len(text), np.int32)
    native.get_lib().tdc_plcp_from_phi(text, len(text), sa_mod.phi_from_sa(sa), plcp)
    return plcp


def dh_phase(dev, gpu, package: str) -> dict:
    """Kernels D, H, F and P7 alone, from the package first on sys.path: D
    on the 1024 x 16 KiB zipf(1.3) streams of phase 2 and the 256 x 256 KiB
    streams of phase 3's input, each held to its input; H on the 16 MiB
    English and DNA texts and a 256 KiB English block, each held to the
    host's PLCP; the lcp_device stage of phase 10's two repetitive 16 MiB
    texts (host seconds, best of 3, the LCP held to the host's); F at
    [6400, 8192] and in blocks of 1 and 4 MiB, E at [6400, 8192] and
    [200, 262144] (parse_timing), and P7 at each level (p7_timing)."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch import probes
    from tudocomp_tpu_torch.ds import suffix_array as sa_mod
    from tudocomp_tpu_torch.ds.suffix_array import suffix_array_device
    from tudocomp_tpu_torch.ops import huffman_decode_cuda as hd
    from tudocomp_tpu_torch.ops import plcp_torch

    dec = {}
    data = np.concatenate([zipf_bytes(2, ROUNDTRIP_BYTES - TEXT_BYTES), text_bytes(TEXT_BYTES)]).tobytes()
    for shape, raw, bs in (("1024 x 16 KiB", zipf_bytes(0, 16 * MIB).tobytes(), DEC_BS),
                           ("256 x 256 KiB", data, BS)):
        args = decode_inputs(raw, bs, dev)
        if rows_bytes(*hd.decode_payloads(*args)) != raw:
            raise AssertionError(f"kernel D did not return the input of the {shape} streams")
        dec[shape] = decode_timing(hd, args)
        del args
    del data
    english = english_bytes(LZSS_BYTES)
    sentinel = np.zeros(1, np.uint8)
    h = {}
    for name, raw in (("16 MiB english", english), ("16 MiB dna", dna_bytes(LZSS_BYTES)),
                      ("256 KiB english block", english[:BS])):
        text = np.concatenate([raw, sentinel])
        t = torch.from_numpy(text).to(dev)
        sa_d = suffix_array_device(t)
        if not np.array_equal(plcp_torch.plcp_device(t, sa_d).cpu().numpy(), host_plcp(text, sa_d.cpu().numpy())):
            raise AssertionError(f"{name}: kernel H differs from the host's PLCP")
        h[name] = plcp_timing(plcp_torch, t, sa_d)
        del t, sa_d
    stage = {}
    for name, raw in (("a^n", np.full(LZSS_BYTES, 97, np.uint8)),
                      ("period 1000", np.tile(english[:1000], LZSS_BYTES // 1000))):
        text = np.concatenate([raw, sentinel])
        sa = host_sa(text)
        lcp = sa_mod.lcp_from_plcp(host_plcp(text, sa), sa)
        t, sa_d = torch.from_numpy(text).to(dev), torch.from_numpy(sa).to(dev)
        best = None
        for _ in range(3):
            got, sec = synced(lambda: plcp_torch.lcp_device(t, sa_d))
            best = sec if best is None else min(best, sec)
        if not np.array_equal(got.cpu().numpy(), lcp):
            raise AssertionError(f"{name}: lcp_device differs from the host's LCP")
        stage[name] = best
        del t, sa_d, got
    del english
    torch.cuda.empty_cache()
    f = parse_timing(dev, "lzw_parse", (8192, MIB, LZW_BIG_BS))
    e = parse_timing(dev, "lz78_parse", (8192, BS))
    p7 = p7_timing(probes, *probes.probe7_inputs(dev))
    torch.cuda.empty_cache()
    no_jax()
    return {"phase": "kernels D, H, E, F and P7", "package": package, "decode": dec, "plcp": h,
            "lcp_device_stage_best_of_3_s": stage, "lzw_parse": f, "lz78_parse": e, "probe7_pack": p7,
            "card": gpu}


def parse_timing(dev, kname: str, sizes) -> dict:
    """Kernel E (kname lz78_parse) or F (lzw_parse) on the 50 MiB English
    stand-in in blocks of each of `sizes`, held to the host parse on every
    block: wrapper ms (CUDA events), device ms (torch.profiler), the
    longest block's factors or codes and the µs a factor, by shape."""
    import torch

    from tudocomp_tpu_torch.parallel.blocks import split_blocks

    kernel, _, host = _parse_fns(kname)
    text = english_bytes(LZ78_BYTES).tobytes()
    out = {}
    for bs in sizes:
        blocks, n_valid = split_blocks(text, bs)
        b, nv = torch.from_numpy(blocks).to(dev), torch.from_numpy(n_valid).to(dev)
        got = kernel(b, nv)
        if not all(_same(g, host(blocks[i, : n_valid[i]])) for i, g in enumerate(_per_block(kname, got))):
            raise AssertionError(f"{kname} differs from the host parse at {list(blocks.shape)}")
        ms = cuda_ms(lambda: kernel(b, nv))
        longest = int(got[-1].max())
        out[f"[{len(blocks)}, {bs}]"] = {
            "ms": ms, **device_time(lambda: kernel(b, nv), kname, iters=3 if bs <= BS else 1),
            "longest_block_factors": longest, "us_per_factor": ms * 1e3 / longest}
        del b, nv, got
        torch.cuda.empty_cache()
    return out


def dh_main(root: str) -> int:
    """--dh ROOT: dh_phase with the package of the checkout at ROOT."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    for var in (*GATES, "TDC_BLOCKWISE_PROCS"):
        os.environ.pop(var, None)
    from tudocomp_tpu_torch import kernels, native

    if not kernels.__file__.startswith(root + os.sep):
        raise RuntimeError(f"the package came from {kernels.__file__}, not from {root}")
    kernels.build()
    if native.get_lib() is None:
        raise RuntimeError("the C++ host helpers did not build (g++)")
    emit(dh_phase(torch.device("cuda", 0), card(), root))
    return 0


def turns_main(parent: str) -> int:
    """--turns PARENT: dh_phase of the checkout at PARENT and of this one in
    turns (parent, this, this, parent), each in a process of its own."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    gpu = card()
    for label, root in (("parent", parent), ("this", ROOT), ("this", ROOT), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--dh", root], capture_output=True, text=True)
        if r.returncode != 0:
            sys.stderr.write(r.stdout[-4000:] + r.stderr[-8000:])
            raise RuntimeError(f"--dh {root} exited {r.returncode}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        line["turn"] = label
        emit(line)
    print(gpu)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tudocomp_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    for var in (*GATES, "TDC_BLOCKWISE_PROCS"):
        os.environ.pop(var, None)

    import numpy as np

    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.ops import bitpack_cuda as bc
    from tudocomp_tpu_torch.ops import huffman_decode_cuda as hd
    from tudocomp_tpu_torch.ops import huffman_torch as ht
    from tudocomp_tpu_torch.ops import table_kernels as tk

    gpu = card()
    dev = torch.device("cuda", 0)

    # 1. build ---------------------------------------------------------------
    from tudocomp_tpu_torch import native

    t0 = time.perf_counter()
    host = threading.Thread(target=native.get_lib)  # g++ beside the nvcc builds
    host.start()
    so = kernels.build()
    t1 = time.perf_counter()
    host.join()
    host_lib = native.get_lib()
    if host_lib is None:
        raise RuntimeError("the C++ host helpers did not build (g++)")
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels_seconds": t1 - t0,
          "library": os.path.relpath(so, ROOT), "host_library": os.path.relpath(host_lib._name, ROOT),
          "card": gpu})

    # 2. kernels against their plain versions, main-path shapes ---------------
    n_words = (9 * BS + 4096 + 31) // 32
    batch = zipf_bytes(0, BENCH_BLOCKS * BS).reshape(BENCH_BLOCKS, BS)
    blocks = torch.from_numpy(batch).to(dev)
    n_valid = torch.full((BENCH_BLOCKS,), BS, dtype=torch.int32, device=dev)
    hists = ht.block_histograms(blocks, n_valid)
    edge = np.zeros((5, 256), np.int32)
    edge[1, 65] = 7  # one symbol
    edge[2, [3, 200]] = [5, 9]  # two symbols
    edge[3] = np.arange(1, 257)  # all 256
    fib = [1, 1]
    while len(fib) < 31:
        fib.append(fib[-1] + fib[-2])
    edge[4, :31] = fib  # codes of 30 bits
    hists_all = torch.cat([hists, torch.from_numpy(edge).to(dev)])

    errs, cases = {}, {}
    tabs = tk.huffman_tables(hists_all)
    want = tk.huffman_tables_plain(hists_all)
    errs["huffman_tables"] = max_abs_err(tuple(tabs), tuple(want))
    if int(tabs.longest.max()) < 28:
        raise AssertionError("the edge histograms gave no code of 28 bits or more")
    cases["huffman_tables"] = ((hists_all,), tk.huffman_tables, tk.huffman_tables_plain)

    t = tk.HuffmanTables(*(x[:BENCH_BLOCKS] for x in tabs))
    tv, tb = ht.huffman_table_tokens(t.numl, t.ordered_sym, t.sigma, t.longest)
    rng = np.random.default_rng(1)
    rand_nb = torch.from_numpy(rng.integers(0, 33, (64, 65536)).astype(np.int32)).to(dev)
    rand_v = torch.from_numpy(rng.integers(0, 1 << 32, (64, 65536)).astype(np.uint32).view(np.int32)).to(dev)
    a_err = 0
    for args in ((tv, tb, ht.N_TABLE_TOKENS), (rand_v, rand_nb, 20000)):  # the second drops bits
        a_err = max(a_err, max_abs_err(bc.pack_blocks(*args), bc.pack_blocks_plain(*args)))
    errs["pack_blocks"] = a_err
    cases["pack_blocks"] = ((tv, tb, ht.N_TABLE_TOKENS), bc.pack_blocks, bc.pack_blocks_plain)

    normal = (t.sigma >= 2)[:, None]
    tbl_v = torch.where(normal, t.cw, torch.arange(256, dtype=torch.int32, device=dev))
    tbl_nb = torch.where(normal, t.lengths, 8)
    hdr_w, hdr_b = bc.pack_blocks_plain(tv, tb, ht.N_TABLE_TOKENS)
    b_args = (blocks, n_valid, tbl_v, tbl_nb, hdr_w, hdr_b, n_words)
    errs["pack_bytes_blocks"] = max_abs_err(bc.pack_bytes_blocks(*b_args), bc.pack_bytes_blocks_plain(*b_args))
    cases["pack_bytes_blocks"] = (b_args, bc.pack_bytes_blocks, bc.pack_bytes_blocks_plain)

    dec_raw = batch.reshape(-1)[: 16 * MIB].tobytes()
    d_args = decode_inputs(dec_raw, DEC_BS, dev)
    got = hd.decode_payloads(*d_args)
    errs["decode_payloads"] = max_abs_err(got, hd.decode_payloads_plain(*d_args))
    cases["decode_payloads"] = (d_args, hd.decode_payloads, hd.decode_payloads_plain)
    # and the main path's streams: the roundtrip's input in blocks of 256 KiB
    # (held to the input, not to the plain version, whose lockstep walk takes
    # a step a code: ~262k steps)
    data = np.concatenate([zipf_bytes(2, ROUNDTRIP_BYTES - TEXT_BYTES), text_bytes(TEXT_BYTES)]).tobytes()
    d_shapes = {"1024 x 16 KiB": (d_args, dec_raw), "256 x 256 KiB": (decode_inputs(data, BS, dev), data)}
    d_rounds = {}
    for shape, (args, raw) in d_shapes.items():
        out, counts, rounds = hd.decode_payloads(*args, sync_rounds=True)
        if rows_bytes(out, counts) != raw:
            raise AssertionError(f"kernel D did not return the input of the {shape} streams")
        d_rounds[shape] = int(rounds.max())
    torch.cuda.synchronize()
    if any(errs.values()):
        raise AssertionError(f"kernels differ from their plain versions: {errs}")
    emit({"phase": "kernels", "max_abs_err": errs, "tolerance": 0, "streams": d_args[0].shape[0],
          "decode_max_sync_rounds": d_rounds, "card": gpu})

    # 3. roundtrip through the public entry points ----------------------------
    from tudocomp_tpu_torch.driver import compress, decompress

    kernels.reset_counts()
    t0 = time.perf_counter()
    container = compress(ALGO, data, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = decompress(container, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.counts()
    if back != data:
        raise AssertionError("device roundtrip differs from the input")
    missing = [k for k in HUFF_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    t3 = time.perf_counter()
    ref = ref_compress(ALGO, data)
    t4 = time.perf_counter()
    if container != ref:
        raise AssertionError("container differs from the host path's")
    if ref_decompress(container) != data:
        raise AssertionError("the host decode of the container differs from the input")
    t5 = time.perf_counter()
    no_jax()
    emit({"phase": "roundtrip", "bytes": len(data), "container_bytes": len(container),
          "ratio": len(container) / len(data), "launches": launches,
          "first_encode_s": t1 - t0, "first_decode_s": t2 - t1,
          "host_reference_encode_s": t4 - t3, "host_reference_decode_s": t5 - t4,
          "card": gpu})

    # 4. timing ---------------------------------------------------------------
    timing = {}
    for name, (args, kernel, plain) in cases.items():
        timing[name] = {
            "ms": cuda_ms(lambda: kernel(*args)),
            **device_time(lambda: kernel(*args), name),
            "plain_ms": cuda_ms(lambda: plain(*args), budget_ms=2000.0, max_iters=10),
            **bound(name, args, kernel(*args)),
        }
    timing["decode_payloads"]["max_sync_rounds"] = max(d_rounds.values())
    timing["decode_payloads"]["by_shape"] = {
        shape: {**decode_timing(hd, args), "max_sync_rounds": d_rounds[shape]}
        for shape, (args, _) in d_shapes.items()
    }
    del d_shapes
    t0 = time.perf_counter()
    container = compress(ALGO, data, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    back = decompress(container, device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if back != data:
        raise AssertionError("second device roundtrip differs from the input")
    emit({"phase": "timing", "kernels": timing,
          "encode_s": t1 - t0, "encode_GBps": len(data) / (t1 - t0) / 1e9,
          "decode_s": t2 - t1, "decode_GBps": len(data) / (t2 - t1) / 1e9,
          "card": gpu})

    del back, container, ref

    # 5. the shared table -----------------------------------------------------
    err_g, timing_g, launches_g = shared_phase(data, hists_all, dev, gpu)
    errs["moffat_phase12"] = err_g
    timing["moffat_phase12"] = timing_g
    launches["moffat_phase12"] = launches_g
    del data
    torch.cuda.empty_cache()

    # 6-8. the LZ78/LZW block parse -------------------------------------------
    text = english_bytes(LZ78_BYTES)
    errs_e, timing_e = lz78_kernel_phase(text, dev, gpu)
    errs.update(errs_e)
    launches.update(lz78_roundtrip_phase(text.tobytes(), gpu))
    lz78_timing_phase(text, dev, gpu)
    timing.update(timing_e)
    torch.cuda.empty_cache()

    # 9-11. the probe kernels and the lzss_lcp suffix stack ---------------------
    for part in (probes_phase(dev, gpu), suffix_phase(text[:LZSS_BYTES], dev, gpu)):
        for table, new in zip((errs, timing, launches), part):
            table.update(new)
    launches_h = lzss_roundtrip_phase(text[:LZSS_BYTES], dev, gpu)
    launches["plcp_segments"] = sum(launches_h.values())
    timing["plcp_segments"]["launches_by_shape"] = launches_h

    print(gpu)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name], "library_ms": None, **timing[name]}
        for name, (src, rep) in KERNEL_INFO.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def block0_kraft(container: bytes) -> bool:
    """Kraft's equality over the code lengths in block 0's table header."""
    from tudocomp_tpu_torch.coders.huffman import read_table
    from tudocomp_tpu_torch.io.bitio import BitReader
    from tudocomp_tpu_torch.parallel.blocks import unframe_streams

    r = BitReader(unframe_streams(container[container.index(b"%") + 1 :])[1][0])
    if not r.read_bit():
        raise AssertionError("block 0 has no table")
    t = read_table(r)
    return sum(int(n) << (t.longest - l) for l, n in enumerate(t.numl, 1)) == 1 << t.longest


def encode_stages(data: bytes, dev, shared: bool) -> dict:
    """Host seconds of each stage of the runtime's encode, per-block or
    shared, the card synchronized after each (the input copied whole, as
    the shared path's pass 1 keeps it)."""
    import torch

    from tudocomp_tpu_torch.ops import huffman_torch as ht
    from tudocomp_tpu_torch.ops.bitpack import finalize_stream
    from tudocomp_tpu_torch.parallel.blocks import frame_streams, split_blocks

    n_words = (9 * BS + 4096 + 31) // 32
    st = {}
    (blocks, n_valid), st["split_blocks"] = synced(lambda: split_blocks(data, BS))
    batches, st["copy to the card"] = synced(lambda: [
        (torch.from_numpy(blocks[lo : lo + BENCH_BLOCKS]).to(dev),
         torch.from_numpy(n_valid[lo : lo + BENCH_BLOCKS]).to(dev))
        for lo in range(0, len(blocks), BENCH_BLOCKS)])
    if shared:
        total, st["histograms, summed"] = synced(
            lambda: sum(ht.block_histograms(b, nv).sum(0, dtype=torch.int64) for b, nv in batches))
        tables, st["one table (sort, kernel G, phase 3, codes)"] = synced(lambda: ht.shared_tables(total))
        out, st["encode (kernels A, B)"] = synced(
            lambda: [ht.encode_blocks(b, nv, n_words, shared_table=tables) for b, nv in batches])
    else:
        out, st["encode (histogram, kernels C, A, B)"] = synced(
            lambda: [ht.encode_blocks(b, nv, n_words) for b, nv in batches])

    def back():
        res = []
        for words, bits in out:
            bits = bits.cpu().numpy()
            res.append((words[:, : (int(bits.max()) + 31) // 32].cpu().numpy(), bits))
        return res

    host, st["arenas back"] = synced(back)
    payloads, st["finalize_stream"] = synced(
        lambda: [finalize_stream(w[i], int(b[i])) for w, b in host for i in range(len(b))])
    _, st["frame_streams"] = synced(lambda: frame_streams(payloads, BS))
    st["total"] = sum(st.values())
    return st


def shared_phase(data: bytes, hists69, dev, gpu):
    """Phase 5: kernel G against its plain version on three inputs, the
    256 MiB shared-table roundtrip on the card and through the host
    decoder, the 16 MiB prefix against the port's CPU run, G's times, and
    the warm end-to-end rates with and without shared. Returns (G's
    max_abs_err, its line entries, its launches in the roundtrip)."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.driver import compress, decompress
    from tudocomp_tpu_torch.ops import huffman_torch as ht
    from tudocomp_tpu_torch.ops import table_kernels as tk
    from tudocomp_tpu_torch.parallel.blocks import split_blocks

    # the summed histogram of the whole input, as the runtime's pass 1 takes it
    blocks, n_valid = split_blocks(data, BS)
    (b, nv), h2d_s = synced(lambda: (torch.from_numpy(blocks).to(dev), torch.from_numpy(n_valid).to(dev)))
    total = sum(ht.block_histograms(b[lo : lo + BENCH_BLOCKS], nv[lo : lo + BENCH_BLOCKS]).sum(0, dtype=torch.int64)
                for lo in range(0, len(b), BENCH_BLOCKS))
    del b, nv
    cases = {
        "summed [1, 256]": total[None],
        "phase 2's [69, 256]": hists69,
        "past 2^31 [1, 256]": total[None] * 1024,
    }
    report, err = {}, 0
    for name, hists in cases.items():
        args = ht._sort_hist(hists)[:2]
        got = tk.moffat_phase12(*args)
        e = max_abs_err(got, tk.moffat_phase12_plain(*args))
        err = max(err, e)
        report[name] = {"max_abs_err": e, "max_weight": int(args[0].max()), "sigma": int(args[1].max())}
    if int(cases["past 2^31 [1, 256]"].max()) < 1 << 31:
        raise AssertionError("the third row has no weight past 2^31")
    if err:
        raise AssertionError(f"kernel G differs from its plain version: {report}")
    args = ht._sort_hist(cases["summed [1, 256]"])[:2]
    line = {"ms": cuda_ms(lambda: tk.moffat_phase12(*args)),
            **device_time(lambda: tk.moffat_phase12(*args), "moffat_phase12"),
            "plain_ms": cuda_ms(lambda: tk.moffat_phase12_plain(*args), budget_ms=2000.0, max_iters=10),
            **bound("moffat_phase12", args, tk.moffat_phase12(*args))}

    # the roundtrip through the public entry points
    kernels.reset_counts()
    container, enc_s = synced(lambda: compress(SHARED_ALGO, data, device="cuda"))
    back, dec_s = synced(lambda: decompress(container, device="cuda"))
    launches = kernels.counts()
    if back != data:
        raise AssertionError("shared: device roundtrip differs from the input")
    missing = [k for k in SHARED_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"shared: kernels never launched on the path: {missing}")
    if not block0_kraft(container):
        raise AssertionError("shared: block 0's code lengths break Kraft's equality")
    host_back, host_dec_s = synced(lambda: ref_decompress(container))
    if host_back != data:
        raise AssertionError("shared: the host decode differs from the input")
    del back, host_back
    prefix = data[:SHARED_PREFIX]
    if int(np.bincount(np.frombuffer(prefix, np.uint8), minlength=256).max()) < 1 << 22:
        raise AssertionError("the prefix has no count of 2^22 or more")
    on_card = compress(SHARED_ALGO, prefix, device="cuda")
    on_cpu, cpu_s = synced(lambda: compress(SHARED_ALGO, prefix, device="cpu"))
    if on_card != on_cpu:
        raise AssertionError("shared: the 16 MiB prefix's container differs from the CPU run's")
    no_jax()

    # warm rates, in turns: per-block, shared, shared, per-block
    rates = {}
    for algo in (ALGO, SHARED_ALGO, SHARED_ALGO, ALGO):
        c, e = synced(lambda: compress(algo, data, device="cuda"))
        d, dd = synced(lambda: decompress(c, device="cuda"))
        if d != data:
            raise AssertionError(f"{algo}: warm roundtrip differs from the input")
        r = rates.setdefault(algo, {"encode_GBps": [], "decode_GBps": [], "ratio": len(c) / len(data)})
        r["encode_GBps"].append(len(data) / e / 1e9)
        r["decode_GBps"].append(len(data) / dd / 1e9)
        del c, d
    stages = {"per-block": encode_stages(data, dev, False), "shared": encode_stages(data, dev, True)}
    emit({"phase": "shared", "moffat_phase12": report, "moffat_phase12_line": line, "encode_stages": stages,
          "launches": launches, "bytes": len(data), "container_bytes": len(container),
          "ratio": len(container) / len(data), "first_encode_s": enc_s, "first_decode_s": dec_s,
          "host_decode_s": host_dec_s, "input_to_card_s": h2d_s,
          "prefix_bytes": len(prefix), "prefix_cpu_encode_s": cpu_s, "warm": rates, "card": gpu})
    return err, line, launches["moffat_phase12"]


def _parse_fns(kernel: str):
    from tudocomp_tpu_torch.compressors.lz78 import lz78_parse
    from tudocomp_tpu_torch.compressors.lzw import lzw_parse
    from tudocomp_tpu_torch.ops import lz78_cuda as lc

    if kernel == "lz78_parse":
        return lc.lz78_parse_blocks, lc.lz78_parse_blocks_plain, lz78_parse
    return lc.lzw_parse_blocks, lc.lzw_parse_blocks_plain, lzw_parse


def _per_block(kernel: str, out) -> list:
    """The kernel's (or plain version's) tensors as per-block host arrays."""
    rows = [t.cpu().numpy() for t in out]
    nf = rows[-1]
    if kernel == "lz78_parse":
        return [(rows[0][i, :k].astype("uint32"), rows[1][i, :k]) for i, k in enumerate(nf)]
    return [rows[0][i, :k].astype("uint32") for i, k in enumerate(nf)]


def _same(a, b) -> bool:
    import numpy as np

    if isinstance(a, tuple):
        return all(np.array_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def lz78_kernel_phase(text, dev, gpu):
    """Phase 6: E and F against their plain versions and the host parses, at
    the main path's shapes (the whole input, split as phase 7 splits it) and
    at odd ones; E's numbers at both main shapes. The kernels line takes
    the times at [6400, 8192], E's also by shape."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch.ops import lz78_cuda as lc
    from tudocomp_tpu_torch.parallel.blocks import split_blocks

    def batch(lo: int, B: int, bs: int):
        return text[lo : lo + B * bs].reshape(B, bs).copy(), np.full(B, bs, np.int32)

    odd, odd_nv = batch(5 * MIB, 131, 8192)  # B not a multiple of 128
    odd[0] = ord("e")  # one byte throughout: ends inside a phrase
    odd_nv[1], odd_nv[2], odd_nv[3] = 0, 5000, 1  # empty, ragged, one byte
    one = np.full((4, BS), ord("e"), np.uint8)  # phrases of 1 .. 724 bytes
    one_nv = np.array([BS, BS - 1, BS - 418, 1], np.int32)  # BS - 418: ends on a factor
    rand = np.random.default_rng(11).integers(0, 256, (4, BS)).astype(np.uint8)
    rand_nv = np.array([BS, BS - 1, BS - 2, BS - 3], np.int32)
    # F at phase 8's 4 MiB blocks: all blocks against the host parse; the plain
    # version (a step a byte, ~0.2 ms a step on the card) on the first two
    # blocks' first LZW_PLAIN_PREFIX bytes, the kernel run again on those
    big, big_nv = split_blocks(text.tobytes(), LZW_BIG_BS)
    cases = {
        "lz78 [128, 8192]": ("lz78_parse", *batch(0, 128, 8192)),
        "lz78 odd [131, 8192]": ("lz78_parse", odd, odd_nv),
        "lzw [128, 8192]": ("lzw_parse", *batch(0, 128, 8192)),
        "lzw odd [131, 8192]": ("lzw_parse", odd, odd_nv),
        "lz78 one letter [4, 262144]": ("lz78_parse", one, one_nv),
        "lz78 random [4, 262144]": ("lz78_parse", rand, rand_nv),
        f"lzw [{len(big)}, {LZW_BIG_BS}]": ("lzw_parse", big, big_nv),
    }
    line_case = {}
    for bs, kname in LZ78_ALGOS.values():
        blocks, n_valid = split_blocks(text.tobytes(), bs)
        name = f"{kname.split('_')[0]} [{len(blocks)}, {bs}]"
        cases[name] = (kname, blocks, n_valid)
        if bs == 8192:
            line_case[kname] = name
    errs = {"lz78_parse": 0, "lzw_parse": 0}
    report, timing, e_shapes = {}, {}, {}
    for name, (kname, blocks, n_valid) in cases.items():
        kernel, plain, host = _parse_fns(kname)
        b, nv = torch.from_numpy(blocks).to(dev), torch.from_numpy(n_valid).to(dev)
        got = kernel(b, nv)
        torch.cuda.empty_cache()  # the plain child table of 200 blocks of 256 KiB takes ~52 GiB
        k = min(PLAIN_BLOCKS, len(blocks)) if blocks.shape[1] == BS else len(blocks)
        if blocks.shape[1] == LZW_BIG_BS:  # the plain version on a prefix of the first two blocks
            k, pre = 2, nv[:2].clamp(max=LZW_PLAIN_PREFIX)
            want, plain_ms = cuda_once(lambda: plain(b[:2], pre))
            err = max_abs_err(kernel(b[:2], pre), want)
        else:
            want, plain_ms = cuda_once(lambda: plain(b[:k], nv[:k]))
            err = max_abs_err(tuple(g[:k] for g in got), want)
        per_block = _per_block(kname, got)
        host_ok = all(_same(g, host(blocks[i, : n_valid[i]])) for i, g in enumerate(per_block))
        if err or not host_ok:
            raise AssertionError(f"{name}: max_abs_err {err} against the plain version, host parse equal: {host_ok}")
        ms = cuda_ms(lambda: kernel(b, nv))
        mid = None
        if kname == "lz78_parse":  # a trailing factor repeats an earlier one; others never do
            mid = sum(len(p) > 1 and bool(((p[:-1] == p[-1]) & (c[:-1] == c[-1])).any()) for p, c in per_block)
            if mid == 0:
                raise AssertionError(f"{name}: no block ends inside a phrase")
        report[name] = {"ms": ms, "plain_ms": plain_ms, "plain_blocks": k, "factors": int(got[-1].sum()),
                        "longest_block_factors": int(got[-1].max()), "us_per_factor": ms * 1e3 / int(got[-1].max()),
                        "blocks_ending_mid_phrase": mid}
        errs[kname] = max(errs[kname], err)
        line = name == line_case[kname]
        e_main = kname == "lz78_parse" and (line or name == f"lz78 [{len(blocks)}, {BS}]")
        big_f = blocks.shape[1] == LZW_BIG_BS
        dt = device_time(lambda: kernel(b, nv), kname, iters=3) if line or e_main or big_f else {}
        if big_f:
            report[name].update({**dt, **bound(kname, (b, nv), got), **table_bytes(kname, (b, nv), got)})
        if e_main:
            longest = int(got[-1].max())  # the factors of the longest chain of rounds
            e_shapes[f"[{len(blocks)}, {blocks.shape[1]}]"] = {
                "ms": ms, **dt, "plain_ms": plain_ms, "plain_blocks": k,
                "longest_block_factors": longest, "ms_per_factor": ms / longest}
        if line:
            timing[kname] = {"ms": ms, **dt, "plain_ms": plain_ms, **bound(kname, (b, nv), got),
                             **table_bytes(kname, (b, nv), got)}
        del b, nv, got, want
    timing["lz78_parse"]["by_shape"] = e_shapes
    # registers a thread and CTAs an SM: how many of the 8 KiB main shape's
    # warps (four a CTA) the card holds at once
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occupancy = {}
    for kname in ("lz78_parse", "lzw_parse"):
        occ = lc.parse_occupancy(kname == "lzw_parse", 8192)
        B8 = len(cases[line_case["lzw_parse"]][1])
        occ["waves_at_8KiB"] = -(-B8 // (occ["blocks_per_cta"] * occ["ctas_per_sm"] * sms))
        occupancy[kname] = occ
        timing[kname]["occupancy"] = occ
    timing["lzw_parse"]["longest_block_factors"] = report[line_case["lzw_parse"]]["longest_block_factors"]
    timing["lzw_parse"]["us_per_factor"] = report[line_case["lzw_parse"]]["us_per_factor"]
    torch.cuda.empty_cache()
    emit({"phase": "lz78 kernels", "max_abs_err": errs, "tolerance": 0, "cases": report,
          "e_by_shape": e_shapes, "occupancy": occupancy, "sms": sms, "card": gpu})
    return errs, timing


def lz78_roundtrip_phase(data: bytes, gpu) -> dict:
    """Phase 7: the three ids on the card against the host path."""
    import torch

    from tudocomp_tpu_torch import kernels, native
    from tudocomp_tpu_torch.driver import compress, decompress

    launches = {"lz78_parse": 0, "lzw_parse": 0}
    for algo, (bs, kname) in LZ78_ALGOS.items():
        kernels.reset_counts()
        container, enc_s = synced(lambda: compress(algo, data, device="cuda"))
        back, dec_s = synced(lambda: decompress(container, device="cuda"))
        n = kernels.counts()[kname]
        if n == 0:
            raise AssertionError(f"{algo}: kernel {kname} never launched")
        launches[kname] += n
        if back != data:
            raise AssertionError(f"{algo}: device roundtrip differs from the input")
        t0 = time.perf_counter()
        ref = ref_compress(algo, data)
        t1 = time.perf_counter()
        if container != ref:
            raise AssertionError(f"{algo}: container differs from the host path's")
        if ref_decompress(container) != data:
            raise AssertionError(f"{algo}: the host decode differs from the input")
        t2 = time.perf_counter()
        no_jax()
        emit({"phase": "lz78 roundtrip", "algo": algo, "bytes": len(data),
              "blocks": -(-len(data) // bs), "container_bytes": len(container),
              "ratio": len(container) / len(data), "launches": {kname: n},
              "first_encode_s": enc_s, "first_decode_s": dec_s,
              "host_reference_encode_s": t1 - t0, "host_reference_decode_s": t2 - t1,
              "host_reference_native": native.get_lib() is not None, "card": gpu})
        del container, back, ref
        torch.cuda.empty_cache()
    return launches


def _stages(data: bytes, algo: str, dev) -> dict:
    """Host seconds of each stage of the device-parse encode and of the
    host decode of `algo` (synchronized after each device stage)."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch.compressors.lz78 import lz78_expand
    from tudocomp_tpu_torch.compressors.lzw import lzw_expand
    from tudocomp_tpu_torch.driver import decompress
    from tudocomp_tpu_torch.parallel.blocks import frame_streams, split_blocks, unframe_streams
    from tudocomp_tpu_torch.registry import TorchRegistry

    bs, kname = LZ78_ALGOS[algo]
    kernel = _parse_fns(kname)[0]
    reg = TorchRegistry(dev)
    inner_id = "lz78(coder=bit)" if kname == "lz78_parse" else "lzw(coder=bit)"
    comp = reg.select(inner_id)
    st = {}
    (blocks, n_valid), st["split_blocks"] = synced(lambda: split_blocks(data, bs))
    (b, nv), st["copy to the card"] = synced(
        lambda: (torch.from_numpy(blocks).to(dev), torch.from_numpy(n_valid).to(dev)))
    out, st["kernel E" if kname == "lz78_parse" else "kernel F"] = synced(lambda: kernel(b, nv))

    def back():
        nf = out[-1].cpu().numpy()
        used = int(nf.max())
        return [t[:, :used].cpu().numpy() for t in out[:-1]], nf

    (rows, nf), st["factors back to the host"] = synced(back)
    if kname == "lz78_parse":
        lists, st["per-block lists"] = synced(
            lambda: [(rows[0][i, :k].astype(np.uint32), rows[1][i, :k]) for i, k in enumerate(nf)])
        payloads, st["per-block _encode_factors"] = synced(
            lambda: [comp._encode_factors(p, c) for p, c in lists])
    else:
        lists, st["per-block lists"] = synced(
            lambda: [rows[0][i, :k].astype(np.uint32) for i, k in enumerate(nf)])
        payloads, st["per-block _encode_codes"] = synced(lambda: [comp._encode_codes(c) for c in lists])
    container, st["frame_streams"] = synced(lambda: frame_streams(payloads, bs))
    st["encode total"] = sum(st.values())
    dec = {}
    (_, streams), dec["unframe_streams"] = synced(lambda: unframe_streams(container))
    parts, dec["per-block decode through the driver"] = synced(
        lambda: [decompress(p, id_string=inner_id, raw=True, registry=reg) for p in streams])
    _, dec["b''.join"] = synced(lambda: b"".join(parts))
    dec["decode total"] = sum(dec.values())
    if kname == "lz78_parse":
        _, dec["lz78_expand alone, one thread"] = synced(lambda: [lz78_expand(p, c) for p, c in lists])
    else:
        _, dec["lzw_expand alone, one thread"] = synced(lambda: [lzw_expand(c) for c in lists])
    if b"".join(parts) != data:
        raise AssertionError(f"{algo}: the staged roundtrip differs from the input")
    return {"encode": st, "decode": dec}


def lz78_timing_phase(text, dev, gpu) -> None:
    """Phase 8: the device parse of the roundtrip's blocks (copies included)
    against the host parse of the same blocks, the stage breakdowns, warm
    end-to-end rates, and the encode with the device parse and with the
    host parse at blocks of 1, 2, 4 and 8 MiB (GATE_BS) and of inputs of
    few blocks (FEW_BLOCKS), with what the gate picks for each: the numbers
    that set device.PARSE_MAX_BS, PARSE_MIN_BLOCKS and PARSE_ONE_BLOCK_BS."""
    from tudocomp_tpu_torch import device as tdev
    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.driver import compress, decompress
    from tudocomp_tpu_torch.ops import lz78_cuda as lc
    from tudocomp_tpu_torch.parallel.blocks import split_blocks

    import torch

    data = text.tobytes()
    shapes, stages, e2e = {}, {}, {}
    for algo, (bs, kname) in LZ78_ALGOS.items():
        host = _parse_fns(kname)[2]
        blocks, n_valid = split_blocks(data, bs)
        helper = lc.lz78_parse_blocks_device if kname == "lz78_parse" else lc.lzw_parse_blocks_device
        t0 = time.perf_counter()
        for i in range(len(blocks)):
            host(blocks[i, : n_valid[i]])
        host_s = time.perf_counter() - t0
        shapes[algo] = {
            "blocks": len(blocks), "block_bytes": bs,
            "device_parse_to_lists_s": synced(lambda: helper(blocks, n_valid, dev))[1],
            "host_parse_s": host_s,
        }
        stages[algo] = _stages(data, algo, dev)
        container, enc_s = synced(lambda: compress(algo, data, device="cuda"))
        back, dec_s = synced(lambda: decompress(container, device="cuda"))
        if back != data:
            raise AssertionError(f"{algo}: warm roundtrip differs from the input")
        e2e[algo] = {"encode_s": enc_s, "encode_MBps": len(data) / enc_s / 1e6,
                     "decode_s": dec_s, "decode_MBps": len(data) / dec_s / 1e6}
        torch.cuda.empty_cache()
    cap, gate, wins, few = tdev.PARSE_MAX_BS, {}, {}, {}

    def both(algo, piece, kind, repeats):
        """Encode seconds with the device and the host parse, the least of
        `repeats` turns each; the containers equal."""
        out, secs = {}, {"1": [], "0": []}
        for mode in ("1", "0") * repeats:  # device parse, host parse
            os.environ["TDC_DEVICE_LZ78"] = mode
            kernels.reset_counts()
            out[mode], sec = synced(lambda: compress(algo, piece, device="cuda"))
            secs[mode].append(sec)
            if (kernels.counts()[f"{kind}_parse"] > 0) != (mode == "1"):
                raise AssertionError(f"{algo}: TDC_DEVICE_LZ78={mode} took the other parse")
        if out["1"] != out["0"]:
            raise AssertionError(f"{algo} on {len(piece)} bytes: the device and host parses give different containers")
        return min(secs["1"]), min(secs["0"])

    tdev.PARSE_MAX_BS = max(cap, *GATE_BS)  # lets TDC_DEVICE_LZ78=1 reach past the gate
    try:
        for kind in ("lz78", "lzw"):
            for bs in GATE_BS:
                algo = f"blockwise({kind}(coder=bit),bs={bs})"
                d, h = both(algo, data, kind, 1)
                gate[f"{algo}, TDC_DEVICE_LZ78=1, encode_s"] = d
                gate[f"{algo}, TDC_DEVICE_LZ78=0, encode_s"] = h
                wins[f"{kind} {bs // MIB} MiB"] = d < h
            for bs, n in FEW_BLOCKS:
                algo = f"blockwise({kind}(coder=bit),bs={bs})"
                d, h = both(algo, data[: n * bs], kind, 3 if n * bs < MIB else 2)
                few[f"{kind} {n} x {bs}"] = {"device_s": d, "host_s": h, "device_faster": d < h}
    finally:
        tdev.PARSE_MAX_BS = cap
        os.environ.pop("TDC_DEVICE_LZ78", None)
    for kind in ("lz78", "lzw"):  # what the gate picks, TDC_DEVICE_LZ78 unset
        for bs, n in FEW_BLOCKS:
            few[f"{kind} {n} x {bs}"]["gate_takes_device"] = tdev.use_parse_device(bs, n, dev)
    emit({"phase": "lz78 timing", "parse": shapes, "stages": stages, "end_to_end": e2e,
          "gate": gate, "device_parse_wins": wins, "few_blocks": few, "parse_max_bs": cap,
          "parse_min_blocks": tdev.PARSE_MIN_BLOCKS, "parse_one_block_bs": tdev.PARSE_ONE_BLOCK_BS, "card": gpu})


def gather_floors(S, idx) -> dict:
    """The gather's bound (bound()) and its sector floor: idx read, out
    written, and every 32-byte sector of S that idx touches read once."""
    import torch

    out = torch.empty_like(idx)
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None] * S.shape[1]
    sectors = torch.unique((idx.to(torch.int64) + rows + S.data_ptr() // 4 % 8) // 8).numel()
    floor = (nbytes(idx) + nbytes(out) + 32 * sectors) / PEAK_BYTES_PER_S * 1e3
    return {**bound("probe3_gather", (S, idx), out), "sector_floor_ms": floor}


def gather_body_ms(S, idx) -> float:
    """CUDA-event ms of the gather kernel alone: back-to-back launches with
    no wait between them (the wrapper waits after each)."""
    from tudocomp_tpu_torch import kernels

    out = idx.new_empty(idx.shape)
    flag = kernels._flag(S.get_device())[1]
    return cuda_ms(lambda: kernels.launch("tdc_probe3_gather", S, idx, out, S.shape[0], S.shape[1],
                                          idx.shape[1], None, flag), max_iters=200)


def p7_timing(probes, vals, nbits) -> dict:
    """Kernel P7 at each level on the probe's tokens: held to its plain
    version (mid included), then, called as the entry point calls it (no
    mid), its wrapper ms (CUDA events), the kernel's device ms and the
    call's (every kernel it runs), from torch.profiler."""
    out = {}
    for lv in (1, 2, 3, 4, 5):
        def fn(lv=lv):
            return probes.pack_levels(vals, nbits, probes.P7_NWP, lv)

        got = tuple(t for t in probes.pack_levels(vals, nbits, probes.P7_NWP, lv, want_mid=True) if t is not None)
        want = tuple(t for t in probes.pack_levels_plain(vals, nbits, probes.P7_NWP, lv, want_mid=True)
                     if t is not None)
        if max_abs_err(got, want):
            raise AssertionError(f"probe7 level {lv} differs from its plain version")
        out[f"level {lv}"] = {"ms": cuda_ms(fn, max_iters=200), **device_time(fn, "probe7_pack", iters=20),
                              "call_device_ms": device_time(fn, None, iters=20)["device_ms"]}
    return out


def p7_host_split(vals, nbits) -> dict:
    """Host microseconds of the parts of a level-5 pack_levels call: the
    whole wrapper (it waits for the card), its checks, its allocations, the
    flagged launch (flag zeroed, kernel queued, stream wait, flag read), the
    launch alone and the stream wait alone."""
    import torch

    from tudocomp_tpu_torch import kernels, probes
    from tudocomp_tpu_torch.ops.bitpack_cuda import on_cuda

    B, NT = nbits.shape
    n_wp = probes.P7_NWP

    def alloc():
        return (torch.empty((B, 1, n_wp), dtype=torch.int32, device=vals.device),
                torch.empty((B, 1, 1), dtype=torch.int32, device=vals.device))

    args = (vals, nbits, B, NT, n_wp, *alloc(), 5, None)
    flag = kernels._flag(vals.get_device())[1]
    wait = kernels.helper("tdc_stream_wait")

    def checks():
        on_cuda(vals, nbits)
        probes._check_tokens(vals, nbits)
        return vals.dtype == torch.int32 and vals.is_contiguous() and nbits.dtype == torch.int32 \
            and nbits.is_contiguous()

    return {
        "probes.pack_levels(level 5), waits for the card": host_us(
            lambda: probes.pack_levels(vals, nbits, n_wp, 5), 500),
        "checks: on_cuda, _check_tokens, dtype and layout": host_us(checks),
        "allocation: two torch.empty": host_us(alloc),
        "kernels.launch_flagged: flag zeroed, launch, stream wait, flag read": host_us(
            lambda: kernels.launch_flagged("tdc_probe7_pack", *args), 500),
        "kernels.launch alone: the kernel queued, no wait": host_us(
            lambda: kernels.launch("tdc_probe7_pack", *args, flag)),
        "tdc_stream_wait on an idle stream": host_us(lambda: wait(kernels._stream(vals.get_device()))),
    }


def probes_phase(dev, gpu):
    """Phase 9: every kernel of csrc/probes.cu against its plain version at
    the probe scripts' own shapes; the gather also on unsorted indices over
    whole rows and on the edge shapes of probes.gather_cases, each case
    with the arm its tiles took, a bad index raising and the next call
    right; the entry point driven as a user drives it; the times: every
    kernel's wrapper ms (CUDA events) and device ms (torch.profiler), the
    gather and the two rolls in turns with torch.gather / torch.roll; and
    the launch path's host cost. Returns (errs, timing, launches) by
    kernel name."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch import kernels, probes

    vals3, nb3 = probes.probe3_inputs(dev)
    n_words = (9 * probes.P3_BS + 4096 + 31) // 32
    S = probes.hillis_xor(vals3)
    idx = probes.hist2(nb3, n_words).clamp(0, S.shape[1] - 1)
    idx64 = idx.to(torch.int64)
    del vals3, nb3
    rng = np.random.default_rng(9)
    rand_idx = torch.from_numpy(rng.integers(0, S.shape[1], tuple(idx.shape)).astype(np.int32)).to(dev)
    rand_idx64 = rand_idx.to(torch.int64)
    x8 = torch.arange(probes.TILE, dtype=torch.int32, device=dev).reshape(probes.ROWS, probes.LANES)
    xs = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (probes.ROWS, probes.LANES)).astype(np.int32)).to(dev)
    i300 = torch.tensor([[300]], dtype=torch.int32, device=dev)
    vals7, nbits7 = probes.probe7_inputs(dev)
    v8 = torch.ones((probes.P8_B, probes.P8_T, probes.ROWS, probes.LANES), dtype=torch.int32, device=dev)

    def p7(fn, level):
        return lambda v, nb: fn(v, nb, probes.P7_NWP, level, want_mid=True)

    # name -> [(args, kernel, plain)], the first case being the one that is timed
    cases = {
        "probe3_gather": [((S, idx), probes.gather, probes.gather_plain),
                          ((S, rand_idx), probes.gather, probes.gather_plain)],
        "probe6_roll_lane": [((x,), probes.roll_lane, probes.roll_lane_plain) for x in (x8, xs)],
        "probe6_roll_sublane": [((x8,), probes.roll_sublane, probes.roll_sublane_plain)],
        "probe6_extract": [((x8,), probes.scalar_extract, probes.scalar_extract_plain)],
        "probe6_bid": [((x8,), probes.broadcast_last_lane, probes.broadcast_last_lane_plain)],
        "probe6_dot3": [((x8,), probes.onehot_count, probes.onehot_count_plain)],
        "probe6_rmw": [((i300,), probes.window_rmw, probes.window_rmw_plain)],
        "probe6_shift": [((x8,), probes.var_shift, probes.var_shift_plain)],
        "probe7_pack": [((vals7, nbits7), p7(probes.pack_levels, lv), p7(probes.pack_levels_plain, lv))
                        for lv in (5, 4, 3, 2, 1)],
        "probe8_a": [((v8,), probes.carry_revisit, probes.carry_revisit_plain)],
        "probe8_b": [((v8,), probes.carry_scans, probes.carry_scans_plain)],
        "probe8_c": [((v8,), probes.carry_into_vector, probes.carry_into_vector_plain)],
        "probe8_d": [((v8,), probes.rmw_loop8, probes.rmw_loop8_plain)],
    }

    def tensors(out):
        out = out if isinstance(out, tuple) else (out,)
        return tuple(t for t in out if t is not None)

    errs = {}
    for name, variants in cases.items():
        errs[name] = max(max_abs_err(tensors(kernel(*args)), tensors(plain(*args)))
                         for args, kernel, plain in variants)
    torch.cuda.synchronize()
    if any(errs.values()):
        raise AssertionError(f"probe kernels differ from their plain versions: {errs}")
    # level 5 packs what kernel A packs
    from tudocomp_tpu_torch.ops import bitpack_cuda as bc

    words, bits = probes.pack_levels(vals7, nbits7, probes.P7_NWP, 5)
    if max_abs_err((words[:, 0], bits[:, 0, 0]), bc.pack_blocks(vals7, nbits7, probes.P7_NWP)):
        raise AssertionError("probe7 level 5 differs from kernel A")

    # the gather's arms: the probe's sorted indices stage, random ones go direct
    arms_by_case = {}
    for cname, (gS, gi) in {"probe shape, sorted": (S, idx), "probe shape, random": (S, rand_idx),
                            **probes.gather_cases(dev)}.items():
        arms = torch.zeros(3, dtype=torch.int32, device=dev)
        e = max_abs_err(probes.gather(gS, gi, arms), probes.gather_plain(gS, gi))
        arms_by_case[cname] = {"shape": [list(gS.shape), list(gi.shape)], "staged_direct_out": arms.tolist(),
                               "rule": probes.gather_arms(gS, gi).tolist(), "max_abs_err": e}
        errs["probe3_gather"] = max(errs["probe3_gather"], e)
    if any(c["max_abs_err"] or c["staged_direct_out"] != c["rule"] for c in arms_by_case.values()):
        raise AssertionError(f"gather cases: {arms_by_case}")
    if arms_by_case["probe shape, sorted"]["staged_direct_out"][0] == 0 or \
            arms_by_case["probe shape, random"]["staged_direct_out"][1] == 0:
        raise AssertionError(f"the probe shape did not take both arms: {arms_by_case}")
    bad = idx.clone()
    bad[5, 1000] = S.shape[1]
    try:
        probes.gather(S, bad)
        raise AssertionError("an index past ns did not raise")
    except IndexError:
        pass
    if max_abs_err(probes.gather(S, idx), probes.gather_plain(S, idx)):
        raise AssertionError("the gather after a bad index differs from its plain version")

    # the launch path: the stream handle follows torch.cuda.stream(...)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        if kernels._stream(0) != side.cuda_stream:
            raise AssertionError("kernels._stream(0) is not the side stream")
        on_side = probes.roll_lane(xs)
    side.synchronize()
    if kernels._stream(0) != torch.cuda.current_stream().cuda_stream or max_abs_err(on_side, probes.roll_lane_plain(xs)):
        raise AssertionError("a launch on a side stream went wrong")

    # the entry point, as `python -m tudocomp_tpu_torch.probes` runs it
    kernels.reset_counts()
    if probes.main([]) != 0:
        raise AssertionError("the probes entry point failed")
    torch.cuda.synchronize()
    launches = {name: kernels.counts()[name] for name in cases}
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"probe kernels never launched by the entry point: {missing}")

    timing = {}
    for name, variants in cases.items():
        args, kernel, plain = variants[0]
        timing[name] = {
            "ms": cuda_ms(lambda: kernel(*args), max_iters=200),
            **device_time(lambda: kernel(*args), name, iters=20),
            "plain_ms": cuda_ms(lambda: plain(*args), budget_ms=1000.0, max_iters=10),
            **bound(name, args, tensors(kernel(*args))),
        }
    timing["probe3_gather"].update(gather_floors(S, idx))
    timing["probe3_gather"]["body_ms"] = gather_body_ms(S, idx)
    library = {
        "probe3_gather": (lambda: probes.gather(S, idx), lambda: torch.gather(S, 1, idx64)),
        "probe6_roll_lane": (lambda: probes.roll_lane(x8), lambda: torch.roll(x8, 1, 1)),
        "probe6_roll_sublane": (lambda: probes.roll_sublane(x8), lambda: torch.roll(x8, 1, 0)),
    }
    for name, (kernel, lib) in library.items():
        timing[name].update(in_turns(kernel, lib, max_iters=200))
    timing["probe3_gather"]["library_with_index_cast_ms"] = cuda_ms(lambda: torch.gather(S, 1, idx.to(torch.int64)))
    direct = {**in_turns(lambda: probes.gather(S, rand_idx), lambda: torch.gather(S, 1, rand_idx64), max_iters=200),
              **device_time(lambda: probes.gather(S, rand_idx), "probe3_gather", iters=20),
              **gather_floors(S, rand_idx), "body_ms": gather_body_ms(S, rand_idx)}
    # the probe's sorted indices through the direct arm alone: S one word past
    # a 16-byte bound stages no tile; timed in turns with the staged arm
    S_off = torch.empty(S.numel() + 1, dtype=S.dtype, device=dev)[1:].view(S.shape)
    S_off.copy_(S)
    arms = torch.zeros(3, dtype=torch.int32, device=dev)
    if max_abs_err(probes.gather(S_off, idx, arms), probes.gather_plain(S, idx)) or arms.tolist()[0]:
        raise AssertionError(f"the sorted gather off a 16-byte bound: arms {arms.tolist()}")
    sorted_arms = {
        "direct_on_sorted": {"staged_direct_out": arms.tolist(),
                             **device_time(lambda: probes.gather(S_off, idx), "probe3_gather", iters=20)},
        "staged_on_sorted": device_time(lambda: probes.gather(S, idx), "probe3_gather", iters=20),
        "body_ms_in_turns": {
            "staged": [gather_body_ms(S, idx), None, None, gather_body_ms(S, idx)],
            "direct": [None, gather_body_ms(S_off, idx), gather_body_ms(S_off, idx), None],
        },
    }
    del S_off
    p7_levels = p7_timing(probes, vals7, nbits7)
    p7_host = p7_host_split(vals7, nbits7)
    out8 = torch.empty_like(x8)
    launch_path = {
        "stream_handle_us": {
            "torch.cuda.current_stream().cuda_stream": host_us(lambda: torch.cuda.current_stream().cuda_stream, 20000),
            "torch._C._cuda_getCurrentRawStream(0) (kernels._stream(0))":
                host_us(lambda: kernels._stream(0), 20000),
            "torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())":
                host_us(lambda: torch._C._cuda_getCurrentRawStream(torch.cuda.current_device()), 20000),
        },
        "host_us_a_call": {
            "kernels.launch('tdc_probe6_roll_lane', x, out)": host_us(
                lambda: kernels.launch("tdc_probe6_roll_lane", x8, out8)),
            "probes.roll_lane(x)": host_us(lambda: probes.roll_lane(x8)),
            "torch.roll(x, 1, 1)": host_us(lambda: torch.roll(x8, 1, 1)),
            "probes.roll_sublane(x)": host_us(lambda: probes.roll_sublane(x8)),
            "torch.roll(x, 1, 0)": host_us(lambda: torch.roll(x8, 1, 0)),
            "probes.gather(S, idx) (waits for the card)": host_us(lambda: probes.gather(S, idx), 200),
            "torch.gather(S, 1, idx64)": host_us(lambda: torch.gather(S, 1, idx64), 200),
        },
    }
    emit({"phase": "probes", "max_abs_err": errs, "tolerance": 0, "launches": launches, "kernels": timing,
          "gather_cases": arms_by_case, "gather_direct_probe_shape": direct,
          "gather_sorted_by_arm": sorted_arms, "launch_path": launch_path,
          "probe7_levels": p7_levels, "probe7_host_us": p7_host, "gather_shape": [list(S.shape), list(idx.shape)], "card": gpu})
    return errs, timing, launches


def _host_suffix_stack(text, threshold: int = 3):
    """SA, ISA, LCP and the factors of `text` (sentinel-terminated) from the
    C++ host helpers, with the host seconds of each stage."""
    import numpy as np

    from tudocomp_tpu_torch import native
    from tudocomp_tpu_torch.ds import suffix_array as sa_mod

    lib = native.get_lib()
    n = len(text)
    st = {}
    t0 = time.perf_counter()
    sa = np.empty(n, np.int32)
    if lib.tdc_sais(text, n, sa) != 0:
        raise RuntimeError("tdc_sais failed")
    t1 = time.perf_counter()
    isa = sa_mod.inverse_permutation(sa)
    t2 = time.perf_counter()
    plcp = np.empty(n, np.int32)
    lib.tdc_plcp_from_phi(text, n, sa_mod.phi_from_sa(sa), plcp)
    lcp = sa_mod.lcp_from_plcp(plcp, sa)
    t3 = time.perf_counter()
    fpos, fsrc, flen = (np.empty(n, np.uint32) for _ in range(3))
    nf = lib.tdc_lzss_lcp_factorize(sa, isa, lcp, n, threshold, fpos, fsrc, flen)
    t4 = time.perf_counter()
    st = {"tdc_sais": t1 - t0, "tdc_inverse_perm": t2 - t1, "phi, tdc_plcp_from_phi, lcp": t3 - t2,
          "tdc_lzss_lcp_factorize": t4 - t3}
    return sa, isa, lcp, (fpos[:nf], fsrc[:nf], flen[:nf]), st


def _device_suffix_stack(text, lcp_host, dev, threshold: int = 3):
    """The same from the card: text up, suffix_array_device, SA and ISA back;
    lcp_device (kernel H) and the LCP back; SA, ISA, LCP up (as lcp_factorize
    hands them over), the device factorization, the factors back."""
    import torch

    from tudocomp_tpu_torch.ds.suffix_array import suffix_array_device
    from tudocomp_tpu_torch.ops.lzss_torch import lzss_lcp_factorize_device
    from tudocomp_tpu_torch.ops.plcp_torch import lcp_device

    st = {}
    t, st["text to the card"] = synced(lambda: torch.from_numpy(text).to(dev))
    (sa_d, isa_d), st["suffix_array_device"] = synced(lambda: suffix_array_device(t, return_isa=True))
    (sa, isa), st["SA, ISA back"] = synced(lambda: (sa_d.cpu().numpy(), isa_d.cpu().numpy()))
    lcp_d, st["lcp_device (phi, kernel H, gather)"] = synced(lambda: lcp_device(t, sa_d))
    lcp, st["LCP back"] = synced(lambda: lcp_d.cpu().numpy())
    del sa_d, isa_d, lcp_d
    up, st["SA, ISA, LCP to the card"] = synced(
        lambda: [torch.from_numpy(a).to(dev) for a in (sa, isa, lcp_host)])
    factors, st["lzss_lcp_factorize_device, factors back"] = synced(
        lambda: lzss_lcp_factorize_device(*up, threshold))
    return sa, isa, lcp, factors, st


def suffix_phase(english, dev, gpu):
    """Phase 10. Returns (errs, timing) of kernel H."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.ops import plcp_torch

    texts = {"synth_english": english, "dna": dna_bytes(LZSS_BYTES)}
    report, err_h, line_h, launches_h = {}, 0, None, 0
    for name, raw in texts.items():
        text = np.concatenate([raw, np.zeros(1, np.uint8)])  # no 0 byte inside: the sentinel is unique
        sa, isa, lcp, factors, host_st = _host_suffix_stack(text)
        small = np.concatenate([raw[: 1 << 20], np.zeros(1, np.uint8)])
        _device_suffix_stack(small, _host_suffix_stack(small)[2], dev)  # warm the allocator and the kernels
        kernels.reset_counts()
        got = _device_suffix_stack(text, lcp, dev)
        launches_h += kernels.counts()["plcp_segments"]
        checks = {
            "SA": np.array_equal(got[0], sa), "ISA": np.array_equal(got[1], isa),
            "LCP": np.array_equal(got[2], lcp),
            "factors": all(np.array_equal(g, w) for g, w in zip(got[3], factors)),
        }
        if not all(checks.values()):
            raise AssertionError(f"{name}: the card's suffix stack differs from the host's: {checks}")
        # kernel H against its plain version (the lockstep walk), and its times
        t, sa_d = torch.from_numpy(text).to(dev), torch.from_numpy(sa).to(dev)
        plcp_k = plcp_torch.plcp_device(t, sa_d)
        plcp_p, plain_ms = cuda_once(lambda: plcp_torch.plcp_device_plain(t, sa_d))
        e = max_abs_err(plcp_k, plcp_p)
        if e:
            raise AssertionError(f"{name}: kernel H differs from its plain version by {e}")
        err_h = max(err_h, e)
        line = {**plcp_timing(plcp_torch, t, sa_d), "plain_ms": plain_ms}
        line_h = line_h or line
        dev_st = got[4]
        report[name] = {
            "n": len(text), "factors": len(factors[0]), "max_lcp": int(lcp.max()), "host_s": host_st,
            "device_s": dev_st, "kernel_H": line,
            "sa_device_with_copies_s": sum(dev_st[k] for k in ("text to the card", "suffix_array_device", "SA, ISA back")),
            "sa_host_with_isa_s": host_st["tdc_sais"] + host_st["tdc_inverse_perm"],
            "factorize_device_with_copies_s": dev_st["SA, ISA, LCP to the card"]
            + dev_st["lzss_lcp_factorize_device, factors back"],
            "factorize_host_s": host_st["tdc_lzss_lcp_factorize"],
        }
        del t, sa_d, plcp_k, plcp_p
        torch.cuda.empty_cache()
    if launches_h == 0:
        raise AssertionError("kernel H never launched by lcp_device")
    # kernel H at blockwise's shape: blocks of 256 KiB with their sentinel
    from tudocomp_tpu_torch.ds.suffix_array import suffix_array_device

    for k in range(4):
        block = np.concatenate([english[k * BS : (k + 1) * BS], np.zeros(1, np.uint8)])
        t = torch.from_numpy(block).to(dev)
        sa_d = suffix_array_device(t)
        got = plcp_torch.plcp_device(t, sa_d)
        if not np.array_equal(got.cpu().numpy(), host_plcp(block, sa_d.cpu().numpy())):
            raise AssertionError(f"256 KiB block {k}: kernel H differs from the host's PLCP")
        if k == 0:
            plcp_p, plain_ms = cuda_once(lambda: plcp_torch.plcp_device_plain(t, sa_d))
            e = max_abs_err(got, plcp_p)
            if e:
                raise AssertionError(f"256 KiB block: kernel H differs from its plain version by {e}")
            line_256 = {**plcp_timing(plcp_torch, t, sa_d), "plain_ms": plain_ms}
    line_h["by_shape"] = {"16 MiB": {k: line_h[k] for k in ("ms", "device_ms", "device_events", "call_device_ms")},
                          "256 KiB": line_256}

    # the gates' crossovers: prefixes of the English text, host against card
    sizes = {}
    for n in (1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 22):
        text = np.concatenate([english[:n], np.zeros(1, np.uint8)])
        best_h, best_d = None, None
        for _ in range(3):
            *_, lcp, _, h = _host_suffix_stack(text)
            d = _device_suffix_stack(text, lcp, dev)[4]
            hs = (h["tdc_sais"] + h["tdc_inverse_perm"], h["tdc_lzss_lcp_factorize"],
                  h["phi, tdc_plcp_from_phi, lcp"])
            ds = (d["text to the card"] + d["suffix_array_device"] + d["SA, ISA back"],
                  d["SA, ISA, LCP to the card"] + d["lzss_lcp_factorize_device, factors back"],
                  d["lcp_device (phi, kernel H, gather)"] + d["LCP back"])
            best_h = hs if best_h is None else tuple(map(min, best_h, hs))
            best_d = ds if best_d is None else tuple(map(min, best_d, ds))
        sizes[str(n)] = {"sa_host_s": best_h[0], "sa_device_s": best_d[0],
                         "factorize_host_s": best_h[1], "factorize_device_s": best_d[1],
                         "lcp_host_s": best_h[2], "lcp_device_s": best_d[2]}
    # the worst texts for the card: one letter, and a period of 1000 bytes
    # (every segment's first position re-walks a long LCP)
    repetitive = {}
    for name, raw in (("a^n", np.full(LZSS_BYTES, 97, np.uint8)),
                      ("period 1000", np.tile(english[:1000], LZSS_BYTES // 1000))):
        text = np.concatenate([raw, np.zeros(1, np.uint8)])
        sa, isa, lcp, factors, h = _host_suffix_stack(text)
        got = _device_suffix_stack(text, lcp, dev)
        if not all(np.array_equal(g, w) for g, w in zip((*got[:3], *got[3]), (sa, isa, lcp, *factors))):
            raise AssertionError(f"{name}: the card's suffix stack differs from the host's")
        repetitive[name] = {"n": len(text), "mean_lcp": float(lcp.mean()), "host_s": h, "device_s": got[4]}
    from tudocomp_tpu_torch import device as tdev

    emit({"phase": "suffix stack", "texts": report, "kernel_H_256KiB_block": line_256,
          "crossover_english_prefix_best_of_3": sizes, "repetitive": repetitive,
          "gates": {"SA_MIN_N": tdev.SA_MIN_N, "LZSS_MIN_N": tdev.LZSS_MIN_N}, "card": gpu})
    return {"plcp_segments": err_h}, {"plcp_segments": line_h}


def lzss_stages(data: bytes, device: str) -> dict:
    """Host seconds of each stage of lzss_lcp(coder=huff) on `data`, as the
    compressor runs them, the card synchronized after each; device "cpu"
    is run with every gate forced to the host."""
    import torch

    from tudocomp_tpu_torch.coders.huffman import HuffmanCoder
    from tudocomp_tpu_torch.compressors import lzss_common
    from tudocomp_tpu_torch.compressors.lzss_lcp import lcp_factorize
    from tudocomp_tpu_torch.ds.textds import TextDS
    from tudocomp_tpu_torch.io.bitio import BitWriter
    from tudocomp_tpu_torch.io.inout import Input
    from tudocomp_tpu_torch.io.restrict import InputRestrictions
    from tudocomp_tpu_torch.meta import AlgorithmValue, Env
    from tudocomp_tpu_torch.registry import TorchRegistry

    reg = TorchRegistry(device)
    dev = reg.device
    st = {}
    text, st["escape and sentinel"] = synced(
        lambda: Input(data).with_restrictions(InputRestrictions((0,), True)).as_array())
    ds = TextDS(text, device=dev)
    sa, st["SA"] = synced(ds.require_sa)
    isa, st["ISA"] = synced(ds.require_isa)
    lcp, st["PLCP, LCP"] = synced(ds.require_lcp)
    f, st["factorize"] = synced(lambda: lcp_factorize(sa, isa, lcp, 3, dev))
    w = BitWriter()
    env = Env(reg, AlgorithmValue("huff", {}, type="coder"))
    enc, st["literal feed, Huffman table"] = synced(
        lambda: HuffmanCoder.Encoder(env, w, lzss_common.literal_feed(text, f)))
    _, st["encode_text"] = synced(lambda: lzss_common.encode_text(enc, w, text, f))

    def finish():
        enc.finalize()
        return w.getvalue()

    _, st["finalize, pack"] = synced(finish)
    st["total"] = sum(st.values())
    st["factors"] = len(f)
    return st


def lzss_roundtrip_phase(english, dev, gpu) -> dict:
    """Phase 11: the lzss_lcp ids through the driver on the card against the
    port's host path. Returns kernel H's launches in those encodes, by the
    size of its text (the whole 16 MiB, or a 256 KiB block)."""
    import torch

    from tudocomp_tpu_torch import device as tdev
    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.driver import compress, decompress

    inputs = {"synth_english": english.tobytes(), "dna": dna_bytes(LZSS_BYTES).tobytes()}
    runs = [(LZSS_ALGO, "synth_english"), (LZSS_ALGO, "dna"),
            (f"blockwise({LZSS_ALGO},bs={BS})", "synth_english"),
            (f"blockwise({LZSS_ALGO},bs={BS},shared=1)", "synth_english")]
    launches_h = {"16 MiB": 0, "256 KiB": 0}  # kernel H's launches by the size of its text
    for algo, which in runs:
        data = inputs[which]
        kernels.reset_counts()
        container, enc_s = synced(lambda: compress(algo, data, device="cuda"))
        launched = kernels.counts()["plcp_segments"]
        if launched == 0:
            raise AssertionError(f"{algo} on {which}: kernel H never launched")
        launches_h["256 KiB" if algo.startswith("blockwise") else "16 MiB"] += launched
        back, dec_s = synced(lambda: decompress(container, device="cuda"))
        if back != data:
            raise AssertionError(f"{algo} on {which}: device roundtrip differs from the input")
        t0 = time.perf_counter()
        ref = ref_compress(algo, data)
        t1 = time.perf_counter()
        if container != ref:
            raise AssertionError(f"{algo} on {which}: container differs from the host path's")
        if ref_decompress(container) != data:
            raise AssertionError(f"{algo} on {which}: the host decode differs from the input")
        t2 = time.perf_counter()
        _, warm_s = synced(lambda: compress(algo, data, device="cuda"))
        no_jax()
        bs = BS if algo.startswith("blockwise") else len(data) + 1
        emit({"phase": "lzss roundtrip", "algo": algo, "input": which, "bytes": len(data),
              "container_bytes": len(container), "ratio": len(container) / len(data),
              "sa_on_card": tdev.use_sa_device(bs, dev), "factorize_on_card": tdev.use_lzss_device(bs, dev),
              "kernel_H_launches": launched,
              "first_encode_s": enc_s, "warm_encode_s": warm_s, "decode_s": dec_s,
              "encode_MBps": len(data) / warm_s / 1e6, "decode_MBps": len(data) / dec_s / 1e6,
              "host_reference_encode_s": t1 - t0, "host_reference_decode_s": t2 - t1, "card": gpu})
        del container, back, ref
    stages = {}
    for which, data in inputs.items():
        with host_path():
            host = lzss_stages(data, "cpu")
        stages[which] = {"card": lzss_stages(data, "cuda"), "host": host}
        torch.cuda.empty_cache()
    emit({"phase": "lzss stages", "algo": LZSS_ALGO, "bytes": LZSS_BYTES, "stages": stages,
          "kernel_H_launches_by_shape": launches_h, "card": gpu})
    return launches_h


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in ("--dh", "--turns"):
        sys.exit((dh_main if sys.argv[1] == "--dh" else turns_main)(sys.argv[2]))
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
