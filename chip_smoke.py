#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tudocomp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card. The reference
of every phase is the port's own host path: driver.compress(algo, data,
device="cpu") and decompress(container, device="cpu") with
TDC_DEVICE_HUFF=0 and TDC_DEVICE_LZ78=0, which run the port's copies of the
host coders and parses (tier-1 holds those byte-equal to the JAX package on
the CPU). Phases, one JSON line each:
  1. build          compile the CUDA kernels from tudocomp_tpu_torch/csrc,
                    one nvcc per source, in parallel, and the C++ host
                    helpers (g++) beside them;
  2. kernels        kernels A-D against their plain PyTorch versions on the
                    card, at the shapes of the Huffman path, held to exact
                    equality (every stage is integer arithmetic);
  3. roundtrip      a seeded 256 MiB input through
                    driver.compress / decompress("blockwise(encode(huff))",
                    device="cuda"); the container must equal, byte for byte,
                    the one the host path writes, and both decoders must
                    return the input; kernels A-D must have been launched;
  4. timing         CUDA-event times of kernels A-D and their plain versions,
                    and the end-to-end encode / decode rates of the roundtrip;
  5. shared         kernel G (Moffat phases 1-2, int64) against its plain
                    version, exactly, on the summed histogram of the 256 MiB
                    input, on phase 2's 69 histograms and on a row with
                    weights past 2^31; the 256 MiB input through
                    blockwise(encode(huff),shared=1) on the card, decoded
                    on the card and by the host decoder, block 0's table
                    holding Kraft's equality, G, A, B and D launched; the
                    card's container of a 16 MiB prefix equal to the port's
                    CPU run (plain versions); G's times, and the warm
                    encode / decode rates with and without shared;
  6. lz78 kernels   kernels E (LZ78 parse) and F (LZW parse) against their
                    plain versions and the host parses, exactly, at the
                    shapes phase 7 launches them with (the whole input as
                    [200, 262144] and [6400, 8192]), at [128, 8192] and at
                    an odd batch of 131 blocks;
  7. lz78 roundtrip 50 MiB of bench.py's English stand-in through
                    blockwise(lz78(coder=bit)) (bs 256 KiB),
                    blockwise(lz78(coder=bit),bs=8192) and
                    blockwise(lzw(coder=bit),bs=8192) on the card; each
                    container must equal the host path's and both decoders
                    must return the input; E and F must have been launched;
  8. lz78 timing    the device parse of phase 7's blocks against the host
                    parse of the same blocks, the stages of each lz78/lzw
                    encode and decode, the end-to-end rates, and the encode
                    at the parse gate's largest block and at four times it,
                    with the device parse and with the host parse.
Then the card's name and power limit (nvidia-smi), one line listing the
kernels (each with its launches on its path, its bound and its plain
version's time), and the final line {"ok": true, "device": {...}}. Any
failure raises: the script then exits non-zero and prints no final line.
jax and the JAX package (tudocomp_tpu) are blocked from import for the
whole run.
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
ROUNDTRIP_BYTES = 256 * MIB
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


@contextlib.contextmanager
def host_path():
    """The port's host coders and parses: no device stage runs (an id with
    shared=1 takes the kernels' plain versions on the CPU)."""
    os.environ.update(TDC_DEVICE_HUFF="0", TDC_DEVICE_LZ78="0")
    try:
        yield
    finally:
        for var in ("TDC_DEVICE_HUFF", "TDC_DEVICE_LZ78"):
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
    raise KeyError(name)


def kernel_bytes(name: str, args, out) -> int:
    """Bytes the function must move: each input read once, each output
    written once. The pack kernels count their blocks' valid bytes and the
    32-bit words their bits fill, not the arenas' allocated size (kernel B's
    is sized for 9 bits a byte, kernel A's for 32 bits a token)."""
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
    return nbytes(args) + nbytes(out)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "tudocomp_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    for var in ("TDC_DEVICE_HUFF", "TDC_DEVICE_LZ78", "TDC_BLOCKWISE_PROCS"):
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

    from tudocomp_tpu_torch.parallel.blocks import unframe_streams
    from tudocomp_tpu_torch.parallel.runtime import blockwise_huffman_compress

    dec_raw = batch.reshape(-1)[: 16 * MIB].tobytes()
    _, payloads = unframe_streams(blockwise_huffman_compress(dec_raw, DEC_BS, dev))
    parsed = [hd.parse_payload_tables(p) for p in payloads]
    W = max(len(p[3]) for p in parsed)
    words = np.zeros((len(parsed), W), np.uint32)
    for i, p in enumerate(parsed):
        words[i, : len(p[3])] = p[3]
    d_args = (
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.tensor([p[4] for p in parsed], dtype=torch.int32, device=dev),
        torch.from_numpy(np.stack([p[0] for p in parsed])).to(dev),
        torch.from_numpy(np.stack([p[1] for p in parsed])).to(dev),
        torch.from_numpy(np.stack([p[2] for p in parsed])).to(dev),
        DEC_BS,
    )
    got = hd.decode_payloads(*d_args)
    errs["decode_payloads"] = max_abs_err(got, hd.decode_payloads_plain(*d_args))
    if got[0].cpu().numpy().tobytes() != dec_raw:
        raise AssertionError("kernel D did not return the 1024 streams' input")
    cases["decode_payloads"] = (d_args, hd.decode_payloads, hd.decode_payloads_plain)
    torch.cuda.synchronize()
    if any(errs.values()):
        raise AssertionError(f"kernels differ from their plain versions: {errs}")
    emit({"phase": "kernels", "max_abs_err": errs, "tolerance": 0, "streams": len(payloads), "card": gpu})

    # 3. roundtrip through the public entry points ----------------------------
    from tudocomp_tpu_torch.driver import compress, decompress

    data = np.concatenate([zipf_bytes(2, ROUNDTRIP_BYTES - TEXT_BYTES), text_bytes(TEXT_BYTES)]).tobytes()
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
            "plain_ms": cuda_ms(lambda: plain(*args), budget_ms=2000.0, max_iters=10),
            **bound(name, args, kernel(*args)),
        }
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

    print(gpu)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name], **timing[name], "library_ms": None}
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
    at odd ones. The kernels line takes the times at [6400, 8192]."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch.parallel.blocks import split_blocks

    def batch(lo: int, B: int, bs: int):
        return text[lo : lo + B * bs].reshape(B, bs).copy(), np.full(B, bs, np.int32)

    odd, odd_nv = batch(5 * MIB, 131, 8192)  # B not a multiple of 128
    odd[0] = ord("e")  # one byte throughout: ends inside a phrase
    odd_nv[1], odd_nv[2], odd_nv[3] = 0, 5000, 1  # empty, ragged, one byte
    cases = {
        "lz78 [128, 8192]": ("lz78_parse", *batch(0, 128, 8192)),
        "lz78 odd [131, 8192]": ("lz78_parse", odd, odd_nv),
        "lzw [128, 8192]": ("lzw_parse", *batch(0, 128, 8192)),
        "lzw odd [131, 8192]": ("lzw_parse", odd, odd_nv),
    }
    line_case = {}
    for bs, kname in LZ78_ALGOS.values():
        blocks, n_valid = split_blocks(text.tobytes(), bs)
        name = f"{kname.split('_')[0]} [{len(blocks)}, {bs}]"
        cases[name] = (kname, blocks, n_valid)
        if bs == 8192:
            line_case[kname] = name
    errs = {"lz78_parse": 0, "lzw_parse": 0}
    report, timing = {}, {}
    for name, (kname, blocks, n_valid) in cases.items():
        kernel, plain, host = _parse_fns(kname)
        b, nv = torch.from_numpy(blocks).to(dev), torch.from_numpy(n_valid).to(dev)
        got = kernel(b, nv)
        torch.cuda.empty_cache()  # the plain child table of a main shape takes ~52 GiB
        want, plain_ms = cuda_once(lambda: plain(b, nv))
        err = max_abs_err(got, want)
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
        report[name] = {"ms": ms, "plain_ms": plain_ms, "factors": int(got[-1].sum()),
                        "blocks_ending_mid_phrase": mid}
        errs[kname] = max(errs[kname], err)
        if name == line_case[kname]:
            timing[kname] = {"ms": ms, "plain_ms": plain_ms, **bound(kname, (b, nv), got)}
        del b, nv, got, want
    torch.cuda.empty_cache()
    emit({"phase": "lz78 kernels", "max_abs_err": errs, "tolerance": 0, "cases": report, "card": gpu})
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
    host parse at the parse gate's largest block (device.PARSE_MAX_BS) and
    at four times that."""
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
    cap, gate = tdev.PARSE_MAX_BS, {}
    tdev.PARSE_MAX_BS = 4 * cap  # lets TDC_DEVICE_LZ78=1 reach past the gate
    try:
        for kind in ("lz78", "lzw"):
            for bs in (cap, 4 * cap):
                algo = f"blockwise({kind}(coder=bit),bs={bs})"
                out = {}
                for mode in ("1", "0"):  # device parse, host parse
                    os.environ["TDC_DEVICE_LZ78"] = mode
                    kernels.reset_counts()
                    out[mode], gate[f"{algo}, TDC_DEVICE_LZ78={mode}, encode_s"] = synced(
                        lambda: compress(algo, data, device="cuda"))
                    if (kernels.counts()[f"{kind}_parse"] > 0) != (mode == "1"):
                        raise AssertionError(f"{algo}: TDC_DEVICE_LZ78={mode} took the other parse")
                if out["1"] != out["0"]:
                    raise AssertionError(f"{algo}: the device and host parses give different containers")
    finally:
        tdev.PARSE_MAX_BS = cap
        os.environ.pop("TDC_DEVICE_LZ78", None)
    emit({"phase": "lz78 timing", "parse": shapes, "stages": stages, "end_to_end": e2e,
          "gate": gate, "card": gpu})


if __name__ == "__main__":
    sys.exit(main())
