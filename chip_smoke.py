#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tudocomp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card. Phases, one JSON
line each:
  1. build          compile the CUDA kernels from tudocomp_tpu_torch/csrc,
                    one nvcc per source, in parallel;
  2. kernels        kernels A-D against their plain PyTorch versions on the
                    card, at the shapes of the Huffman path, held to exact
                    equality (every stage is integer arithmetic);
  3. roundtrip      a seeded 256 MiB input through
                    driver.compress / decompress("blockwise(encode(huff))",
                    device="cuda"); the container must equal, byte for byte,
                    the one the JAX package's host path writes
                    (tudocomp_tpu.driver, which runs without jax), and both
                    decoders must return the input; kernels A-D must have
                    been launched;
  4. timing         CUDA-event times of kernels A-D and their plain versions,
                    and the end-to-end encode / decode rates of the roundtrip;
  5. lz78 kernels   kernels E (LZ78 parse) and F (LZW parse) against their
                    plain versions and the host parses, exactly, at the
                    shapes phase 6 launches them with (the whole input as
                    [200, 262144] and [6400, 8192]), at [128, 8192] and at
                    an odd batch of 131 blocks;
  6. lz78 roundtrip 50 MiB of bench.py's English stand-in through
                    blockwise(lz78(coder=bit)) (bs 256 KiB),
                    blockwise(lz78(coder=bit),bs=8192) and
                    blockwise(lzw(coder=bit),bs=8192) on the card; each
                    container must equal the JAX package's host path's and
                    both decoders must return the input; E and F must have
                    been launched;
  7. lz78 timing    the device parse of phase 6's blocks against the host
                    parse of the same blocks, the stages of each lz78/lzw
                    encode and decode, the end-to-end rates, and the encode
                    at the parse gate's largest block and at four times it,
                    with the device parse and with the host parse.
Then the card's name and power limit (nvidia-smi), one line listing the
kernels, and the final line {"ok": true, "device": {...}}. Any failure
raises: the script then exits non-zero and prints no final line. jax is
blocked from import for the whole run.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time

sys.modules["jax"] = None  # the port and the reference host path run without jax

ROOT = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
BS = 1 << 18  # the CLI's default block size
BENCH_BLOCKS = 64  # bench.py's encode batch: 64 blocks of 256 KiB
DEC_BS = 1 << 14  # bench.py's decode streams: 16 KiB
ROUNDTRIP_BYTES = 256 * MIB
TEXT_BYTES = 16 * MIB
ALGO = "blockwise(encode(huff))"
LZ78_BYTES = 50 * MIB  # BASELINE config 2's english.50MB, as bench.py synthesizes it
LZ78_ALGOS = {  # id -> (block size, the kernel of its parse)
    "blockwise(lz78(coder=bit))": (BS, "lz78_parse"),
    "blockwise(lz78(coder=bit),bs=8192)": (8192, "lz78_parse"),
    "blockwise(lzw(coder=bit),bs=8192)": (8192, "lzw_parse"),
}
HUFF_KERNELS = ("pack_blocks", "pack_bytes_blocks", "huffman_tables", "decode_payloads")

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
    """bench.py's stand-in for Pizza&Chili english (etc/datasets.py, seed 7)."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "etc"))
    from datasets import synth_english

    return np.frombuffer(synth_english(np.random.default_rng(7), n), np.uint8)


def ref_compress(algo: str, data: bytes) -> bytes:
    """The JAX package's host path, one block after another."""
    from tudocomp_tpu.driver import compress as host_compress

    os.environ["TDC_BLOCKWISE_PROCS"] = "0"
    try:
        return host_compress(algo, data)
    finally:
        del os.environ["TDC_BLOCKWISE_PROCS"]


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
    t0 = time.perf_counter()
    so = kernels.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(so, ROOT), "card": gpu})

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

    from tudocomp_tpu.parallel.blocks import unframe_streams
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
    from tudocomp_tpu.driver import decompress as host_decompress
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
        raise AssertionError("container differs from the JAX package's host path")
    if host_decompress(container) != data:
        raise AssertionError("the JAX package's host decode of the container differs from the input")
    t5 = time.perf_counter()
    if sys.modules.get("jax") is not None:
        raise AssertionError("jax was imported")
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

    del data, back, container, ref

    # 5-7. the LZ78/LZW block parse -------------------------------------------
    text = english_bytes(LZ78_BYTES)
    errs_e, timing_e = lz78_kernel_phase(text, dev, gpu)
    errs.update(errs_e)
    launches.update(lz78_roundtrip_phase(text.tobytes(), gpu))
    lz78_timing_phase(text, dev, gpu)
    timing.update(timing_e)

    print(gpu)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"]}
        for name, (src, rep) in KERNEL_INFO.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _parse_fns(kernel: str):
    from tudocomp_tpu.compressors.lz78 import lz78_parse
    from tudocomp_tpu.compressors.lzw import lzw_parse
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
    """Phase 5: E and F against their plain versions and the host parses, at
    the main path's shapes (the whole input, split as phase 6 splits it) and
    at odd ones. The kernels line takes the times at [6400, 8192]."""
    import numpy as np
    import torch

    from tudocomp_tpu.parallel.blocks import split_blocks

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
            timing[kname] = {"ms": ms, "plain_ms": plain_ms}
        del b, nv, got, want
    torch.cuda.empty_cache()
    emit({"phase": "lz78 kernels", "max_abs_err": errs, "tolerance": 0, "cases": report, "card": gpu})
    return errs, timing


def lz78_roundtrip_phase(data: bytes, gpu) -> dict:
    """Phase 6: the three ids on the card against the JAX package's host path."""
    import torch

    from tudocomp_tpu import native
    from tudocomp_tpu.driver import decompress as host_decompress
    from tudocomp_tpu_torch import kernels
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
            raise AssertionError(f"{algo}: container differs from the JAX package's host path")
        if host_decompress(container) != data:
            raise AssertionError(f"{algo}: the JAX package's host decode differs from the input")
        t2 = time.perf_counter()
        if sys.modules.get("jax") is not None:
            raise AssertionError("jax was imported")
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

    from tudocomp_tpu.compressors.lz78 import lz78_expand
    from tudocomp_tpu.compressors.lzw import lzw_expand
    from tudocomp_tpu.parallel.blocks import frame_streams, split_blocks, unframe_streams
    from tudocomp_tpu_torch.driver import decompress
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
    """Phase 7: the device parse of the roundtrip's blocks (copies included)
    against the host parse of the same blocks, the stage breakdowns, warm
    end-to-end rates, and the encode with the device parse and with the
    host parse at the parse gate's largest block (device.PARSE_MAX_BS) and
    at four times that."""
    from tudocomp_tpu.parallel.blocks import split_blocks
    from tudocomp_tpu_torch import device as tdev
    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.driver import compress, decompress
    from tudocomp_tpu_torch.ops import lz78_cuda as lc

    import torch

    data = text.tobytes()
    shapes, stages, e2e = {}, {}, {}
    for algo, (bs, kname) in LZ78_ALGOS.items():
        host = _parse_fns(kname)[2]
        blocks, n_valid = split_blocks(data, bs)
        helper = lc.lz78_parse_blocks_device if kname == "lz78_parse" else lc.lzw_parse_blocks_device
        host_s = {}
        for trie in ("ternary", "hash"):  # the compressors' default trie, and tdc_lz78_parse's hash
            t0 = time.perf_counter()
            for i in range(len(blocks)):
                host(blocks[i, : n_valid[i]], trie)
            host_s[trie] = time.perf_counter() - t0
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
