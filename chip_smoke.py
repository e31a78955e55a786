#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tudocomp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns PARENT   # kernels A-J and P7 of PARENT's checkout and this one, in turns
    python3 chip_smoke.py --dh ROOT        # kernels A-J and P7 of ROOT's checkout, one JSON line
    python3 chip_smoke.py --j              # kernel J's device ms on phase 16's English text, one JSON line
    python3 chip_smoke.py --rank DIR WORLD PORT RANK   # one gloo rank of phase 19 (the script starts them)
    python3 chip_smoke.py --full           # the run, with the gate sweeps and the stage breakdowns

Runs from the root of a checkout and needs one CUDA card. The reference
of every phase is the port's own host path: driver.compress(algo, data,
device="cpu") and decompress(container, device="cpu") with
TDC_DEVICE_HUFF=0, TDC_DEVICE_LZ78=0, TDC_DEVICE_SA=0, TDC_DEVICE_LZSS=0,
TDC_DEVICE_ESP=0, TDC_DEVICE_LCPCOMP=0, TDC_DEVICE_RLE=0 and
TDC_DEVICE_MTF=0, which run the port's copies of the host coders, parses,
suffix stack, ESP rounds, lcpcomp stages and transforms (the CPU tests
hold those byte-equal to the JAX package). Phases, one JSON
line each:
  1. build          compile the CUDA kernels from tudocomp_tpu_torch/csrc,
                    one nvcc per source, in parallel, and the C++ host
                    helpers (g++) beside them;
  2. kernels        kernels A-D against their plain PyTorch versions on the
                    card, at the shapes of the Huffman path, held to exact
                    equality (every stage is integer arithmetic); C on
                    the 64 blocks' histograms and seven edge rows
                    (edge_histograms: sigma 0, 1, 2 and 256, codes of 30
                    bits, all counts equal, many ties); A and B
                    also on the tile-boundary cases of
                    tests/torch_cases.py (pack_edge_cases,
                    pack_bytes_edge_cases); D also on
                    phase 3's input as 256 streams of 256 KiB (the CLI's
                    block size), held to the input, with the largest count
                    of synchronisation rounds at both shapes;
  3. roundtrip      a seeded 64 MiB input through
                    driver.compress / decompress("blockwise(encode(huff))",
                    device="cuda"); the container must equal, byte for byte,
                    the one the host path writes, and both decoders must
                    return the input; kernels A-D must have been launched;
  4. timing         CUDA-event times of kernels A-D and their plain versions
                    (D at both of phase 2's shapes), A's and B's wrappers'
                    host time by part (checks and allocations, launch,
                    stream wait), and the end-to-end encode / decode rates
                    of the roundtrip;
  5. shared         kernel C's int64 instance (the shared table) and
                    kernel G (Moffat phases 1-2 alone, int64) against their
                    plain versions, exactly, on the summed histogram of the
                    64 MiB input, on phase 2's 71 histograms and on a row
                    with weights past 2^31; the int64 instance raising on a
                    row whose code needs 33 bits; the 64 MiB input through
                    blockwise(encode(huff),shared=1) on the card, decoded
                    on the card and by the host decoder, block 0's table
                    holding Kraft's equality, the table one launch of the
                    int64 instance, A, B and D launched; the card's
                    container of a 16 MiB prefix equal to the port's CPU
                    run (plain versions); both kernels' times, the encode's
                    stages, and the warm encode / decode rates with and
                    without shared;
  6. lz78 kernels   kernels E (LZ78 parse) and F (LZW parse) against their
                    plain versions and the host parses, exactly, at the
                    shapes phase 7 launches them with (the whole input as
                    [200, 262144] and [6400, 8192]), at [128, 8192], at an
                    odd batch of 131 blocks, and E on [4, 262144] of one
                    letter (phrases up to 724 bytes) and of uniform random
                    bytes (its table near its worst load), and F on phase
                    8's 4 MiB blocks; the host parse on every whole block;
                    in rows of 256 KiB and more the plain version (a step a
                    byte) and the kernel again on the first 64 KiB of each
                    row (PLAIN_PREFIX), of the first 32 rows at [200,
                    262144] and of the first two at 4 MiB; E's wrapper and device ms at both
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
 12. esp kernel     kernel I (the ESP adjust pass's queue machine) against
                    its plain version, exactly, on the spans of each of the 9
                    device rounds of 16 MiB of bench.py's English stand-in
                    (synth_english, seed 7: bench.py's device_esp_16MiB input)
                    and on tests/torch_cases.py's edge spans (widths 1-260,
                    all ones, alternating types, no spans, and the cases of
                    its warps' staging); each round's
                    blocks, spans, widest span, wrapper ms (CUDA events,
                    fresh copies of the blocks made outside the events: it
                    works in place), device ms, plain ms and bound, and the
                    bytes its warps stage in shared memory beside it;
 13. esp roundtrip  esp and esp(slp_coder=sorted(d_coding=arith)) on those
                    16 MiB, and esp and esp(slp_coder=sorted) on 1 MiB of the
                    same text (bench.py's esp cells), through driver.compress /
                    decompress(device="cuda"): each container equals the host
                    path's (TDC_DEVICE_ESP=0), both decoders return the input,
                    kernel I launched where the gate takes the card, the 1 MiB
                    ratios BENCH_r05's 48.64% and 31.48%; then the 16 MiB
                    encode's StatPhase spans on the card and on the host
                    (the two containers equal), the 1 MiB sorted encode's
                    spans on the card (its succinct coding's steps among
                    them), the device rounds against the
                    host rounds from 64 KiB to 16 MiB (the numbers behind
                    device.ESP_MIN_N) and the 16 MiB grammar at three
                    host-finish thresholds.
 14. lcpcomp roundtrip  lcpcomp(coder=huff) (arrays, scan) and
                    lcpcomp(coder=huff,comp=plcppeaks) on phase 10's 16 MiB
                    texts through driver.compress(device="cuda"), with the
                    gates as set and with TDC_DEVICE_LCPCOMP=1: each
                    container equals the host path's; each container
                    decoded under dec=scan and dec=compact on the card
                    (TDC_DEVICE_LCPCOMP=1) and on the host returns the
                    input; kernel H launched (TextDS takes the PLCP from it,
                    and the plcppeaks walk its SA, ISA and PLCP on the card);
                    ratios and rates. At 1 MiB of the English text,
                    lcpcomp(coder=sle), encode(coder=sle) and the two textds
                    ids of the matrix, each against the host path;
 15. lcpcomp stages the StatPhase spans of one warm 16 MiB English encode
                    and decode of each phase 14 id, card against host, and
                    the sweep behind device.LCPCOMP_MIN_N and
                    LCPCOMP_DEC_MIN_N: plcppeaks_factorize_device (from the
                    card's SA, ISA and PLCP, the factors back) against the
                    C++ strategy (with the ISA and PLCP brought down; below
                    device.SA_MIN_N the host builds the SA, and the card's
                    side takes the copies up instead), and
                    resolve_factors_device (copies included) against
                    tdc_lcpcomp_scan_decode, on prefixes of 16 KiB to 16
                    MiB, best of 2-3.
 16. transforms kernel  kernel J (the MTF encode, csrc/mtf.cu) against its
                    plain version and the host's tdc_mtf_encode, exactly, on
                    16 MiB of the English stand-in, of the DNA text and of
                    uniform random bytes, on the RLE output of the English
                    text (what rle:mtf feeds it) and on tests/torch_cases.py's
                    edge inputs (mtf_edge_cases), each at its default chunk
                    and at every chunk of MTF_CHUNKS; its wrapper ms on each 16
                    MiB input, plain ms and device ms by kernel (J1-J3,
                    torch.profiler in a fresh process, `--j`: late in this
                    run the profiler keeps no events) on the English one,
                    its bound, and its ms at chunks of 1-8 KiB;
 17. transforms roundtrip  rle:mtf:encode(vbyte) (BASELINE config 1) on 1
                    MiB (ratio BENCH_r05's 103.24%) and 16 MiB of the English
                    text, bwt:rle:mtf:encode(huff) on the 16 MiB English and
                    DNA texts, and each of the 16 matrix ids of the slice
                    (noop, rle, mtf, bwt, lzss, repair, the chain) on 1 MiB
                    of English (lzss on LZSS_IDS_BYTES, repair on
                    REPAIR_BYTES), through
                    driver.compress / decompress(device="cuda"): each
                    container equals the host path's, both decoders return
                    the input, kernel J launched wherever its gate takes the
                    MTF stage's input to the card; then the StatPhase spans
                    of one warm 16 MiB English encode and decode of each
                    chain, card against host, and the sweep behind
                    device.RLE_MIN_N and MTF_MIN_N: each device stage with
                    its copies against its host stage, on prefixes of 4
                    KiB to 16 MiB of the English text, best of 2-3.
 18. matrix tail   the ids of lz78u, lfs_comp and lfs2 (host strategies
                    over the suffix stack that TextDS builds on the card)
                    and the nested blockwise: (a) lz78u on 1 MiB of the
                    English text, lfs_comp(computing_strat=st), (...=sim_st),
                    lfs_comp (esa) and lfs2 on 256 KiB + 1 of it,
                    through driver.compress / decompress(device="cuda"):
                    each container equals the host path's, both decoders
                    return the input, kernel H launched on each, and the
                    StatPhase stages card against host (suffix stack,
                    strategy, coding, decode); (b) every one of the 66 ids
                    and three nested blockwise ids (inner blocks short) on
                    4 KiB on the card against the host path; (c)
                    blockwise(blockwise(encode(huff)),bs=4194304) against
                    the flat blockwise(encode(huff)) on 64 MiB of zipf(1.3):
                    the inner payloads equal the flat ones, the card's
                    decode returns the input, A-D's launches and each
                    wall time; (d) `python -m tudocomp_tpu_torch -a lz78u
                    -s` on a 300 KiB file: the container equals the host
                    path's and the JSON's phases carry the card's memory
                    (devMemOff, devMemPeak, devMemFinal); the phase's seconds.
 19. group         the process group and blockwise's pools: (a) two
                    processes of this script (--rank), gloo ranks sharing
                    card 0, run pod_compress with the huff inner (per block
                    and shared=1) on phase 3's 64 MiB and the lzss inner
                    (shared 0 and 1) on 16 MiB of the English stand-in, at
                    blocks of 256 KiB, after one warm call each; every
                    container equals the one-process card run's and the
                    host path's and decodes on the card through the driver
                    to the input, and each rank launched the path's kernels
                    (A, B, C or C's int64 instance; H); the backend, each
                    rank's wall seconds and launches against one process's
                    (two ranks on one card and one host: not a scaling
                    figure); (b) blockwise(lz78u,bs=262144) on 4 MiB of the
                    English text (16 blocks) with TDC_BLOCKWISE_PROCS unset,
                    =8 and =0, encode (the spawn pool) and decode (the
                    thread pool), the containers equal, the workers each
                    arm's StatPhase logged; (c) blockwise_lzss_compress's
                    thread pool at 1, 2, 4 and 8 threads on the 16 MiB, in
                    turns (the numbers behind runtime.LZSS_THREADS); (d) the
                    decode on 8 threads against one block after another, in
                    turns, at 8 KiB and 256 KiB blocks of lz78(coder=bit) on
                    8 MiB (with (b), the numbers behind
                    compressors/blockwise.DEFAULT_WORKERS).
                    Phases 1-18 run with TDC_BLOCKWISE_PROCS=0, the
                    sequential host blocks they were measured with.
Each phase's line carries t_s, the seconds since the script started. Two
kinds of measurement run only under --full, so that the run stays well
inside its time limit: the sweeps behind the size gates (phase 8's block
sizes and inputs of few blocks, phase 10's prefixes, phase 13's sweep and
thresholds, phase 15's and phase 17's sweeps) and the stage breakdowns
(phase 8's stages and warm rates, phases 11, 13, 15 and 17's StatPhase
spans); without it their keys are empty. Every path, container check and
kernel check runs either way.
Then the card's name and power limit (nvidia-smi), one line listing the
kernels (each with its launches on its path, its wrapper and device times,
its bound and its plain version's time), and the final line {"ok": true, "device": {...}}. Any
failure raises: the script then exits non-zero and prints no final line.
jax and the JAX package (tudocomp_tpu) are blocked from import for the
whole run.

--turns PARENT compares kernels A-J and P7 of two checkouts on one card: it
runs this script with --dh in a process of its own for PARENT, this
checkout, this checkout and PARENT, in that order. --dh ROOT builds ROOT's
kernels and times, first (late in a long process the profiler drops
events), J on phase 16's four 16 MiB inputs and I on each device round of
phase 12's 16 MiB grammar (device ms by __global__ function under either
design's names), then C on phase 2's histograms, G and the shared table's stage
(shared_tables, which is C's int64 instance where the checkout has one) on
their summed row, phase 3's 64 MiB encode through the driver, per-block
and shared=1, three times each in turns, A and B at phase 2's shapes (device ms under the
__global__ names of either design of csrc/pack.cu and csrc/tables.cu), D
at both of phase 2's shapes, H on 16 MiB of
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
T_START = time.perf_counter()
# the gate sweeps and the stage breakdowns run only under --full (set in
# __main__): they measure where a gate sits and where a path's time goes,
# not whether it is right, and would take the run near its time limit
FULL = False
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
ESP_BYTES = 16 * MIB  # bench.py's device_esp_16MiB input: synth_english, seed 7
ESP_ALGOS = ("esp", "esp(slp_coder=sorted(d_coding=arith))")  # BASELINE config 4 at 16 MiB
ESP_RATIOS_1MIB = {"esp": 48.64, "esp(slp_coder=sorted)": 31.48}  # bench.py:337-338, BENCH_r05's ratio_pct
ESP_THRESHOLDS = (1 << 12, 1 << 15, 1 << 18)  # esp_grammar_device's host-finish threshold (default 1 << 15)
ESP_SWEEP = (64 << 10, 128 << 10, 256 << 10, 512 << 10, MIB, 4 * MIB, 16 * MIB)  # sizes behind ESP_MIN_N
LCPCOMP_BYTES = 16 * MIB  # BASELINE config 3's size
LCPCOMP_ALGOS = ("lcpcomp(coder=huff)", "lcpcomp(coder=huff,comp=plcppeaks)")
LCPCOMP_SMALL = ("lcpcomp(coder=sle)", "encode(coder=sle)", "lcpcomp(coder=huff,textds=textds(isa=sparse_isa))",
                 "lcpcomp(coder=huff,comp=plcppeaks,textds=textds(lcp=compressed_lcp))")  # at 1 MiB
LCPCOMP_SWEEP = (16 << 10, 64 << 10, 256 << 10, MIB, 4 * MIB, 16 * MIB)  # behind LCPCOMP_MIN_N, _DEC_MIN_N
TRANSFORM_BYTES = 16 * MIB  # bench.py's 16 MiB shapes, for the transform chains
TRANSFORM_ALGOS = ("rle:mtf:encode(vbyte)", "bwt:rle:mtf:encode(huff)")
RLE_MTF_RATIO_1MIB = 103.24  # BENCH_r05's rle_mtf_vbyte_1MB_english ratio_pct (bench.py:322-324)
TRANSFORM_IDS = ("noop", "rle", "mtf", "bwt", "bwt(textds=textds(isa=sparse_isa))",
                 "bwt(textds=textds(lcp=compressed_lcp))", "chain(bwt, chain(rle, chain(mtf, encode(huff))))",
                 *(f"lzss(coder={c})" for c in ("ascii", "bit", "gamma", "delta")),
                 *(f"repair(coder={c})" for c in ("ascii", "bit", "gamma", "delta", "huff")))
# repair's build is quadratic in practice: 108.6 s at 1 MiB of the English
# text, 4.7 s at 256 KiB, on the port's host path (one CPU run, not on the
# card's host), so phase 17 runs its ids on a prefix
REPAIR_BYTES = 128 << 10
# the host-only lzss ids decode a factor at a time in Python (1.6-5.8 s at 1
# MiB of English on the card's host, PR 13): phase 17 runs them on a prefix
LZSS_IDS_BYTES = 256 << 10
# the stages before mtf in an id: the input kernel J sees is their output
MTF_FEED = {"mtf": None, "rle:mtf:encode(vbyte)": "rle", "bwt:rle:mtf:encode(huff)": "bwt:rle",
            "chain(bwt, chain(rle, chain(mtf, encode(huff))))": "bwt:rle"}
TRANSFORM_SWEEP = tuple(k << 10 for k in (4, 8, 16, 32, 64, 256, 1024, 4096, 16384))  # behind RLE_MIN_N, MTF_MIN_N
MTF_CHUNKS = (1024, 2048, 4096, 8192)  # kernel J's chunk sizes timed in phase 16
# phase 18's ids of the suffix-tree families -> bytes of synth_english (seed
# 7) they run on: 1 MiB for lz78u, 256 KiB + 1 for the host strategies of
# lfs_comp and lfs2 (3-9 s each at 1 MiB, PR 15; the sentinel makes it 256
# KiB + 2 for TextDS, past device.SA_MIN_N whichever length the gate were
# to see)
TAIL_ALGOS = {"lz78u": MIB, "lfs_comp(computing_strat=st)": (256 << 10) + 1,
              "lfs_comp(computing_strat=sim_st)": (256 << 10) + 1,
              "lfs_comp": (256 << 10) + 1, "lfs2": (256 << 10) + 1}
# each family's two StatPhase spans: the one that builds the suffix stack
# (Construct SA/ISA/LCP inside it) and the rules or the tree, and the one
# that codes (lz78u's factorization walk codes as it goes)
TAIL_SPANS = {"lz78u": ("construct suffix tree", "factorize"), "lfs_comp": ("computing lrfs", "encoding input"),
              "lfs2": ("Computing LRF", "Encoding Comp")}
SUFFIX_STACK_SPANS = ("Construct SA", "Construct ISA", "Construct LCP Array")
TAIL_SMALL = 4 << 10  # every new id on 4 KiB of English
NESTED_SMALL = ("blockwise(blockwise(encode(huff),bs=1000),bs=3000)",
                "blockwise(blockwise(encode(huff),bs=1000,shared=1),bs=3000)",
                "blockwise(blockwise(lzw(coder=bit),bs=1000),bs=3000)")
NESTED_ALGO = "blockwise(blockwise(encode(huff)),bs=4194304)"  # 16 inner blocks of 256 KiB an outer block
NESTED_BYTES = 64 * MIB
CLI_BYTES = 300 << 10  # phase 18's file for `python -m tudocomp_tpu_torch -a lz78u -s`: its SA on the card
GROUP_CASES = (("huff", False), ("huff", True), ("lzss", False), ("lzss", True))  # pod_compress's inner, shared
GROUP_KERNELS = {"huff shared=0": ("huffman_tables", "pack_blocks", "pack_bytes_blocks"),
                 "huff shared=1": ("huffman_tables64", "pack_blocks", "pack_bytes_blocks"),
                 "lzss shared=0": ("plcp_segments",), "lzss shared=1": ("plcp_segments",)}
POOL_ALGO = "blockwise(lz78u,bs=262144)"  # a host inner: the encode pool's processes, the decode pool's threads
POOL_BYTES = 4 * MIB  # 16 blocks
LZSS_WORKERS = (1, 2, 4, 8)  # threads of blockwise_lzss_compress timed in turns
DECODE_POOL_BYTES = 8 * MIB  # the lz78(coder=bit) containers the decode pool is timed on
PLAIN_BLOCKS = 32  # blocks of 256 KiB that kernel E's plain version is run on
# bytes of a block of 256 KiB or more that the plain versions of E and F
# step through (a step a byte, ~0.2 ms a step on the card: 55 s for a whole
# 256 KiB row); the kernel runs again on those, and on the whole rows is
# held to the host parse
PLAIN_PREFIX = 1 << 16
LZW_BIG_BS = 4 * MIB  # phase 6 runs F on phase 8's blocks of 4 MiB too
GATE_BS = (1 * MIB, 2 * MIB, 4 * MIB, 8 * MIB)  # phase 8's block sizes for the parse gate
# phase 8's inputs of few blocks, (block size, blocks): where the card's
# parallel blocks stop paying for its longer chain per block
FEW_BLOCKS = ((8192, 1), (8192, 16), (8192, 128), (BS, 1), (BS, 2), (BS, 4), (BS, 8),
              *((bs, n) for bs in GATE_BS for n in (1, 2)))
HUFF_KERNELS = ("pack_blocks", "pack_bytes_blocks", "huffman_tables", "decode_payloads")
SHARED_KERNELS = ("huffman_tables64", "pack_blocks", "pack_bytes_blocks", "decode_payloads")
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
    "huffman_tables64": (
        "tudocomp_tpu_torch/csrc/tables.cu",
        "tudocomp_tpu/ops/pallas_kernels.py:100 (kernel C's int64 instance: the shared table, "
        "which the JAX package builds through :20)",
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
    "esp_adjust_windows": (
        "tudocomp_tpu_torch/csrc/esp.cu",
        "tudocomp_tpu/ops/esp_jax.py:87 (_sim_window under _adjust_dev; plain JAX there, no Pallas kernel: "
        "a kernel the port added)",
    ),
    "mtf_encode": (
        "tudocomp_tpu_torch/csrc/mtf.cu",
        "tudocomp_tpu/ops/transforms.py:23 (mtf_encode_device; plain JAX there, no Pallas kernel: "
        "a kernel the port added)",
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
    "pack_blocks": ("tile_widths_kernel<false>", "pack_tiles_kernel<false>"),
    "pack_bytes_blocks": ("tile_widths_kernel<true>", "pack_tiles_kernel<true>"),
    "huffman_tables": ("huffman_tables_kernel<int>",),
    "huffman_tables64": ("huffman_tables_kernel<long>",),
    "moffat_phase12": ("moffat_phase12_kernel",),
    "decode_payloads": ("decode_kernel",),
    "lz78_parse": ("lz78_kernel",),
    "lzw_parse": ("lzw_kernel",),
    "plcp_segments": ("phi_kernel", "plcp_upper_kernel", "plcp_level_kernel"),
    "esp_adjust_windows": ("esp_adjust_staged_kernel",),
    "mtf_encode": ("mtf_last_kernel", "mtf_entry_kernel", "mtf_walkers_kernel"),
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
# the names of kernels A's and B's __global__ functions before their
# one-store-a-word tiles (a tile-sum pass and an atomicOr scatter), of
# kernel C's before its two instances, of kernel I's before its persistent
# grid and of J3 before its walkers, so that --dh times a checkout of
# either design
OLD_DEVICE_FNS = {
    "huffman_tables": ("huffman_tables_kernel",),
    "pack_blocks": ("tile_sums_kernel<false>", "scatter_kernel<false>"),
    "pack_bytes_blocks": ("tile_sums_kernel<true>", "scatter_kernel<true>"),
    "esp_adjust_windows": ("esp_adjust_kernel",),
    "mtf_encode": ("mtf_walk_kernel",),
}


def emit(obj) -> None:
    """Print obj as one JSON line; a phase's line also carries t_s, the
    seconds since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
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


GATES = ("TDC_DEVICE_HUFF", "TDC_DEVICE_LZ78", "TDC_DEVICE_SA", "TDC_DEVICE_LZSS", "TDC_DEVICE_ESP",
         "TDC_DEVICE_LCPCOMP", "TDC_DEVICE_RLE", "TDC_DEVICE_MTF")


def dna_bytes(n: int):
    """A seeded 4-letter DNA-like text (uniform A, C, G, T)."""
    import numpy as np

    return np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(7).integers(0, 4, n)]


def edge_histograms():
    """Phase 2's edge rows for kernel C, [7, 256] int32: no symbol, one, two,
    all 256 (counts 1..256), Fibonacci counts (codes of 30 bits), all 256
    with equal counts, and all 256 with counts of 1-3 (many ties)."""
    import numpy as np

    edge = np.zeros((7, 256), np.int32)
    edge[1, 65] = 7
    edge[2, [3, 200]] = [5, 9]
    edge[3] = np.arange(1, 257)
    fib = [1, 1]
    while len(fib) < 31:
        fib.append(fib[-1] + fib[-2])
    edge[4, :31] = fib
    edge[5] = 5
    edge[6] = np.random.default_rng(3).integers(1, 4, 256)
    return edge


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
    if name in ("huffman_tables", "huffman_tables64"):
        # per table of m symbols: a sort of the 256 keys (256 x 8 compares),
        # Moffat's 2 (m - 2) picks, each internal node's parent and depth
        # (~16 a node), the scans and the outputs (~4 a symbol)
        m = (args[0] > 0).sum(1).to(torch.int64)
        return int((256 * 8 + 2 * (m - 2).clamp(min=0) + 16 * (m - 1).clamp(min=0) + 4 * 256).sum())
    if name == "decode_payloads":  # per stream bit: a shift and a compare per length tried
        return 3 * int(args[1].to(torch.int64).sum())
    if name in ("lz78_parse", "lzw_parse"):  # per byte: hash, probe, compare, insert
        return 10 * int(args[1].to(torch.int64).sum())
    if name == "moffat_phase12":  # per step of the chain: two reads, compares, writes
        return 16 * int((args[1].to(torch.int64) - 2).clamp(min=0).sum())
    if name == "plcp_segments":  # per position: a phi read, ~2 byte compares, a store
        return 8 * args[0].numel()
    if name == "esp_adjust_windows":  # per span block: ~3 queue steps of ~10 compares and moves
        return 30 * span_blocks(args)
    if name == "mtf_encode":  # per byte: the search for its rank, the shift, the last-position update
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
    if name == "esp_adjust_windows":  # the spans' (len, type) pairs read and written, their ws, we and ns
        return 16 * span_blocks(args) + 8 * int(args[4][0]) + 4
    if name == "probe3_gather":  # idx read, out written, the words of S that idx names read once
        S, idx = args
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None] * S.shape[1]
        return nbytes(idx) + nbytes(out) + 4 * int(torch.unique(idx.to(torch.int64) + rows).numel())
    return nbytes(args) + nbytes(out)


def span_blocks(args) -> int:
    """Blocks in the live spans of kernel I's arguments (lens, typs, ws, we, ns)."""
    ws, we, ns = args[2:]
    k = int(ns[0])
    return int((we[:k] - ws[:k]).sum())


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


def device_time(fn, name, iters: int = 10, fns=None) -> dict:
    """Device ms a call of fn() spends in the kernels of counter `name`
    (DEVICE_FNS, or the names `fns`; name None: in every kernel it runs), from torch.profiler's
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

    fns = fns or (DEVICE_FNS[name] if name else None)
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


def huff_batch(dev):
    """Phase 2's batch: 64 x 256 KiB of zipf(1.3) bytes on the card, its
    n_valid and its per-block tables (kernel C)."""
    import torch

    from tudocomp_tpu_torch.ops import huffman_torch as ht
    from tudocomp_tpu_torch.ops import table_kernels as tk

    blocks = torch.from_numpy(zipf_bytes(0, BENCH_BLOCKS * BS).reshape(BENCH_BLOCKS, BS)).to(dev)
    n_valid = torch.full((BENCH_BLOCKS,), BS, dtype=torch.int32, device=dev)
    return blocks, n_valid, tk.huffman_tables(ht.block_histograms(blocks, n_valid))


def pack_args(dev, blocks, n_valid, tabs):
    """Kernel A's and B's arguments on the Huffman path of `blocks` with
    tables `tabs`: the header tokens (A), then the fused lookup and pack
    after the headers into arenas of 9 bits a byte (B), as
    ops/huffman_torch.py and parallel/runtime.py make them."""
    import torch

    from tudocomp_tpu_torch.ops import bitpack_cuda as bc
    from tudocomp_tpu_torch.ops import huffman_torch as ht

    tv, tb = ht.huffman_table_tokens(tabs.numl, tabs.ordered_sym, tabs.sigma, tabs.longest)
    normal = (tabs.sigma >= 2)[:, None]
    tbl_v = torch.where(normal, tabs.cw, torch.arange(256, dtype=torch.int32, device=dev))
    tbl_nb = torch.where(normal, tabs.lengths, 8)
    hdr_w, hdr_b = bc.pack_blocks_plain(tv, tb, ht.N_TABLE_TOKENS)
    n_words = (9 * blocks.shape[1] + 4096 + 31) // 32
    return (tv, tb, ht.N_TABLE_TOKENS), (blocks, n_valid, tbl_v, tbl_nb, hdr_w, hdr_b, n_words)


def pack_edge_errs(dev) -> dict:
    """Kernels A and B against their plain versions on the card on the
    tile-boundary cases of tests/torch_cases.py (the shared table's expanded
    to its batch), each into arenas of random words: "A name" / "B name" ->
    max_abs_err."""
    import numpy as np
    import torch

    from tests import torch_cases
    from tudocomp_tpu_torch.ops import bitpack_cuda as bc

    def i32(a):
        return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)

    def garbage():  # freed at once: the arenas' torch.empty may get these words
        torch.randint(-(1 << 31), 1 << 31, (1 << 22,), dtype=torch.int32, device=dev)

    out = {}
    for name, (v, nb, n_words) in torch_cases.pack_edge_cases().items():
        args = (i32(v), i32(nb), n_words)
        garbage()
        out[f"A {name}"] = max_abs_err(bc.pack_blocks(*args), bc.pack_blocks_plain(*args))
    for name, (blk, nv, tv, tb, hw, hb, n_words) in torch_cases.pack_bytes_edge_cases().items():
        rows = [i32(x) for x in (tv, tb, hw, hb)]
        if tv.shape[0] != blk.shape[0]:
            rows = [x.expand(blk.shape[0], *x.shape[1:]) for x in rows]
        args = (torch.from_numpy(blk).to(dev), torch.from_numpy(nv).to(dev), *rows, n_words)
        garbage()
        out[f"B {name}"] = max_abs_err(bc.pack_bytes_blocks(*args), bc.pack_bytes_blocks_plain(*args))
    return out


def pack_timing(dev) -> dict:
    """Kernels A and B at phase 2's shapes (the headers of 64 x 256 KiB of
    zipf(1.3), then its fused encode), each held to its plain version:
    wrapper ms (CUDA events) and device ms (torch.profiler) of their
    __global__ functions under either design's names."""
    from tudocomp_tpu_torch.ops import bitpack_cuda as bc

    a_args, b_args = pack_args(dev, *huff_batch(dev))
    out = {}
    for name, args, kernel, plain in (("pack_blocks", a_args, bc.pack_blocks, bc.pack_blocks_plain),
                                      ("pack_bytes_blocks", b_args, bc.pack_bytes_blocks,
                                       bc.pack_bytes_blocks_plain)):
        if max_abs_err(kernel(*args), plain(*args)) != 0:
            raise AssertionError(f"{name} differs from its plain version")
        out[name] = {"ms": cuda_ms(lambda: kernel(*args), max_iters=200),
                     **device_time(lambda: kernel(*args), name, iters=20,
                                   fns=DEVICE_FNS[name] + OLD_DEVICE_FNS[name])}
    return out


def table_timing(dev) -> dict:
    """Kernel C (int32) on phase 2's histograms, and kernel G and the
    shared table's stage (ht.shared_tables: kernel C's int64 instance, or
    before it _sort_hist, G, _phase3 and canonical_codes_batch) on the
    summed row of its 64 blocks, each held to its plain version: wrapper ms
    (CUDA events), device ms (torch.profiler, under either design's
    __global__ names; for the stage every kernel it runs), and the stage's
    host ms, the card synchronized after each call (median and least of
    50)."""
    import torch

    from tudocomp_tpu_torch.ops import huffman_torch as ht
    from tudocomp_tpu_torch.ops import table_kernels as tk

    blocks, n_valid, _ = huff_batch(dev)
    hists = torch.cat([ht.block_histograms(blocks, n_valid), torch.from_numpy(edge_histograms()).to(dev)])
    total = hists[:BENCH_BLOCKS].sum(0, dtype=torch.int64)
    args = ht._sort_hist(total[None])[:2]
    if max_abs_err(tuple(tk.huffman_tables(hists)), tuple(tk.huffman_tables_plain(hists))):
        raise AssertionError("kernel C differs from its plain version")
    if max_abs_err(tk.moffat_phase12(*args), tk.moffat_phase12_plain(*args)):
        raise AssertionError("kernel G differs from its plain version")
    if max_abs_err(tuple(ht.shared_tables(total)), tuple(tk.huffman_tables_plain(total[None]))):
        raise AssertionError("the shared table differs from the plain chain's")
    c_fns = DEVICE_FNS["huffman_tables"] + OLD_DEVICE_FNS["huffman_tables"]
    stage = []
    for _ in range(50):
        stage.append(synced(lambda: ht.shared_tables(total))[1] * 1e3)
    stage.sort()
    return {
        "huffman_tables": {"rows": hists.shape[0], "ms": cuda_ms(lambda: tk.huffman_tables(hists), max_iters=200),
                           **device_time(lambda: tk.huffman_tables(hists), None, iters=20, fns=c_fns)},
        "moffat_phase12": {"ms": cuda_ms(lambda: tk.moffat_phase12(*args), max_iters=200),
                           **device_time(lambda: tk.moffat_phase12(*args), "moffat_phase12", iters=20)},
        "shared_tables": {"host_ms_median": stage[len(stage) // 2], "host_ms_least": stage[0],
                          "ms": cuda_ms(lambda: ht.shared_tables(total), max_iters=200),
                          "call_device_ms": device_time(lambda: ht.shared_tables(total), None, iters=20)["device_ms"],
                          **({"huffman_tables64": device_time(lambda: ht.shared_tables(total), "huffman_tables64",
                                                              iters=20)} if hasattr(tk, "huffman_tables64") else {})},
    }


def pack_host_split(name: str, args) -> dict:
    """Host microseconds of the parts of a kernel A or B wrapper call
    (`name` pack_blocks or pack_bytes_blocks, `args` its arguments): the
    whole wrapper (it waits for the card), its checks, casts and
    allocations (launch_args_a / launch_args_b), the allocations alone, the
    flagged launch (flag zeroed, kernels queued, stream wait, flag read),
    the launch alone and the stream wait alone."""
    import torch

    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.ops import bitpack_cuda as bc

    if name == "pack_blocks":
        wrapper, prep, fn, scratch = bc.pack_blocks, bc.launch_args_a, "tdc_pack_blocks", 5
    else:
        wrapper, prep, fn, scratch = bc.pack_bytes_blocks, bc.launch_args_b, "tdc_pack_bytes_blocks", 13
    largs = prep(*args)
    dev = largs[-1].get_device()
    shapes = [tuple(t.shape) for t in (largs[scratch], largs[-2], largs[-1]) if t is not None]
    flag = kernels._flag(dev)[1]
    wait = kernels.helper("tdc_stream_wait")

    def alloc():
        return [torch.empty(shape, dtype=torch.int32, device=largs[-1].device) for shape in shapes]

    return {
        "wrapper, waits for the card": host_us(lambda: wrapper(*args), 500),
        "checks, casts and allocations": host_us(lambda: prep(*args)),
        f"allocations: {len(shapes)} torch.empty": host_us(alloc),
        "kernels.launch_flagged: flag zeroed, launch, stream wait, flag read": host_us(
            lambda: kernels.launch_flagged(fn, *largs), 500),
        "kernels.launch alone: the kernels queued, no wait": host_us(lambda: kernels.launch(fn, *largs, flag), 200),
        "tdc_stream_wait on an idle stream": host_us(lambda: wait(kernels._stream(dev))),
    }


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
    """Kernels A-J and P7 alone, from the package first on sys.path: J on
    phase 16's four 16 MiB inputs (j_timing) and I on each device round of
    phase 12's 16 MiB grammar (i_timing), first; C, G
    and the shared table's stage (table_timing); A and B at phase 2's
    shapes (pack_timing); D
    on the 1024 x 16 KiB zipf(1.3) streams of phase 2 and the 256 x 256 KiB
    streams of phase 3's input, each held to its input; H on the 16 MiB
    English and DNA texts and a 256 KiB English block, each held to the
    host's PLCP; the lcp_device stage of phase 10's two repetitive 16 MiB
    texts (host seconds, best of 3, the LCP held to the host's); phase
    3's 64 MiB encode through the driver (encode_timing); F at
    [6400, 8192] and in blocks of 1 and 4 MiB, E at [6400, 8192] and
    [200, 262144] (parse_timing), and P7 at each level (p7_timing)."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch import probes
    from tudocomp_tpu_torch.ds import suffix_array as sa_mod
    from tudocomp_tpu_torch.ds.suffix_array import suffix_array_device
    from tudocomp_tpu_torch.ops import huffman_decode_cuda as hd
    from tudocomp_tpu_torch.ops import plcp_torch

    mtf, esp = j_timing(dev), i_timing(dev)  # first: late in a long process the profiler drops events
    torch.cuda.empty_cache()
    tables = table_timing(dev)
    pack = pack_timing(dev)
    torch.cuda.empty_cache()
    dec = {}
    data = np.concatenate([zipf_bytes(2, ROUNDTRIP_BYTES - TEXT_BYTES), text_bytes(TEXT_BYTES)]).tobytes()
    encode = encode_timing(data)
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
    return {"phase": "kernels A-J and P7", "package": package, "mtf_encode": mtf, "esp_adjust_windows": esp,
            "tables": tables, "encode": encode, **pack,
            "decode": dec, "plcp": h,
            "lcp_device_stage_best_of_3_s": stage, "lzw_parse": f, "lz78_parse": e, "probe7_pack": p7,
            "card": gpu}


def j_timing(dev) -> dict:
    """Kernel J on phase 16's four 16 MiB inputs, each held to the host's
    tdc_mtf_encode: wrapper ms (CUDA events) and device ms by __global__
    function (torch.profiler, under either design's names)."""
    import numpy as np

    from tudocomp_tpu_torch.ops.mtf_cuda import mtf_encode_chunks
    from tudocomp_tpu_torch.ops.transforms_torch import upload

    fns = DEVICE_FNS["mtf_encode"] + OLD_DEVICE_FNS["mtf_encode"]
    out = {}
    for which, arr in transform_inputs(english_bytes(TRANSFORM_BYTES)).items():
        arr = np.ascontiguousarray(arr)
        x = upload(arr, dev)
        if not np.array_equal(mtf_encode_chunks(x).cpu().numpy(), host_mtf(arr)[0]):
            raise AssertionError(f"kernel J differs from tdc_mtf_encode on {which}")
        out[which] = {"ms": cuda_ms(lambda: mtf_encode_chunks(x)),
                      **device_time(lambda: mtf_encode_chunks(x), None, iters=10, fns=fns)}
        del x
    return out


def i_timing(dev) -> list:
    """Kernel I on each device round of phase 12's 16 MiB grammar, each held
    to its plain version: the spans, wrapper ms (CUDA events around the
    kernel alone, fresh copies made outside them) and device ms
    (torch.profiler, under either design's names)."""
    from tudocomp_tpu_torch.ops.esp_kernels import esp_adjust_windows, esp_adjust_windows_plain

    fns = DEVICE_FNS["esp_adjust_windows"] + OLD_DEVICE_FNS["esp_adjust_windows"]
    rounds = []
    for size, _nb, spans, fresh in esp_rounds(english_bytes(ESP_BYTES), dev):
        got, plain = fresh(), fresh()
        esp_adjust_windows(*got)
        esp_adjust_windows_plain(*plain)
        if max_abs_err(got[:2], plain[:2]):
            raise AssertionError(f"kernel I differs from its plain version in the round of size {size}")
        rounds.append({"size": size, "spans": int(spans[2][0]), "ms": fresh_event_ms(esp_adjust_windows, fresh),
                       **device_time(lambda: esp_adjust_windows(*fresh()), None, fns=fns)})
    return rounds


def encode_timing(data: bytes) -> dict:
    """Phase 3's 64 MiB input through driver.compress(device="cuda"),
    per-block and shared=1: after one encode of each (checked to decode to
    the input), three warm encodes each in turns (per-block, shared,
    shared, per-block, per-block, shared), host seconds, the card
    synchronized after each; and each container's sha256, which two
    checkouts of the same format share."""
    import hashlib

    from tudocomp_tpu_torch.driver import compress, decompress

    out = {}
    for algo in (ALGO, SHARED_ALGO):
        c = compress(algo, data, device="cuda")
        if decompress(c, device="cuda") != data:
            raise AssertionError(f"{algo}: roundtrip differs from the input")
        out[algo] = {"encode_s": [], "sha256": hashlib.sha256(c).hexdigest()}
    for algo in (ALGO, SHARED_ALGO, SHARED_ALGO, ALGO, ALGO, SHARED_ALGO):
        c, sec = synced(lambda: compress(algo, data, device="cuda"))
        if hashlib.sha256(c).hexdigest() != out[algo]["sha256"]:
            raise AssertionError(f"{algo}: a warm encode gave another container")
        out[algo]["encode_s"].append(sec)
    return out


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
    for var in GATES:
        os.environ.pop(var, None)
    # phases 1-18 run host blocks one after another, as they were measured;
    # phase 19 sets TDC_BLOCKWISE_PROCS itself
    os.environ["TDC_BLOCKWISE_PROCS"] = "0"

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
    batch = zipf_bytes(0, BENCH_BLOCKS * BS).reshape(BENCH_BLOCKS, BS)
    blocks = torch.from_numpy(batch).to(dev)
    n_valid = torch.full((BENCH_BLOCKS,), BS, dtype=torch.int32, device=dev)
    hists = ht.block_histograms(blocks, n_valid)
    hists_all = torch.cat([hists, torch.from_numpy(edge_histograms()).to(dev)])

    errs, cases = {}, {}
    tabs = tk.huffman_tables(hists_all)
    want = tk.huffman_tables_plain(hists_all)
    errs["huffman_tables"] = max_abs_err(tuple(tabs), tuple(want))
    if int(tabs.longest.max()) < 28:
        raise AssertionError("the edge histograms gave no code of 28 bits or more")
    cases["huffman_tables"] = ((hists_all,), tk.huffman_tables, tk.huffman_tables_plain)

    t = tk.HuffmanTables(*(x[:BENCH_BLOCKS] for x in tabs))
    a_args, b_args = pack_args(dev, blocks, n_valid, t)
    rng = np.random.default_rng(1)
    rand_nb = torch.from_numpy(rng.integers(0, 33, (64, 65536)).astype(np.int32)).to(dev)
    rand_v = torch.from_numpy(rng.integers(0, 1 << 32, (64, 65536)).astype(np.uint32).view(np.int32)).to(dev)
    a_err = 0
    for args in (a_args, (rand_v, rand_nb, 20000)):  # the second drops bits
        a_err = max(a_err, max_abs_err(bc.pack_blocks(*args), bc.pack_blocks_plain(*args)))
    errs["pack_blocks"] = a_err
    cases["pack_blocks"] = (a_args, bc.pack_blocks, bc.pack_blocks_plain)
    errs["pack_bytes_blocks"] = max_abs_err(bc.pack_bytes_blocks(*b_args), bc.pack_bytes_blocks_plain(*b_args))
    cases["pack_bytes_blocks"] = (b_args, bc.pack_bytes_blocks, bc.pack_bytes_blocks_plain)
    edge_errs = pack_edge_errs(dev)
    for name, key in (("pack_blocks", "A "), ("pack_bytes_blocks", "B ")):
        errs[name] = max(errs[name], *(e for c, e in edge_errs.items() if c.startswith(key)))

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
          "pack_edge_cases_max_abs_err": edge_errs, "decode_max_sync_rounds": d_rounds, "card": gpu})

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
    for name in ("pack_blocks", "pack_bytes_blocks"):
        timing[name]["host_us"] = pack_host_split(name, cases[name][0])
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
    for table, new in zip((errs, timing, launches), shared_phase(data, hists_all, dev, gpu)):
        table.update(new)
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
    del text
    torch.cuda.empty_cache()

    # 12-13. ESP: kernel I, the ids through the driver, the stages and the gate
    english = english_bytes(ESP_BYTES)
    for table, new in zip((errs, timing), esp_kernel_phase(english, dev, gpu)):
        table.update(new)
    launches["esp_adjust_windows"] = esp_roundtrip_phase(english, dev, gpu)
    torch.cuda.empty_cache()

    # 14-15. lcpcomp: the ids through the driver, the stages and the gates
    launches_lcp = lcpcomp_roundtrip_phase(english, gpu)
    launches["plcp_segments"] += launches_lcp
    timing["plcp_segments"]["launches_by_shape"]["lcpcomp 16 MiB"] = launches_lcp
    lcpcomp_stages_phase(english, dev, gpu)
    torch.cuda.empty_cache()

    # 16-17. the transforms: kernel J, the ids through the driver, the stages and the gates
    for table, new in zip((errs, timing), transforms_kernel_phase(english, dev, gpu)):
        table.update(new)
    launches["mtf_encode"] = transforms_roundtrip_phase(english, dev, gpu)
    del english
    torch.cuda.empty_cache()

    # 18. the matrix tail: lz78u, lfs_comp, lfs2, the nested blockwise, the CLI
    launches_h, launches_nested = matrix_tail_phase(gpu)
    launches["plcp_segments"] += launches_h
    timing["plcp_segments"]["launches_by_shape"]["matrix tail"] = launches_h
    for name, n in launches_nested.items():
        timing[name]["launches_nested_blockwise"] = n

    # 19. two gloo ranks on the card, the blockwise pools
    for name, n in group_phase(gpu).items():
        timing[name]["launches_two_ranks"] = n

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
        tables, st["one table (kernel C, int64)"] = synced(lambda: ht.shared_tables(total))
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


def shared_phase(data: bytes, hists71, dev, gpu):
    """Phase 5: kernel C's int64 instance and kernel G against their plain
    versions on three inputs, the instance's flag on a row whose code needs
    33 bits, the 64 MiB shared-table roundtrip on the card and through the
    host decoder, the 16 MiB prefix against the port's CPU run, both
    kernels' times, and the warm end-to-end rates with and without shared.
    Returns ({kernel: max_abs_err}, {kernel: line entries}, {kernel:
    launches in the roundtrip}) for huffman_tables64 and moffat_phase12."""
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
        "phase 2's [71, 256]": hists71.to(torch.int64),
        "past 2^31 [1, 256]": total[None] * 1024,
    }
    if int(cases["past 2^31 [1, 256]"].max()) < 1 << 31:
        raise AssertionError("the third row has no weight past 2^31")
    report, errs = {}, {"huffman_tables64": 0, "moffat_phase12": 0}
    for name, hists in cases.items():
        args = ht._sort_hist(hists)[:2]
        e_g = max_abs_err(tk.moffat_phase12(*args), tk.moffat_phase12_plain(*args))
        e_c = max_abs_err(tuple(tk.huffman_tables64(hists)), tuple(tk.huffman_tables_plain(hists)))
        errs = {"huffman_tables64": max(errs["huffman_tables64"], e_c), "moffat_phase12": max(errs["moffat_phase12"], e_g)}
        report[name] = {"max_abs_err": {"huffman_tables64": e_c, "moffat_phase12": e_g},
                        "max_weight": int(args[0].max()), "sigma": int(args[1].max())}
    if any(errs.values()):
        raise AssertionError(f"kernel C's int64 instance or kernel G differs from its plain version: {report}")
    deep = torch.zeros((1, 256), dtype=torch.int64, device=dev)
    fib = [1, 1]
    while len(fib) < 34:
        fib.append(fib[-1] + fib[-2])
    deep[0, :34] = torch.tensor(fib)  # a caterpillar tree: codes of 33 bits
    try:
        tk.huffman_tables64(deep)
        raise AssertionError("the int64 instance took a row whose code needs 33 bits")
    except ValueError as e:
        if "33-bit codes" not in str(e):
            raise
        report["33-bit row"] = str(e)
    summed = cases["summed [1, 256]"]
    args = ht._sort_hist(summed)[:2]
    lines = {
        "huffman_tables64": {
            "ms": cuda_ms(lambda: tk.huffman_tables64(summed)),
            **device_time(lambda: tk.huffman_tables64(summed), "huffman_tables64"),
            "plain_ms": cuda_ms(lambda: tk.huffman_tables_plain(summed), budget_ms=2000.0, max_iters=10),
            **bound("huffman_tables64", (summed,), tuple(tk.huffman_tables64(summed)))},
        "moffat_phase12": {
            "ms": cuda_ms(lambda: tk.moffat_phase12(*args)),
            **device_time(lambda: tk.moffat_phase12(*args), "moffat_phase12"),
            "plain_ms": cuda_ms(lambda: tk.moffat_phase12_plain(*args), budget_ms=2000.0, max_iters=10),
            **bound("moffat_phase12", args, tk.moffat_phase12(*args))},
    }

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
    if launches["huffman_tables64"] != 1 or launches["moffat_phase12"] or launches["huffman_tables"]:
        raise AssertionError(f"shared: the table took other launches than one of the int64 instance: {launches}")
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
    emit({"phase": "shared", "tables": report, "kernels": lines, "encode_stages": stages,
          "launches": launches, "bytes": len(data), "container_bytes": len(container),
          "ratio": len(container) / len(data), "first_encode_s": enc_s, "first_decode_s": dec_s,
          "host_decode_s": host_dec_s, "input_to_card_s": h2d_s,
          "prefix_bytes": len(prefix), "prefix_cpu_encode_s": cpu_s, "warm": rates, "card": gpu})
    return errs, lines, {k: launches[k] for k in lines}


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
    # F at phase 8's 4 MiB blocks: all blocks against the host parse, the
    # plain version on the first two blocks' first PLAIN_PREFIX bytes
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
        k = 2 if blocks.shape[1] == LZW_BIG_BS else min(PLAIN_BLOCKS, len(blocks)) if blocks.shape[1] == BS \
            else len(blocks)
        if blocks.shape[1] >= BS:  # the plain version on a prefix of the first k blocks
            pre = nv[:k].clamp(max=PLAIN_PREFIX)
            want, plain_ms = cuda_once(lambda: plain(b[:k], pre))
            err = max_abs_err(kernel(b[:k], pre), want)
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
        report[name] = {"ms": ms, "plain_ms": plain_ms, "plain_blocks": k,
                        "plain_prefix": PLAIN_PREFIX if blocks.shape[1] >= BS else None, "factors": int(got[-1].sum()),
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
                "plain_prefix": PLAIN_PREFIX if blocks.shape[1] >= BS else None, "longest_block_factors": longest, "ms_per_factor": ms / longest}
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
        if FULL:
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
        for kind in ("lz78", "lzw") if FULL else ():
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
            few.setdefault(f"{kind} {n} x {bs}", {})["gate_takes_device"] = tdev.use_parse_device(bs, n, dev)
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
    for n in (1 << 14, 1 << 16, 1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 22) if FULL else ():
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
    for which, data in inputs.items() if FULL else ():
        with host_path():
            host = lzss_stages(data, "cpu")
        stages[which] = {"card": lzss_stages(data, "cuda"), "host": host}
        torch.cuda.empty_cache()
    emit({"phase": "lzss stages", "algo": LZSS_ALGO, "bytes": LZSS_BYTES, "stages": stages,
          "kernel_H_launches_by_shape": launches_h, "card": gpu})
    return launches_h


def padded_input(data, dev):
    """data (uint8) as the first ESP round's int32 [size] on the card, its
    padded size and the round's length and alphabet, as esp_grammar_device
    starts."""
    import torch

    from tudocomp_tpu_torch.ops.esp_torch import padded

    size = 1 << (len(data) - 1).bit_length()
    scalar = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)  # noqa: E731
    return padded(data, size, dev), size, scalar(len(data)), scalar(256)


def fresh_event_ms(fn, fresh, iters: int = 20) -> float:
    """CUDA-event ms of fn(*fresh()) for a function that works in place:
    the events enclose fn alone, each call on fresh copies made before its
    first event; the mean over iters calls."""
    import torch

    pairs = []
    for _ in range(iters):
        args = fresh()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(*args)
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def esp_rounds(english, dev):
    """The device rounds of esp_grammar_device on the first ESP_BYTES of
    `english` while they run on the card: for each, (size, nb, spans,
    fresh), spans adjust_spans's (ws, we, ns) and fresh() a fresh
    (lens, typs, ws, we, ns) for kernel I, which adjusts in place."""
    from tudocomp_tpu_torch.ops import esp_torch as et

    src, size, m, alphabet = padded_input(english[:ESP_BYTES], dev)
    while size // 2 >= ESP_THRESHOLDS[1]:
        lens, typs, nb = et.stage_blocks(src, m, alphabet)
        spans = et.adjust_spans(lens, nb)

        def fresh(lens=lens, typs=typs, spans=spans):
            return (lens.clone(), typs.clone(), *spans)

        yield size, nb, spans, fresh
        src, m, _rl, _rr, alphabet, overflow = et.round_body(src, m, alphabet)
        if bool(overflow):
            raise AssertionError(f"round of size {size} set its overflow flag")
        size //= 2


def staged_bytes(spans) -> int:
    """Bytes kernel I's warps stage (csrc/esp.cu: read into shared memory
    and written back, 16 a block), for the live spans of (ws, we, ns): a
    warp's 32 spans of at most SLOT blocks, in order, while their blocks
    stay within CAP; the others walk device memory."""
    import torch

    from tudocomp_tpu_torch.ops.esp_kernels import CAP, SLOT

    ws, we, ns = spans
    k = int(ns[0])
    w = (we[:k] - ws[:k]).to(torch.int64)
    narrow = torch.where(w <= SLOT, w, 0)
    pad = -k % 32
    incl = torch.cumsum(torch.cat([narrow, narrow.new_zeros(pad)]).view(-1, 32), 1).view(-1)[:k]
    return 16 * int(torch.where(incl <= CAP, narrow, 0).sum())


def esp_kernel_phase(english, dev, gpu):
    """Phase 12: kernel I against its plain version, exactly, on the spans of
    every device round of the 16 MiB input and on tests/torch_cases.py's
    edge spans; its times on each round. Returns (errs, timing) for the
    kernels line: the first round, the largest launch of the path."""
    import torch

    from tests import torch_cases
    from tudocomp_tpu_torch.ops.esp_kernels import esp_adjust_windows, esp_adjust_windows_plain

    name = "esp_adjust_windows"
    err, rounds = 0, []
    for size, nb, spans, fresh in esp_rounds(english, dev):
        got, plain = fresh(), fresh()
        esp_adjust_windows(*got)
        _, plain_ms = cuda_once(lambda: esp_adjust_windows_plain(*plain))
        e = max_abs_err(got[:2], plain[:2])
        err = max(err, e)
        widths = (spans[1] - spans[0])[: int(spans[2][0])]
        rounds.append({
            "size": size, "blocks": int(nb), "spans": int(spans[2][0]), "span_blocks": int(widths.sum()),
            "widest_span": int(widths.max()) if len(widths) else 0, "max_abs_err": e,
            "ms": fresh_event_ms(esp_adjust_windows, fresh),
            **device_time(lambda: esp_adjust_windows(*fresh()), name),
            "plain_ms": plain_ms, **bound(name, got, got[:2]), "staged_bytes": staged_bytes(spans),
        })
    edge = {}
    for case, args in torch_cases.esp_edge_spans(dev).items():
        got, plain = [a.clone() for a in args], [a.clone() for a in args]
        esp_adjust_windows(*got)
        esp_adjust_windows_plain(*plain)
        edge[case] = max_abs_err(got[:2], plain[:2])
    torch.cuda.synchronize()
    if err or any(edge.values()):
        raise AssertionError(f"kernel I differs from its plain version: rounds {err}, edge spans {edge}")
    emit({"phase": "esp kernel", "max_abs_err": err, "tolerance": 0, "edge_spans_max_abs_err": edge,
          "rounds": rounds, "card": gpu})
    keys = ("ms", "device_ms", "plain_ms", "bound_ms")
    line = {k: rounds[0][k] for k in (*keys, "device_events", "bound_by", "staged_bytes")}
    line["per_grammar"] = {k: sum(r[k] or 0.0 for r in rounds) for k in keys}
    line["shape"] = "the first round of the 16 MiB input (the largest launch); per_grammar sums the 9 rounds"
    return {name: err}, {name: line}


def phase_spans(fn) -> tuple:
    """fn() under a root StatPhase: the host seconds of each span it opens
    and the stats each logs, keyed by their path, and fn()'s result."""
    from tudocomp_tpu_torch.stats.phase import StatPhase

    with StatPhase("root") as root:
        out = fn()
    st = {}

    def walk(ph, path):
        for c in ph.children:
            key = f"{path}/{c.title}" if path else c.title
            st[key] = (c.time_end - c.time_start) / 1e3
            st.update({f"{key}: {k}": v for k, v in c.stats.items()})
            walk(c, key)

    walk(root, "")
    st["total"] = (root.time_end - root.time_start) / 1e3
    return st, out


def esp_stages(data: bytes, algo: str, device: str) -> tuple:
    """One driver.compress of `algo` on `data` on `device`: the host seconds
    of each span the encode opens (EspCompressor's "ESP Algorithm", whose
    device rounds end in a host sync, and "Encode SLP"; the sorted coder's
    and the succinct d_coding's steps inside it), and the container."""
    from tudocomp_tpu_torch.driver import compress

    return phase_spans(lambda: compress(algo, data, device=device))


def best_of(fn, reps: int):
    """fn()'s result and its least host seconds over reps runs."""
    best, out = float("inf"), None
    for _ in range(reps):
        out, t = synced(fn)
        best = min(best, t)
    return out, best


def esp_roundtrip_phase(english, dev, gpu) -> int:
    """Phase 13: the ESP ids through the driver on the card against the
    port's host path: 16 MiB for ESP_ALGOS, 1 MiB for the ids of bench.py's
    ESP cells (ratios held to BENCH_r05's); kernel I launched. Then the 16
    MiB encode's StatPhase spans on the card and on the host, the 1 MiB
    sorted encode's (the succinct coding's steps among them), the sweep
    behind device.ESP_MIN_N and the host-finish threshold. Returns kernel I's launches in the 16 MiB
    encodes."""
    import numpy as np

    from tudocomp_tpu_torch import device as tdev
    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.compressors.esp import generate_grammar
    from tudocomp_tpu_torch.driver import compress, decompress
    from tudocomp_tpu_torch.ops import esp_torch as et

    inputs = {ESP_BYTES: english[:ESP_BYTES].tobytes(), MIB: english_bytes(MIB).tobytes()}
    runs = [*((algo, ESP_BYTES) for algo in ESP_ALGOS), *((algo, MIB) for algo in ESP_RATIOS_1MIB)]
    launched_16 = 0
    for algo, n in runs:
        data = inputs[n]
        kernels.reset_counts()
        container, enc_s = synced(lambda: compress(algo, data, device="cuda"))
        launched = kernels.counts()["esp_adjust_windows"]
        on_card = tdev.use_esp_device(n, dev)
        if on_card and launched == 0:
            raise AssertionError(f"{algo} at {n} bytes: kernel I never launched")
        if n == ESP_BYTES:
            launched_16 += launched
        back, dec_s = synced(lambda: decompress(container, device="cuda"))
        if back != data:
            raise AssertionError(f"{algo} at {n} bytes: device roundtrip differs from the input")
        t0 = time.perf_counter()
        ref = ref_compress(algo, data)
        t1 = time.perf_counter()
        if container != ref:
            raise AssertionError(f"{algo} at {n} bytes: container differs from the host path's")
        if ref_decompress(container) != data:
            raise AssertionError(f"{algo} at {n} bytes: the host decode differs from the input")
        t2 = time.perf_counter()
        _, warm_s = synced(lambda: compress(algo, data, device="cuda"))
        ratio = round(100.0 * len(container) / n, 2)
        if n == MIB and ratio != ESP_RATIOS_1MIB[algo]:
            raise AssertionError(f"{algo} at 1 MiB: ratio {ratio}% against BENCH_r05's {ESP_RATIOS_1MIB[algo]}%")
        no_jax()
        emit({"phase": "esp roundtrip", "algo": algo, "bytes": n, "container_bytes": len(container),
              "ratio_pct": ratio, "rounds_on_card": on_card, "kernel_I_launches": launched,
              "first_encode_s": enc_s, "warm_encode_s": warm_s, "decode_s": dec_s,
              "encode_MBps": n / warm_s / 1e6, "decode_MBps": n / dec_s / 1e6,
              "host_reference_encode_s": t1 - t0, "host_reference_decode_s": t2 - t1, "card": gpu})
        del container, back, ref

    stages, sorted_1mib = {}, {}
    for algo in ESP_ALGOS if FULL else ():
        card_st, container = esp_stages(inputs[ESP_BYTES], algo, "cuda")
        with host_path():
            host_st, host_container = esp_stages(inputs[ESP_BYTES], algo, "cpu")
        if container != host_container:
            raise AssertionError(f"{algo}: the staged encode's container differs from the host path's")
        stages[algo] = {"card": card_st, "host": host_st}
    if FULL:
        sorted_1mib, container = esp_stages(inputs[MIB], "esp(slp_coder=sorted)", "cuda")
        if container != ref_compress("esp(slp_coder=sorted)", inputs[MIB]):
            raise AssertionError("esp(slp_coder=sorted): the staged 1 MiB container differs from the host path's")

    # the sweep behind ESP_MIN_N: device rounds (input up, rules back) against
    # the host rounds, on prefixes of the 16 MiB text
    sweep = {}
    for n in ESP_SWEEP if FULL else ():
        arr = np.frombuffer(inputs[ESP_BYTES][:n], np.uint8)
        reps = 3 if n <= 4 * MIB else 2
        dev_g, dev_s = best_of(lambda: et.esp_grammar_device(arr, device=dev), reps)
        host_g, host_s = best_of(lambda: generate_grammar(arr), reps)
        if not (np.array_equal(dev_g[0], host_g[0]) and dev_g[1:] == host_g[1:]):
            raise AssertionError(f"device grammar differs from the host's at {n} bytes")
        sweep[n] = {"device_s": dev_s, "host_s": host_s, "host_over_device": host_s / dev_s}
    arr = np.frombuffer(inputs[ESP_BYTES], np.uint8)
    want = generate_grammar(arr) if FULL else None
    thresholds = {}
    for t in ESP_THRESHOLDS if FULL else ():
        g, thresholds[t] = best_of(lambda: et.esp_grammar_device(arr, threshold=t, device=dev), 2)
        if not (np.array_equal(g[0], want[0]) and g[1:] == want[1:]):
            raise AssertionError(f"threshold {t}: the grammar differs from the host's")
    no_jax()
    emit({"phase": "esp stages", "bytes": ESP_BYTES, "stages": stages, "sorted_1MiB_stages": sorted_1mib,
          "gate_sweep_best_of_2_3": sweep, "threshold_s_best_of_2": thresholds,
          "gates": {"ESP_MIN_N": tdev.ESP_MIN_N}, "kernel_I_launches_16MiB": launched_16, "card": gpu})
    return launched_16


def with_dec(algo: str, dec: str) -> str:
    """The lcpcomp id `algo` with its decoder set to `dec`."""
    return f"{algo[:-1]},dec={dec})"


def lcpcomp_roundtrip_phase(english, gpu) -> int:
    """Phase 14: the lcpcomp ids through the driver on the card against the
    port's host path, at 16 MiB of English and of DNA, the gates as set and
    forced on; each container decoded under scan and compact on the card and
    on the host; then the 1 MiB ids. Returns kernel H's launches in the
    gated 16 MiB encodes."""
    from tudocomp_tpu_torch import device as tdev
    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.driver import compress, decompress

    inputs = {"synth_english": english[:LCPCOMP_BYTES].tobytes(), "dna": dna_bytes(LCPCOMP_BYTES).tobytes()}
    launched_h = 0
    for which, data in inputs.items():
        n = len(data) + 1  # the sentinel
        for algo in LCPCOMP_ALGOS:
            t0 = time.perf_counter()
            ref = ref_compress(algo, data)
            host_s = time.perf_counter() - t0
            kernels.reset_counts()
            container, enc_s = synced(lambda: compress(algo, data, device="cuda"))
            launched = kernels.counts()["plcp_segments"]
            if launched == 0:
                raise AssertionError(f"{algo} on {which}: kernel H never launched")
            launched_h += launched
            if container != ref:
                raise AssertionError(f"{algo} on {which}: container differs from the host path's")
            os.environ["TDC_DEVICE_LCPCOMP"] = "1"
            try:
                forced, forced_s = synced(lambda: compress(algo, data, device="cuda"))
                if forced != ref:
                    raise AssertionError(f"{algo} on {which}: the forced device stages' container differs")
                _, warm_s = synced(lambda: compress(algo, data, device="cuda"))
                dec_s = {}
                for dec in ("scan", "compact"):
                    back, dec_s[f"card {dec}"] = synced(
                        lambda: decompress(container, device="cuda", id_string=with_dec(algo, dec)))
                    if back != data:
                        raise AssertionError(f"{algo} on {which}: the card's decode ({dec}) differs from the input")
            finally:
                del os.environ["TDC_DEVICE_LCPCOMP"]
            for dec in ("scan", "compact"):
                t0 = time.perf_counter()
                with host_path():
                    back = decompress(container, device="cpu", id_string=with_dec(algo, dec))
                dec_s[f"host {dec}"] = time.perf_counter() - t0
                if back != data:
                    raise AssertionError(f"{algo} on {which}: the host decode ({dec}) differs from the input")
            no_jax()
            emit({"phase": "lcpcomp roundtrip", "algo": algo, "input": which, "bytes": len(data),
                  "container_bytes": len(container), "ratio_pct": 100.0 * len(container) / len(data),
                  "factorize_on_card": "plcppeaks" in algo and tdev.use_lcpcomp_device(n, tdev.resolve("cuda")),
                  "decode_on_card_when_gated": tdev.use_lcpcomp_decode_device(n, tdev.resolve("cuda")),
                  "kernel_H_launches": launched, "first_encode_s": enc_s, "forced_encode_s": forced_s,
                  "warm_forced_encode_s": warm_s, "decode_s": dec_s,
                  "encode_MBps": len(data) / warm_s / 1e6,
                  "decode_MBps": {k: len(data) / v / 1e6 for k, v in dec_s.items()},
                  "host_reference_encode_s": host_s, "card": gpu})
            del container, forced, back, ref
    small = english_bytes(MIB).tobytes()
    for algo in LCPCOMP_SMALL:
        ref = ref_compress(algo, small)
        container, enc_s = synced(lambda: compress(algo, small, device="cuda"))
        if container != ref:
            raise AssertionError(f"{algo} at 1 MiB: container differs from the host path's")
        back, dec_s = synced(lambda: decompress(container, device="cuda"))
        if back != small or ref_decompress(container) != small:
            raise AssertionError(f"{algo} at 1 MiB: a decode differs from the input")
        emit({"phase": "lcpcomp roundtrip", "algo": algo, "input": "synth_english", "bytes": MIB,
              "container_bytes": len(container), "ratio_pct": 100.0 * len(container) / MIB,
              "encode_s": enc_s, "decode_s": dec_s, "card": gpu})
    no_jax()
    return launched_h


def lcpcomp_stages_phase(english, dev, gpu) -> None:
    """Phase 15: the spans of a warm 16 MiB English encode and decode of
    each phase 14 id on the card and on the host, and the sweep behind the
    two lcpcomp gates."""
    import torch

    from tudocomp_tpu_torch import device as tdev
    from tudocomp_tpu_torch.driver import compress, decompress

    data = english[:LCPCOMP_BYTES].tobytes()
    stages = {}
    for algo in LCPCOMP_ALGOS if FULL else ():
        card_enc, container = phase_spans(lambda: compress(algo, data, device="cuda"))
        torch.cuda.synchronize()
        card_dec, back = phase_spans(lambda: decompress(container, device="cuda"))
        with host_path():
            host_enc, host_container = phase_spans(lambda: compress(algo, data, device="cpu"))
            host_dec, host_back = phase_spans(lambda: decompress(container, device="cpu"))
        if container != host_container or back != data or host_back != data:
            raise AssertionError(f"{algo}: the staged runs differ from the host path or the input")
        stages[algo] = {"card": {"encode": card_enc, "decode": card_dec},
                        "host": {"encode": host_enc, "decode": host_dec}}
        del container, host_container, back, host_back

    sweep = lcpcomp_sweep(english, dev) if FULL else {}
    no_jax()
    emit({"phase": "lcpcomp stages", "bytes": LCPCOMP_BYTES, "stages": stages, "gate_sweep_best_of_2_3": sweep,
          "gates": {"LCPCOMP_MIN_N": tdev.LCPCOMP_MIN_N, "LCPCOMP_DEC_MIN_N": tdev.LCPCOMP_DEC_MIN_N}, "card": gpu})


def lcpcomp_sweep(english, dev) -> dict:
    """The sweep behind device.LCPCOMP_MIN_N and LCPCOMP_DEC_MIN_N, on
    prefixes of the English text: each device stage against its host
    counterpart as LCPCompressor would take them."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch import native
    from tudocomp_tpu_torch.compressors.lcpcomp import arrays_factorize, plcppeaks_factorize, sort_and_flatten
    from tudocomp_tpu_torch.ds.textds import TextDS
    from tudocomp_tpu_torch.io.inout import Input
    from tudocomp_tpu_torch.io.restrict import InputRestrictions
    from tudocomp_tpu_torch.ops.lcpcomp_torch import plcppeaks_factorize_device, resolve_factors_device

    lib = native.get_lib()
    sweep = {}
    for n in LCPCOMP_SWEEP:
        text = Input(english[:n].tobytes()).with_restrictions(InputRestrictions((0,), True)).as_array()
        reps = 3 if n <= 4 * MIB else 2
        ds = TextDS(text, device=dev)
        arrays = ds.device_arrays()  # None where the host built the SA (below SA_MIN_N)
        sa_on_card = arrays is not None
        if not sa_on_card:
            arrays = tuple(torch.from_numpy(a).to(dev) for a in (ds.require_sa(), ds.require_isa(), ds.require_plcp()))
        sa, isa, plcp = (a.cpu().numpy() for a in arrays)
        got, dev_s = best_of(lambda: plcppeaks_factorize_device(*arrays, 5), reps)
        _, up_s = best_of(lambda: [torch.from_numpy(a).to(dev) for a in (sa, isa, plcp)], reps)
        _, down_s = best_of(lambda: (arrays[1].cpu(), arrays[2].cpu()), reps)
        want, host_s = best_of(lambda: plcppeaks_factorize(sa, isa, plcp, 5), reps)
        if not all(np.array_equal(g, np.asarray(w, np.int64)) for g, w in zip(got, (want.pos, want.src, want.len))):
            raise AssertionError(f"{n} bytes: the device plcppeaks factors differ from the host's")
        # the decode of the default strategy's factors, as the stream parse hands them over
        f = sort_and_flatten(arrays_factorize(sa, isa, ds.require_lcp(), 5), True)
        tgt, src, lens = (np.ascontiguousarray(a, np.uint32) for a in (f.pos, f.src, f.len))
        buffer = np.where(f.covered(len(text)), 0, text).astype(np.uint8)
        fresh = [buffer.copy() for _ in range(reps)]
        host_dec_s = float("inf")
        for b in fresh:
            t0 = time.perf_counter()
            rc = lib.tdc_lcpcomp_scan_decode(b, len(b), tgt, src, lens, len(tgt), 6)
            host_dec_s = min(host_dec_s, time.perf_counter() - t0)
            if rc != 0 or not np.array_equal(b, text):
                raise AssertionError(f"{n} bytes: the host scan decode differs from the text")
        out, dev_dec_s = best_of(lambda: resolve_factors_device(buffer, tgt, src, lens, dev), reps)
        if not np.array_equal(out, text):
            raise AssertionError(f"{n} bytes: the device chain resolution differs from the text")
        # the compressor's two sides: where the card built the SA, the host
        # strategy needs the ISA and PLCP brought down; elsewhere the card's
        # side needs all three taken up
        card_s, host_side_s = (dev_s, host_s + down_s) if sa_on_card else (dev_s + up_s, host_s)
        sweep[n] = {"sa_on_card": sa_on_card, "factors_plcppeaks": len(want.pos), "factors_arrays": len(f.pos),
                    "plcppeaks_device_s": dev_s, "upload_sa_isa_plcp_s": up_s,
                    "plcppeaks_host_s": host_s, "isa_plcp_down_s": down_s,
                    "plcppeaks_host_over_device": host_side_s / card_s,
                    "resolve_device_s": dev_dec_s, "scan_decode_host_s": host_dec_s,
                    "host_over_device_decode": host_dec_s / dev_dec_s}
        del ds, arrays
        torch.cuda.empty_cache()
    return sweep


def transform_inputs(english) -> dict:
    """Phase 16's four 16 MiB inputs of kernel J: the English text, the DNA
    text, the English text's RLE output (what rle:mtf feeds J) and uniform
    random bytes."""
    import numpy as np

    from tudocomp_tpu_torch.compressors.simple import rle_encode

    text = english[:TRANSFORM_BYTES]
    with host_path():
        rle_text = rle_encode(text)
    return {"synth_english": text, "dna": dna_bytes(TRANSFORM_BYTES), "rle of synth_english": rle_text,
            "uniform": np.random.default_rng(7).integers(0, 256, TRANSFORM_BYTES).astype(np.uint8)}


def host_mtf(arr) -> tuple:
    """The host's tdc_mtf_encode of arr (uint8, contiguous) and its seconds."""
    import numpy as np

    from tudocomp_tpu_torch import native

    out = np.empty(len(arr), np.uint8)
    t0 = time.perf_counter()
    if len(arr):
        native.get_lib().tdc_mtf_encode(arr, len(arr), out)
    return out, time.perf_counter() - t0


def transforms_kernel_phase(english, dev, gpu):
    """Phase 16: kernel J against mtf_encode_plain and the host's
    tdc_mtf_encode, exactly, on the 16 MiB inputs and the edge inputs; its
    times. Returns (errs, timing) for the kernels line: the English text,
    the main path's largest launch."""
    import numpy as np
    import torch

    from tests import torch_cases
    from tudocomp_tpu_torch.ops.mtf_cuda import mtf_encode_chunks
    from tudocomp_tpu_torch.ops.transforms_torch import CHUNK, mtf_encode_plain, upload

    name = "mtf_encode"
    inputs = transform_inputs(english)
    inputs.update({f"edge: {k}": np.frombuffer(v, np.uint8) for k, v in torch_cases.mtf_edge_cases().items()})
    report, err, line = {}, 0, None
    for which, arr in inputs.items():
        arr = np.ascontiguousarray(arr)
        x = upload(arr, dev)
        got = mtf_encode_chunks(x)
        host, host_s = host_mtf(arr)
        plain, plain_ms = cuda_once(lambda: mtf_encode_plain(x))
        host_t = torch.from_numpy(host)
        e = max(max_abs_err(got, plain), max_abs_err(got.cpu(), host_t),
                *(max_abs_err(mtf_encode_chunks(x, chunk).cpu(), host_t) for chunk in MTF_CHUNKS))
        err = max(err, e)
        entry = {"bytes": len(arr), "max_abs_err": e, "host_tdc_mtf_encode_s": host_s}
        if not which.startswith("edge"):
            entry.update({"ms": cuda_ms(lambda: mtf_encode_chunks(x)), "plain_ms": plain_ms,
                          "mean_rank": float(got.to(torch.float64).mean())})
        if which == "synth_english":
            line = {"ms": entry["ms"], **device_time(lambda: mtf_encode_chunks(x), name), "plain_ms": plain_ms,
                    **bound(name, (x,), got), "scratch_bytes": -(-len(arr) // CHUNK) * 256 * 4,
                    "shape": f"{len(arr)} bytes of synth_english in chunks of {CHUNK}"}
            line["ms_by_chunk"] = {chunk: cuda_ms(lambda: mtf_encode_chunks(x, chunk)) for chunk in MTF_CHUNKS}
            line.update(fresh_j_device_time())
        report[which] = entry
        del x, got, plain, host_t
    torch.cuda.synchronize()
    if err:
        raise AssertionError(f"kernel J differs from its plain version or the host: {report}")
    no_jax()
    emit({"phase": "transforms kernel", "max_abs_err": err, "tolerance": 0, "inputs": report,
          "kernel_J": line, "card": gpu})
    return {name: err}, {name: line}


def fresh_j_device_time() -> dict:
    """Kernel J's device ms (device_time) from `--j`, a process of its own."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--j"], capture_output=True, text=True,
                       cwd=ROOT, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"chip_smoke.py --j failed ({r.returncode}):\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def j_main() -> int:
    """--j: device_time of kernel J on phase 16's 16 MiB English text, in a
    fresh process: one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tudocomp_tpu_torch.ops.mtf_cuda import mtf_encode_chunks
    from tudocomp_tpu_torch.ops.transforms_torch import upload

    x = upload(english_bytes(TRANSFORM_BYTES), torch.device("cuda", 0))
    emit(device_time(lambda: mtf_encode_chunks(x), "mtf_encode"))
    no_jax()
    return 0


def _mtf_input_bytes(algo: str, data: bytes) -> int:
    """Bytes that reach the MTF stage of `algo` (0: it has none)."""
    if algo not in MTF_FEED:
        return 0
    feed = MTF_FEED[algo]
    if feed is None:
        return len(data)
    from tudocomp_tpu_torch.driver import compress

    return len(compress(feed, data, device="cuda", raw=True))  # the host path's bytes, held so below


def transforms_roundtrip_phase(english, dev, gpu) -> int:
    """Phase 17: the transform chains and the slice's matrix ids through the
    driver on the card against the port's host path; kernel J launched
    wherever its gate opens; the chains' StatPhase spans, card against
    host; the sweep behind RLE_MIN_N and MTF_MIN_N. Returns kernel J's
    launches in the gated encodes."""
    import numpy as np
    import torch

    from tudocomp_tpu_torch import device as tdev
    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.compressors.simple import mtf_encode, rle_runs
    from tudocomp_tpu_torch.driver import compress, decompress

    small = english_bytes(MIB).tobytes()
    big = {"synth_english": english[:TRANSFORM_BYTES].tobytes(), "dna": dna_bytes(TRANSFORM_BYTES).tobytes()}
    runs = [("rle:mtf:encode(vbyte)", "synth_english", small), ("rle:mtf:encode(vbyte)", "synth_english",
                                                                 big["synth_english"]),
            *(("bwt:rle:mtf:encode(huff)", which, data) for which, data in big.items()),
            *((algo, "synth_english", small[:REPAIR_BYTES] if algo.startswith("repair")
               else small[:LZSS_IDS_BYTES] if algo.startswith("lzss(") else small)
              for algo in TRANSFORM_IDS)]
    launched_all = 0
    for algo, which, data in runs:
        n = len(data)
        feed = _mtf_input_bytes(algo, data)
        on_card = feed > 0 and tdev.use_mtf_device(feed, dev)
        kernels.reset_counts()
        container, enc_s = synced(lambda: compress(algo, data, device="cuda"))
        launched = kernels.counts()["mtf_encode"]
        if on_card and launched == 0:
            raise AssertionError(f"{algo} on {n} bytes of {which}: kernel J never launched")
        launched_all += launched
        back, dec_s = synced(lambda: decompress(container, device="cuda"))
        if back != data:
            raise AssertionError(f"{algo} on {n} bytes of {which}: the card's decode differs from the input")
        t0 = time.perf_counter()
        ref = ref_compress(algo, data)
        t1 = time.perf_counter()
        if container != ref:
            raise AssertionError(f"{algo} on {n} bytes of {which}: container differs from the host path's")
        if ref_decompress(container) != data:
            raise AssertionError(f"{algo} on {n} bytes of {which}: the host decode differs from the input")
        t2 = time.perf_counter()
        ratio = round(100.0 * len(container) / n, 2) if n else None
        if algo == "rle:mtf:encode(vbyte)" and n == MIB and ratio != RLE_MTF_RATIO_1MIB:
            raise AssertionError(f"{algo} at 1 MiB: ratio {ratio}% against BENCH_r05's {RLE_MTF_RATIO_1MIB}%")
        no_jax()
        emit({"phase": "transforms roundtrip", "algo": algo, "input": which, "bytes": n,
              "container_bytes": len(container), "ratio_pct": ratio, "mtf_input_bytes": feed,
              "mtf_on_card": on_card, "kernel_J_launches": launched, "encode_s": enc_s, "decode_s": dec_s,
              "host_reference_encode_s": t1 - t0, "host_reference_decode_s": t2 - t1, "card": gpu})
        del container, back, ref

    stages = {}
    data = big["synth_english"]
    for algo in TRANSFORM_ALGOS if FULL else ():
        compress(algo, data, device="cuda")  # warm
        card_enc, container = phase_spans(lambda: compress(algo, data, device="cuda"))
        torch.cuda.synchronize()
        card_dec, back = phase_spans(lambda: decompress(container, device="cuda"))
        with host_path():
            host_enc, host_container = phase_spans(lambda: compress(algo, data, device="cpu"))
            host_dec, host_back = phase_spans(lambda: decompress(container, device="cpu"))
        if container != host_container or back != data or host_back != data:
            raise AssertionError(f"{algo}: the staged runs differ from the host path or the input")
        stages[algo] = {"card": {"encode": card_enc, "decode": card_dec},
                        "host": {"encode": host_enc, "decode": host_dec}}
        del container, host_container, back, host_back

    # the sweep behind RLE_MIN_N and MTF_MIN_N: each stage as its compressor
    # runs it, host bytes in and out, the gate forced each way
    sweep = {}
    text = english[:TRANSFORM_BYTES]
    for n in TRANSFORM_SWEEP if FULL else ():
        arr = np.ascontiguousarray(text[:n])
        reps = 3 if n <= 4 * MIB else 2
        row = {}
        for var, stage in (("TDC_DEVICE_RLE", lambda: rle_runs(arr, dev)), ("TDC_DEVICE_MTF", lambda: mtf_encode(arr, dev))):
            out = {}
            for side, gate in (("device", "1"), ("host", "0"), ("device 2", "1")):
                os.environ[var] = gate
                try:
                    out[side] = best_of(stage, reps)
                finally:
                    del os.environ[var]
            got, want = out["device"][0], out["host"][0]
            same = all(np.array_equal(g, w) for g, w in zip(got, want)) if isinstance(got, tuple) else np.array_equal(got, want)
            if not same:
                raise AssertionError(f"{var} at {n} bytes: the device stage differs from the host's")
            dev_s = min(out["device"][1], out["device 2"][1])
            row[var] = {"device_s": dev_s, "host_s": out["host"][1], "host_over_device": out["host"][1] / dev_s}
        sweep[n] = row
    no_jax()
    emit({"phase": "transforms stages", "bytes": TRANSFORM_BYTES, "stages": stages,
          "gate_sweep_best_of_2_3": sweep,
          "gates": {"RLE_MIN_N": tdev.RLE_MIN_N, "MTF_MIN_N": tdev.MTF_MIN_N},
          "kernel_J_launches": launched_all, "card": gpu})
    return launched_all


def tail_stages(algo: str, data: bytes, device: str) -> tuple:
    """One driver.compress of a phase 18 id on `device` under a root
    StatPhase: the suffix stack's seconds (Construct SA, ISA, LCP), the
    strategy's (the rest of the family's first span: the rules, or lz78u's
    suffix tree), the coding's (its second span) and the whole encode's,
    the raw spans, and the container."""
    from tudocomp_tpu_torch.driver import compress

    spans, container = phase_spans(lambda: compress(algo, data, device=device))
    build, code = TAIL_SPANS[algo.split("(")[0]]
    stack = sum(spans.get(f"{build}/{name}", 0.0) for name in SUFFIX_STACK_SPANS)
    stages = {"suffix_stack_s": stack, "strategy_s": spans[build] - stack, "coding_s": spans[code],
              "encode_s": spans["total"]}
    return stages, spans, container


def matrix_tail_phase(gpu) -> tuple:
    """Phase 18: the suffix-tree families and the nested blockwise on the
    card against the port's host path, and the CLI's --stats on the card.
    Returns kernel H's launches in (a) and A-D's in (c)'s nested run."""
    import json as _json
    import tempfile

    import torch

    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.driver import compress, decompress
    from tudocomp_tpu_torch.parallel.blocks import unframe_streams

    t_phase = time.perf_counter()
    english = english_bytes(MIB).tobytes()

    # (a) each family at its size: containers, decodes, kernel H, stages;
    # first one suffix stack on the card, so that no stage carries the
    # card's first use of the suffix array's and kernel H's launches
    import numpy as np

    from tudocomp_tpu_torch.ds.textds import TextDS

    warm = TextDS(np.frombuffer(english[: 256 << 10] + b"\0", np.uint8).copy(), device="cuda")
    warm.require_isa(), warm.require_lcp()
    launched_h = 0
    for algo, n in TAIL_ALGOS.items():
        data = english[:n]
        kernels.reset_counts()
        card, card_spans, container = tail_stages(algo, data, "cuda")
        torch.cuda.synchronize()
        launched = kernels.counts()["plcp_segments"]
        if launched == 0:
            raise AssertionError(f"{algo}: kernel H never launched")
        launched_h += launched
        back, card["decode_s"] = synced(lambda: decompress(container, device="cuda"))
        with host_path():
            host, host_spans, ref = tail_stages(algo, data, "cpu")
            t0 = time.perf_counter()
            host_back = decompress(ref, device="cpu")
            host["decode_s"] = time.perf_counter() - t0
        if container != ref:
            raise AssertionError(f"{algo}: container differs from the host path's")
        if back != data or host_back != data:
            raise AssertionError(f"{algo}: a decode differs from the input")
        no_jax()
        emit({"phase": "matrix tail", "part": "a", "algo": algo, "bytes": n, "container_bytes": len(container),
              "ratio_pct": 100.0 * len(container) / n, "kernel_H_launches": launched,
              "stages_card": card, "stages_host": host, "spans_card": card_spans, "spans_host": host_spans,
              "card": gpu})

    # (b) every new id and the nested ids on 4 KiB, on the card
    small = english[:TAIL_SMALL]
    tail_ids = [f"lz78u(comp=streaming(string_coder={s}), coder={c})"
                for s in ("ascii", "bit", "gamma", "delta") for c in ("ascii", "bit", "gamma", "delta")]
    tail_ids += [f"lfs_comp(computing_strat={st}, coding_strat=lfs_enocde_strat(lfs_lit_coder={lit}, "
                 f"lfs_len_coder={ln}))" for st in ("esa", "st", "bst", "sim_st")
                 for lit in ("bit", "ascii", "huff") for ln in ("ascii", "bit", "gamma", "delta")]
    tail_ids += ["lfs2", "lfs2bst"]
    t0 = time.perf_counter()
    for algo in (*tail_ids, *NESTED_SMALL):
        container = compress(algo, small, device="cuda")
        if container != ref_compress(algo, small):
            raise AssertionError(f"{algo} at 4 KiB: container differs from the host path's")
        if decompress(container, device="cuda") != small or ref_decompress(container) != small:
            raise AssertionError(f"{algo} at 4 KiB: a decode differs from the input")
    no_jax()
    emit({"phase": "matrix tail", "part": "b", "ids": len(tail_ids) + len(NESTED_SMALL), "bytes": TAIL_SMALL,
          "seconds": time.perf_counter() - t0, "card": gpu})

    # (c) nested against flat on 64 MiB of zipf(1.3)
    data = zipf_bytes(5, NESTED_BYTES).tobytes()
    runs = {}
    for algo in (ALGO, NESTED_ALGO):
        kernels.reset_counts()
        container, enc_s = synced(lambda: compress(algo, data, device="cuda", raw=True))
        enc_launches = kernels.counts()
        kernels.reset_counts()
        back, dec_s = synced(lambda: decompress(container, device="cuda", id_string=algo, raw=True))
        dec_launches = kernels.counts()
        if back != data:
            raise AssertionError(f"{algo}: the card's decode differs from the input")
        runs[algo] = {"container": container, "encode_s": enc_s, "decode_s": dec_s,
                      "launches": {k: enc_launches[k] for k in HUFF_KERNELS[:3]},
                      "decode_launches": dec_launches["decode_payloads"]}
    flat_bs, flat = unframe_streams(runs[ALGO]["container"])
    outer_bs, outer = unframe_streams(runs[NESTED_ALGO]["container"])
    inner = [p for o in outer for p in unframe_streams(o)[1]]
    if (flat_bs, flat) != (BS, inner) or outer_bs != 4 * MIB:
        raise AssertionError("the nested blockwise's inner payloads differ from the flat blockwise's")
    nested_launches = {**runs[NESTED_ALGO]["launches"], "decode_payloads": runs[NESTED_ALGO]["decode_launches"]}
    if not all(nested_launches.values()):
        raise AssertionError(f"the nested blockwise did not launch every kernel: {nested_launches}")
    emit({"phase": "matrix tail", "part": "c", "bytes": NESTED_BYTES, "outer_blocks": len(outer),
          "inner_blocks": len(inner), **{
              label: {k: v for k, v in runs[algo].items() if k != "container"} | {
                  "container_bytes": len(runs[algo]["container"])}
              for label, algo in (("flat", ALGO), ("nested", NESTED_ALGO))}, "card": gpu})
    del data, runs, back, flat, outer, inner
    torch.cuda.empty_cache()

    # (d) the command line with --stats on the card
    tmp = tempfile.mkdtemp()
    try:
        src = os.path.join(tmp, "in.txt")
        with open(src, "wb") as f:
            f.write(english[:CLI_BYTES])
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "tudocomp_tpu_torch", "-a", "lz78u", "-s", "matrix tail", src],
                           capture_output=True, text=True, cwd=ROOT, timeout=600,
                           env=dict(os.environ, PYTHONPATH=ROOT))
        cli_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"the command line failed: {r.stderr[-2000:]}")
        doc = _json.loads(r.stdout.splitlines()[-1])
        stats = {s["key"]: int(s["value"]) for s in doc["data"]["stats"] if s["key"].startswith("devMem")}
        if set(stats) != {"devMemOff", "devMemPeak", "devMemFinal"} or stats["devMemPeak"] <= 0:
            raise AssertionError(f"the --stats document lacks the card's memory: {doc['data']['stats']}")
        with open(src + ".tdc", "rb") as f:
            if f.read() != ref_compress("lz78u", english[:CLI_BYTES]):
                raise AssertionError("the command line's container differs from the host path's")
    finally:
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    no_jax()
    emit({"phase": "matrix tail", "part": "d", "bytes": CLI_BYTES, "seconds": cli_s, "meta": doc["meta"],
          "root_memory": {k: doc["data"][k] for k in ("memOff", "memPeak", "memFinal")} | stats,
          "phases": [c["title"] for c in doc["data"]["sub"]], "card": gpu})
    emit({"phase": "matrix tail", "seconds": time.perf_counter() - t_phase, "kernel_H_launches": launched_h,
          "nested_launches": nested_launches, "card": gpu})
    return launched_h, nested_launches


def roundtrip_bytes():
    """Phase 3's 64 MiB: zipf(1.3) bytes, then 16 MiB of the *.md text."""
    import numpy as np

    return np.concatenate([zipf_bytes(2, ROUNDTRIP_BYTES - TEXT_BYTES), text_bytes(TEXT_BYTES)])


def group_inputs() -> dict:
    """Phase 19's inputs by pod_compress's inner: phase 3's 64 MiB for huff,
    16 MiB of synth_english for lzss."""
    return {"huff": roundtrip_bytes().tobytes(), "lzss": english_bytes(LZSS_BYTES).tobytes()}


def group_launches(name: str, counts: dict) -> dict:
    """The kernels of a group case's path that a rank holding blocks must
    have launched, and their counts; raises where one is 0."""
    got = {k: counts[k] for k in GROUP_KERNELS[name]}
    if not all(got.values()):
        raise AssertionError(f"{name}: a kernel of the path never launched: {got}")
    return got


def rank_main(out_dir: str, world: int, port: int, rank: int) -> int:
    """--rank: one rank of phase 19's gloo group on card 0. Each case is
    pod_compress on group_inputs() after a barrier; rank 0 writes the
    container to out_dir. One JSON line: the rank's wall seconds and kernel
    launches by case."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.parallel.distributed import init_distributed, pod_compress

    dist = torch.distributed
    if not init_distributed(f"127.0.0.1:{port}", world, rank, timeout_s=180):
        raise RuntimeError("no process group")
    dev = torch.device("cuda", 0)
    inputs = group_inputs()
    for inner, data in inputs.items():  # warm: the kernels' library, the allocator, the collectives
        pod_compress(data[:MIB], BS, inner=inner, device=dev)
    cases = {}
    for inner, shared in GROUP_CASES:
        name = f"{inner} shared={int(shared)}"
        dist.barrier()
        kernels.reset_counts()
        out, secs = synced(lambda: pod_compress(inputs[inner], BS, shared_table=shared, inner=inner, device=dev))
        if (out is None) != (rank != 0):
            raise AssertionError(f"{name}: pod_compress returned {type(out)} on rank {rank}")
        if out is not None:
            with open(os.path.join(out_dir, f"{inner}-{int(shared)}.bin"), "wb") as f:
                f.write(out)
        cases[name] = {"seconds": secs, "launches": group_launches(name, kernels.counts())}
    dist.barrier()
    no_jax()
    emit({"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(dev), "cases": cases})
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int) -> list:
    """Phase 19's group: `world` processes of this script (--rank), each a
    gloo rank on card 0; their JSON lines and rank 0's containers."""
    import tempfile

    tmp = tempfile.mkdtemp()
    port = free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", tmp, str(world), str(port),
                               str(r)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    try:
        for r, (p, (so, se)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} failed ({p.returncode}): {so[-2000:]} {se[-3000:]}")
        lines = [json.loads(so.strip().splitlines()[-1]) for so, _ in outs]
        containers = {}
        for name in os.listdir(tmp):
            with open(os.path.join(tmp, name), "rb") as f:
                containers[name[: -len(".bin")]] = f.read()
    finally:
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    return lines, containers


@contextlib.contextmanager
def blockwise_procs(value):
    """TDC_BLOCKWISE_PROCS set to `value` (None: unset) inside, restored after."""
    old = os.environ.pop("TDC_BLOCKWISE_PROCS", None)
    if value is not None:
        os.environ["TDC_BLOCKWISE_PROCS"] = value
    try:
        yield
    finally:
        os.environ.pop("TDC_BLOCKWISE_PROCS", None)
        if old is not None:
            os.environ["TDC_BLOCKWISE_PROCS"] = old


def spans_workers(spans: dict, title: str) -> int:
    return int(spans[f"{title}: workers"])


def group_phase(gpu) -> dict:
    """Phase 19: two gloo ranks sharing card 0 against one process and the
    host path; TDC_BLOCKWISE_PROCS unset, =8 and =0 on the encode and
    decode pools; the lzss thread pool and the decode pool in turns.
    Returns the group's launches by kernel (each rank's, summed)."""
    import torch

    from tudocomp_tpu_torch import kernels
    from tudocomp_tpu_torch.compressors import blockwise as bw
    from tudocomp_tpu_torch.driver import compress, decompress
    from tudocomp_tpu_torch.parallel import runtime
    from tudocomp_tpu_torch.parallel.distributed import pod_compress

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)

    # (a) two ranks against one: every container equal to the one-process
    # card run and to the host path
    t0 = time.perf_counter()
    lines, two = run_ranks(2)
    ranks_s = time.perf_counter() - t0
    inputs = group_inputs()
    for inner, data in inputs.items():  # warm, as the ranks are
        pod_compress(data[:MIB], BS, inner=inner, device=dev)
    cases, group_counts = {}, {}
    for inner, shared in GROUP_CASES:
        name = f"{inner} shared={int(shared)}"
        data = inputs[inner]
        kernels.reset_counts()
        one, one_s = synced(lambda: pod_compress(data, BS, shared_table=shared, inner=inner, device=dev))
        one_launches = group_launches(name, kernels.counts())
        if two[f"{inner}-{int(shared)}"] != one:
            raise AssertionError(f"{name}: the two ranks' container differs from one process's")
        t0 = time.perf_counter()
        algo = f"blockwise({LZSS_ALGO if inner == 'lzss' else 'encode(huff)'},bs={BS},shared={int(shared)})"
        with host_path():
            if inner == "lzss":  # one process, the runtime: its blocks on the C++ host stack
                host = runtime.blockwise_lzss_compress(data, BS, "cpu", shared_table=shared)
            else:  # the driver's container without its header
                host = compress(algo, data, device="cpu", raw=True)
        host_s = time.perf_counter() - t0
        if host != one:
            raise AssertionError(f"{name}: the card's container differs from the host path's")
        if decompress(one, device="cuda", id_string=algo, raw=True) != data:
            raise AssertionError(f"{name}: the card's decode differs from the input")
        rank_launches = [line["cases"][name]["launches"] for line in lines]
        for launches in rank_launches:
            for k, v in launches.items():
                group_counts[k] = group_counts.get(k, 0) + v
        cases[name] = {"bytes": len(data), "container_bytes": len(one), "one_rank_s": one_s,
                       "two_ranks_s": max(line["cases"][name]["seconds"] for line in lines),
                       "rank_s": [line["cases"][name]["seconds"] for line in lines],
                       "one_rank_launches": one_launches, "rank_launches": rank_launches,
                       "host_path_s": host_s}
    no_jax()
    emit({"phase": "group", "part": "a", "backend": lines[0]["backend"], "ranks": len(lines),
          "devices": [line["device"] for line in lines], "ranks_wall_s": ranks_s,
          "note": "two ranks share one card and its host: not a scaling figure", "cases": cases, "card": gpu})
    del inputs, two

    # (b) the encode and decode pools: TDC_BLOCKWISE_PROCS unset, =8, =0 (with
    # the unset default sequential, a run in turns for both pools)
    english = english_bytes(POOL_BYTES).tobytes()
    pools, containers = {}, {}
    for procs in (None, "8", "0"):
        label = "unset" if procs is None else procs
        with blockwise_procs(procs):
            spans, containers[label] = phase_spans(lambda: compress(POOL_ALGO, english, device="cuda"))
            dspans, back = phase_spans(lambda: decompress(containers[label], device="cuda"))
        if back != english:
            raise AssertionError(f"{POOL_ALGO} at TDC_BLOCKWISE_PROCS={label}: the decode differs from the input")
        pools[label] = {"encode_s": spans["total"], "encode_workers": spans_workers(spans, "host blockwise encode"),
                        "decode_s": dspans["total"], "decode_workers": spans_workers(dspans, "blockwise decode")}
    if len(set(containers.values())) != 1:
        raise AssertionError(f"{POOL_ALGO}: the pools' containers differ")
    if (pools["8"]["encode_workers"], pools["0"]["encode_workers"]) != (8, 0) or \
            pools["unset"]["encode_workers"] != bw.DEFAULT_WORKERS:
        raise AssertionError(f"the encode pool's arms: {pools}")
    no_jax()
    emit({"phase": "group", "part": "b", "algo": POOL_ALGO, "bytes": POOL_BYTES,
          "blocks": POOL_BYTES // BS, "pools": pools, "card": gpu})

    # (c) the lzss thread pool over a process's blocks, in turns
    data = english_bytes(LZSS_BYTES).tobytes()
    want = None
    lzss_turns = {n: [] for n in LZSS_WORKERS}
    for n in (*LZSS_WORKERS, *reversed(LZSS_WORKERS)):
        out, secs = synced(lambda: runtime.blockwise_lzss_compress(data, BS, dev, workers=n))
        if want is None:
            want = out
        elif out != want:
            raise AssertionError(f"the lzss pool at {n} threads changed the container")
        lzss_turns[n].append(secs)

    # (d) the decode pool, threads against one after another, in turns
    dec_turns = {}
    small = english_bytes(DECODE_POOL_BYTES).tobytes()
    for algo in ("blockwise(lz78(coder=bit),bs=8192)", "blockwise(lz78(coder=bit))"):
        container = compress(algo, small, device="cuda")
        row = {"0": [], "8": []}
        for procs in ("0", "8", "8", "0"):
            with blockwise_procs(procs):
                back, secs = synced(lambda: decompress(container, device="cuda"))
            if back != small:
                raise AssertionError(f"{algo}: the decode at TDC_BLOCKWISE_PROCS={procs} differs from the input")
            row[procs].append(secs)
        dec_turns[algo] = {"bytes": len(small), "sequential_s": row["0"], "threads_8_s": row["8"],
                           "sequential_over_threads": min(row["0"]) / min(row["8"])}
    no_jax()
    emit({"phase": "group", "part": "cd", "lzss_threads_s": lzss_turns, "lzss_default_threads": runtime.LZSS_THREADS,
          "decode_turns": dec_turns, "pool_default_workers": bw.DEFAULT_WORKERS,
          "seconds": time.perf_counter() - t_phase, "card": gpu})
    return group_counts

if __name__ == "__main__":
    if sys.argv[1:] == ["--j"]:
        sys.exit(j_main())
    if len(sys.argv) == 6 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[2], *map(int, sys.argv[3:])))
    if len(sys.argv) == 3 and sys.argv[1] in ("--dh", "--turns"):
        sys.exit((dh_main if sys.argv[1] == "--dh" else turns_main)(sys.argv[2]))
    if sys.argv[1:] == ["--full"]:
        FULL = True
    elif len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
