"""Device policy of the port, keyed on an explicit `torch.device`.

Every entry point takes a `device`. A CUDA device runs the device stages
through the hand-written kernels; a CPU device runs the same stages through
the kernels' plain PyTorch versions. Asking for CUDA where there is no card
raises: nothing moves to the CPU on its own.

Per-stage overrides, as in the JAX package: TDC_DEVICE_HUFF=1 forces the
device stages of the Huffman path (on whichever device was given), =0
forces the host coder; TDC_DEVICE_LZ78 does the same for the blockwise
LZ78/LZW parse. Unset, the device stages run on a CUDA device and the host
paths on the CPU. The blockwise parse has a size gate on top
(use_parse_device). blockwise(encode(huff),shared=1) reads neither: no
host coder builds its one table, so it always runs the device stages.
TDC_DEVICE_SA and TDC_DEVICE_LZSS do the same for the suffix array and the
LZSS factorization of lzss_lcp, each with a size gate of its own
(use_sa_device, use_lzss_device), TDC_DEVICE_ESP for the ESP rounds
(use_esp_device), and TDC_DEVICE_LCPCOMP for lcpcomp's two device stages,
the plcppeaks factorization (use_lcpcomp_device) and the chain-resolving
decode (use_lcpcomp_decode_device): one variable for both, each with a size
gate of its own; TDC_DEVICE_RLE for the RLE run split (use_rle_device) and
TDC_DEVICE_MTF for the MTF encode, kernel J (use_mtf_device). (The JAX package keeps both lcpcomp stages opt-in, and its
decode from 4 MiB, from a TPU's gather costs; neither carries over.) The PLCP and LCP arrays have no gate of
their own: TextDS computes them on the device exactly when the device built
the suffix array, which then lies there already.
"""

from __future__ import annotations

import os

import torch

__all__ = [
    "resolve",
    "use_device",
    "use_esp_device",
    "use_lcpcomp_decode_device",
    "use_lcpcomp_device",
    "use_lzss_device",
    "use_mtf_device",
    "use_parse_device",
    "use_rle_device",
    "use_sa_device",
]


def resolve(device) -> torch.device:
    """A torch.device for one CPU or one CUDA card; raises for anything else.

    A device list raises: the port runs one process for each card, joined
    into a process group by parallel.distributed.init_distributed, in
    place of the JAX package's device mesh."""
    if isinstance(device, (list, tuple)):
        raise ValueError(
            "a device list is not one device: run one process for each card "
            "(tudocomp_tpu_torch.parallel.distributed.init_distributed)"
        )
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested, but no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def use_device(env_var: str, device: torch.device) -> bool:
    """Should this stage run its device version on `device`?"""
    v = os.environ.get(env_var)
    if v == "1":
        return True
    if v == "0":
        return False
    return device.type == "cuda"


# Largest block the device parse takes, lz78 and lzw alike; larger blocks
# take the host parse. Kernels E and F run a warp per block, so the card
# parses blocks side by side while the host parses them one after another,
# but each block's chain of rounds on the card is longer than its host
# parse below 1 MiB. Encoding with the device parse against the host
# parse (chip_smoke.py phase 8, NVIDIA H100 80GB HBM3 at 700.00 W),
# seconds: 50 MiB of English (7-50 blocks) at blocks of 1, 2, 4 and 8 MiB,
# lz78 0.76/4.43, 0.99/4.73, 1.16/6.08, 2.03/6.32; lzw 0.74/4.03,
# 0.74/3.71, 0.80/4.58, 1.12/5.04; in a second run lz78 1.01/3.97,
# 1.05/4.20, 1.00/4.52, 1.44/5.91; lzw 0.52/3.90, 0.72/3.98, 0.79/4.21,
# 1.03/4.75: the device parse won every size of both kinds, by 3.1x or
# more, so the cap is the largest size measured. (The kernels take blocks
# up to ops/lz78_cuda.MAX_BS, 16 MiB less 512 bytes. The JAX package's
# caps, lz78 256 KiB and lzw 8 KiB, were the TPU's VMEM limits.)
PARSE_MAX_BS = 8 << 20

# Within the cap, with TDC_DEVICE_LZ78 unset, the card takes an input of
# PARSE_MIN_BLOCKS blocks or more, or one of blocks of PARSE_ONE_BLOCK_BS
# bytes or more. Same card, three more runs, inputs of few blocks of that
# text, the least of 2-3 encodes each, lz78 and lzw, host time over device
# time: one block of 8 KiB 0.39-0.52 (device 1.9-2.9 ms, host 0.8-1.5),
# of 256 KiB 0.48-0.71 (21.5-22.9 against 10.3-16.3 ms): the host wins;
# one block of 1 MiB 0.77-1.27, a tie; of 2, 4 and 8 MiB 0.97-1.56, the
# card faster in 16 of 18 (the others 0.97 and 1.00). Two blocks of 256
# KiB 0.84-1.18, a tie; of 1-8 MiB 1.40-2.79; four and eight of 256 KiB
# 1.25-2.46; 16 and 128 of 8 KiB 1.14-1.94: the card wins. Two blocks of 8
# KiB were not measured. Both kinds cross at the same sizes.
PARSE_MIN_BLOCKS = 2
PARSE_ONE_BLOCK_BS = 2 << 20


def use_parse_device(bs: int, n_blocks: int, device: torch.device) -> bool:
    """Should the blockwise LZ78/LZW parse of `n_blocks` blocks of `bs`
    bytes run its device version on `device`? Never past PARSE_MAX_BS;
    within it TDC_DEVICE_LZ78=1/0 forces it on (on whichever device was
    given) or off; unset, a CUDA device takes PARSE_MIN_BLOCKS blocks or
    more, or blocks of PARSE_ONE_BLOCK_BS bytes or more."""
    if bs > PARSE_MAX_BS:
        return False
    v = os.environ.get("TDC_DEVICE_LZ78")
    if v in ("0", "1"):
        return v == "1"
    return device.type == "cuda" and (n_blocks >= PARSE_MIN_BLOCKS or bs >= PARSE_ONE_BLOCK_BS)


# Smallest text whose suffix array is built on a CUDA device when
# TDC_DEVICE_SA is unset; shorter texts take the C++ SA-IS on the host.
# Measured by chip_smoke.py (phase "suffix stack") in four runs on an NVIDIA
# H100 80GB HBM3 at 700.00 W, on prefixes of synth_english, best of 3 a run:
# the card's side is the text's copy up, suffix_array_device and SA and ISA
# back, the host's is SA-IS and the inverse permutation. Milliseconds, card
# against host, over the runs: 64 KiB 2.9-5.9 against 3.5-5.0 (a tie),
# 128 KiB 4.0-5.4 against 6.8-8.7, 256 KiB 6.0-9.4 against 13.6-19.1,
# 1 MiB 19-22 against 63-82, 4 MiB 78-81 against 319-582, 16 MiB 375-395
# against 1898-3411. The card wins by 2x or more from 256 KiB on in every
# run. (The JAX package's gate has the same size, from a TPU's numbers,
# which do not apply here.) The PLCP and LCP follow the SA (ds/textds.py):
# in a fifth run, same card and limit, kernel H with the LCP's copy back
# against the C++ phi, PLCP and LCP took 0.57 against 1.03 ms at 64 KiB, 0.78
# against 4.10 at 256 KiB, 1.34 against 29.4 at 1 MiB, 3.2 against 203 at
# 4 MiB and 47 against 1009 at 16 MiB. The gate sees the size only: on 16 MiB
# of one letter, or of a period of 1000 bytes, the device SA took 2.16-2.18 s
# against 0.50 and 2.43 s for SA-IS (kernel H 0.10-0.16 s against 0.20-0.58 s).
SA_MIN_N = 256 << 10

# Smallest text whose LZSS factorization (ANSV and the greedy walk) runs on a
# CUDA device when TDC_DEVICE_LZSS is unset. Same runs and card; the card's
# side is SA, ISA and LCP copied up, lzss_lcp_factorize_device and the
# factors back, the host's the C++ monotone stacks. Milliseconds, card
# against host: 64 KiB 13-24 against 2.5-3.2, 256 KiB 16-28 against 11-15,
# 512 KiB 19-27 against 21-28 (a tie), 1 MiB 24-36 against 48-54, 4 MiB
# 56-66 against 230-285, 16 MiB 184-206 against 894-1055. The device's
# rounds (one host sync each) cost 11-18 ms whatever the size; the card
# wins by 1.5-2.0x at 1 MiB and by more above. (The JAX package keeps its device
# factorization opt-in, a decision made from a TPU's gather cost, which
# does not apply here.) The size is all the gate sees: on 16 MiB with a
# period of 1000 bytes the NSV chase walks chains of resolved elements
# a step a round, and the device took 5.29 s against 0.33 s (the fifth run).
LZSS_MIN_N = 1 << 20


def _use_sized(env_var: str, n: int, min_n: int, device: torch.device) -> bool:
    v = os.environ.get(env_var)
    if v in ("0", "1"):
        return v == "1"
    return device.type == "cuda" and n >= min_n


def use_sa_device(n: int, device: torch.device) -> bool:
    """Should the suffix array of a text of n bytes be built on `device`
    (ds/suffix_array.suffix_array_device)? TDC_DEVICE_SA=1/0 forces it on
    (on whichever device was given) or off."""
    return _use_sized("TDC_DEVICE_SA", n, SA_MIN_N, device)


def use_lzss_device(n: int, device: torch.device) -> bool:
    """Should lzss_lcp factorize a text of n bytes on `device`
    (ops/lzss_torch.lzss_lcp_factorize_device)? TDC_DEVICE_LZSS as above."""
    return _use_sized("TDC_DEVICE_LZSS", n, LZSS_MIN_N, device)


# Smallest input whose ESP rounds run on a CUDA device (ops/esp_torch.py)
# when TDC_DEVICE_ESP is unset; smaller ones take the host rounds.
# Measured by chip_smoke.py (phase "esp stages", gate_sweep) on an NVIDIA
# H100 80GB HBM3 at 700.00 W, on prefixes of 16 MiB of synth_english (seed
# 7), best of 2-3: esp_grammar_device (bytes up, nine rounds at most down to
# the host-finish threshold of 1 << 15, rules back) against
# generate_grammar's C++ rounds, milliseconds: 128 KiB 26.9 against 9.3,
# 256 KiB 40.8 against 19.8, 512 KiB 49.8 against 37.2, 1 MiB 64.3 against
# 94.8, 4 MiB 101.7 against 397.0, 16 MiB 180.6 against 1828.5. A device
# round costs 5-10 ms of launches whatever its size, so the host wins below
# 1 MiB and the card from 1 MiB on: host over device in four runs 0.48-0.97
# at 512 KiB, 1.18-1.79 at 1 MiB. (The JAX package's 2 MiB came from a TPU
# and does not apply here.)
ESP_MIN_N = 1 << 20


def use_esp_device(n: int, device: torch.device) -> bool:
    """Should the ESP grammar of an input of n bytes be built by the device
    rounds on `device` (ops/esp_torch.esp_grammar_device)?
    TDC_DEVICE_ESP=1/0 forces it on (on whichever device was given) or off."""
    return _use_sized("TDC_DEVICE_ESP", n, ESP_MIN_N, device)


# Smallest text whose plcppeaks factorization (ops/lcpcomp_torch.py) runs on
# a CUDA device when TDC_DEVICE_LCPCOMP is unset. Measured by chip_smoke.py
# (phase "lcpcomp stages", gate_sweep) in four sweeps (16 and 64 KiB in
# three) on an NVIDIA H100 80GB HBM3 at 700.00 W, on prefixes of
# synth_english (seed 7), best of 2-3: the card's side is
# plcppeaks_factorize_device from the SA, ISA and PLCP that TextDS holds on
# the card (below SA_MIN_N those are taken up first) with the factors back;
# the host's is the C++ strategy with the ISA and PLCP brought down. Host
# over card: 16 and 64 KiB 0.04-0.08 (SA on the host), 256 KiB 0.31-1.04, 1
# MiB 0.34-1.03, 4 MiB 0.47-1.16, 16 MiB 1.16-1.63 (77 ms on the card, most
# of it greedy_visited's 26 rounds, against 37-57 ms of C++ and 52-74 ms of
# copies). The card wins in every sweep only at 16 MiB. (The JAX package
# keeps this stage opt-in from a TPU's numbers.)
LCPCOMP_MIN_N = 16 << 20

# Smallest container text whose lcpcomp decode resolves its factor chains on
# a CUDA device (ops/lcpcomp_torch.resolve_factors_device, whatever its dec)
# when TDC_DEVICE_LCPCOMP is unset. Same sweeps and card; the card's side is
# resolve_factors_device with every copy, the host's
# tdc_lcpcomp_scan_decode (the default dec), milliseconds: 16 KiB 0.5-0.9
# against 0.3-0.4, 64 KiB 0.6-1.0 against 1.6-2.5, 256 KiB 0.9-1.1 against
# 9.4-12, 1 MiB 1.2-2.1 against 69-81, 4 MiB 3.5-4.8 against 625-693, 16
# MiB 13.6-16.6 against 2624-3224: the card wins from 64 KiB on, by
# 2.6-3.3x there and by 136-216x at 4-16 MiB. (The JAX package's opt-in and
# its 4 MiB floor came from a TPU's gathers.)
LCPCOMP_DEC_MIN_N = 64 << 10


def use_lcpcomp_device(n: int, device: torch.device) -> bool:
    """Should lcpcomp(comp=plcppeaks) factorize a text of n bytes on `device`
    (ops/lcpcomp_torch.plcppeaks_factorize_device)? TDC_DEVICE_LCPCOMP=1/0
    forces it on (on whichever device was given) or off."""
    return _use_sized("TDC_DEVICE_LCPCOMP", n, LCPCOMP_MIN_N, device)


def use_lcpcomp_decode_device(n: int, device: torch.device) -> bool:
    """Should an lcpcomp container of n bytes resolve its factors on `device`
    (ops/lcpcomp_torch.resolve_factors_device), whatever its `dec`?
    TDC_DEVICE_LCPCOMP as above."""
    return _use_sized("TDC_DEVICE_LCPCOMP", n, LCPCOMP_DEC_MIN_N, device)


# Smallest input whose RLE run split (ops/transforms_torch.rle_runs_device)
# runs on a CUDA device when TDC_DEVICE_RLE is unset. Measured by
# chip_smoke.py (phase "transforms stages", gate_sweep) in two runs on an
# NVIDIA H100 80GB HBM3 at 700.00 W, on prefixes of synth_english (seed
# 7), best of 2-3 a run:
# compressors/simple.rle_runs with the gate forced each way, the card's side
# the bytes up, the split, the run lengths back (4 bytes a run) and the
# host's cumsum and gather, the host's
# side numpy's shift-compare, flatnonzero and diff. Milliseconds, card
# against host, over the runs: 16 KiB 0.37-0.50 against 0.09-0.10, 64 KiB
# 0.77-0.87 against 0.28-0.37, 256 KiB 1.8-2.1 against 1.2-1.3, 1 MiB
# 7.4-8.0 against 6.1-6.5, 4 MiB 33.9-34.6 against 27.9-29.9, 16 MiB
# 156-199 against 195-243: the host wins up to 4 MiB (by 1.15-5x), the
# card by 1.22-1.25x at 16 MiB. (The JAX package's 16 MiB came from a v5e.)
RLE_MIN_N = 16 << 20

# Smallest input whose MTF encode runs on a CUDA device (kernel J,
# ops/mtf_cuda.py) when TDC_DEVICE_MTF is unset. Measured by the same
# sweep on the same card in three later runs (two from 4 KiB):
# compressors/simple.mtf_encode with the gate forced each way, the card's
# side the bytes up, kernel J and the ranks back, the host's the C++ table
# walk (tdc_mtf_encode). Milliseconds, card against host, over the runs:
# 4 KiB 0.211-0.224 against 0.137-0.176, 8 KiB 0.177-0.211 against
# 0.250-0.260, 16 KiB 0.149-0.212 against 0.309-0.479, 32 KiB 0.15-0.23
# against 0.61-0.96, 64 KiB 0.16-0.25 against 1.2-1.8, 256 KiB 0.20-0.33
# against 4.7-7.1, 1 MiB 0.39-0.65 against 19-27, 4 MiB 0.93-1.64 against
# 76-104, 16 MiB 3.8-4.1 against 348-361: the host wins at 4 KiB (the card
# 0.65-0.79x), the card from 8 KiB on, by 1.23-1.41x there, 2.1-2.3x at 16
# KiB and 84-94x at 16 MiB. (The JAX package's 4 MiB came from a v5e.)
MTF_MIN_N = 8 << 10


def use_rle_device(n: int, device: torch.device) -> bool:
    """Should the RLE run split of an input of n bytes run on `device`
    (ops/transforms_torch.rle_runs_device)? TDC_DEVICE_RLE=1/0 forces it on
    (on whichever device was given) or off."""
    return _use_sized("TDC_DEVICE_RLE", n, RLE_MIN_N, device)


def use_mtf_device(n: int, device: torch.device) -> bool:
    """Should the MTF encode of an input of n bytes run on `device`
    (ops/transforms_torch.mtf_encode_device: kernel J on a card)?
    TDC_DEVICE_MTF=1/0 forces it on (on whichever device was given) or off."""
    return _use_sized("TDC_DEVICE_MTF", n, MTF_MIN_N, device)
