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
(use_sa_device, use_lzss_device). The PLCP and LCP arrays have no gate of
their own: TextDS computes them on the device exactly when the device built
the suffix array, which then lies there already.
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve", "use_device", "use_lzss_device", "use_parse_device", "use_sa_device"]


def resolve(device) -> torch.device:
    """A torch.device for one CPU or one CUDA card; raises for anything else."""
    if isinstance(device, (list, tuple)):
        raise NotImplementedError(
            "more than one GPU is not ported yet (ROADMAP.md, Queue 1 item 5)"
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
