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
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve", "use_device", "use_parse_device"]


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
# take the host parse. The kernels run one thread per block, so their time
# grows with the block while the host's does not. Encoding 50 MiB of English
# text on an H100 (700 W), the device parse is 1.3-2.1x faster than the host
# parse at 8 KiB to 1 MiB blocks; at 4 MiB one run has it ahead and another
# behind (PERF.md section 7). The JAX package's caps (lz78 256 KiB, lzw
# 8 KiB) were the TPU's VMEM limits.
PARSE_MAX_BS = 1 << 20


def use_parse_device(bs: int, device: torch.device) -> bool:
    """Should the blockwise LZ78/LZW parse of blocks of `bs` bytes run its
    device version on `device`? TDC_DEVICE_LZ78 as in use_device, within
    PARSE_MAX_BS."""
    return bs <= PARSE_MAX_BS and use_device("TDC_DEVICE_LZ78", device)
