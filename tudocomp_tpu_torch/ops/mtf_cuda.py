"""Kernel J: the MTF encode, every chunk of the input at once, a warp a chunk.

`mtf_encode_chunks` gives the move-to-front ranks of a uint8 tensor
(MTFCompressor.hpp:17-29, the host's tdc_mtf_encode): a CUDA tensor goes
to kernel J (csrc/mtf.cu: J1 each chunk's last positions, J2 their
exclusive running max, J3 a warp a chunk, its 32 lanes walking a sub-chunk
each from their own entry tables; three launches, one count), a CPU tensor
to ops/transforms_torch.py:mtf_encode_plain.
"""

from __future__ import annotations

import torch

from .. import kernels
from .bitpack_cuda import on_cuda
from .transforms_torch import CHUNK, SIGMA, mtf_encode_plain

__all__ = ["mtf_encode_chunks"]

MAX_CHUNK = 8192  # csrc/mtf.cu: a warp's chunk lies in shared memory, a sub-chunk of at most 256 a lane


def mtf_encode_chunks(data: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """[n] u8 -> [n] u8 MTF ranks, on data's device; chunk: bytes a warp
    walks (chunk / 32 a lane), a multiple of 128 up to MAX_CHUNK."""
    if data.dim() != 1 or data.dtype != torch.uint8:
        raise ValueError("expected a 1-d uint8 tensor")
    if chunk < 128 or chunk > MAX_CHUNK or chunk % 128:
        raise ValueError(f"chunk {chunk}: a multiple of 128 in [128, {MAX_CHUNK}]")
    if data.numel() >= 1 << 31:
        raise ValueError("MTF positions are int32: at most 2^31 - 1 bytes")
    if not on_cuda(data):
        return mtf_encode_plain(data, chunk)
    n = data.numel()
    out = torch.empty(n, dtype=torch.uint8, device=data.device)
    if n == 0:
        return out
    last = torch.empty((-(-n // chunk), SIGMA), dtype=torch.int32, device=data.device)
    kernels.launch("tdc_mtf_encode_chunks", data.contiguous(), n, out, last, chunk)
    return out
