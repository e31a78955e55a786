"""The streaming transforms' device stages: the RLE run split and the MTF encode.

The port's counterpart of tudocomp_tpu/ops/transforms.py and ops/mtf.py.

- `rle_runs_device`: the run decomposition of rle_encode
  (RunLengthEncoder.hpp:16-32) by a shift-compare and one `nonzero`, plain
  PyTorch on the tensor's device; the caller serializes on the host.
- `mtf_encode_device`: MTF ranks (MTFCompressor.hpp:17-29). A CUDA tensor
  goes to kernel J (csrc/mtf.cu, ops/mtf_cuda.py), a CPU tensor to
  `mtf_encode_plain`.

MTF's closed form (ops/mtf.py:1-14): the table at any position is fixed by
the last occurrence of each symbol before it, the seen symbols first, the
most recent first, then the unseen ones in byte order. So every chunk of
CHUNK bytes can start from its own entry table: J1 finds each symbol's last
position in each chunk (`chunk_last_positions`), J2 takes their exclusive
running max over the chunks (`entry_positions`), and each chunk's walk
starts from the table those positions rank to (`entry_tables`). Inside a
chunk kernel J runs WALKERS walkers, each over a sub-chunk of chunk /
WALKERS bytes from its own entry table: `walker_last_positions` gives each
symbol's last position in each sub-chunk, and `walker_tables` the walkers'
entry tables, walker t + 1's being MTF's table after sub-chunk t, the
closed form's: sub-chunk t's symbols by their last position there, latest
first, then walker t's other symbols in their order. The plain version uses
the chunks' entry positions as each chunk's carry and the closed form
inside the chunk, a batch of chunks at a time.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = [
    "CHUNK",
    "chunk_last_positions",
    "entry_positions",
    "entry_tables",
    "mtf_encode_device",
    "mtf_encode_plain",
    "rle_runs_device",
    "upload",
    "walker_last_positions",
    "walker_tables",
]

SIGMA = 256
CHUNK = 4096  # bytes a chunk: kernel J's warp walks one (csrc/mtf.cu takes 128-8192, a multiple of 128)
WALKERS = 32  # sub-chunks a chunk: a lane of kernel J's warp walks one
PLAIN_ROWS = 1 << 14  # positions the plain version holds [rows, 256] tables for at once

_I32 = torch.int32
_U8 = torch.uint8


def upload(data, device) -> torch.Tensor:
    """Host bytes as a uint8 tensor on `device`, without a copy on the host;
    the tensor is read only, so a read-only buffer is taken as it is."""
    arr = np.ascontiguousarray(data, np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # torch warns of non-writable arrays
        return torch.from_numpy(arr).to(device)


def rle_runs_device(data: torch.Tensor):
    """[n] u8 -> (chars [n_runs] u8, lengths [n_runs] int32, n_runs).

    The runs of equal bytes in order, on data's device: one host sync (the
    `nonzero` that counts the runs), so only n_runs entries ever need to
    come back (the JAX package's twin returns [n] arrays padded with
    zeros)."""
    n = data.numel()
    if n == 0:
        return data[:0], torch.zeros(0, dtype=_I32, device=data.device), 0
    change = torch.ones(n, dtype=torch.bool, device=data.device)
    torch.ne(data[1:], data[:-1], out=change[1:])
    starts = torch.nonzero(change).squeeze(1)
    ends = torch.cat([starts[1:], torch.full((1,), n, dtype=starts.dtype, device=data.device)])
    return data[starts], (ends - starts).to(_I32), int(starts.numel())


def chunk_last_positions(data: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """J1: [C, 256] int32, the last position (in data) of each symbol in each
    chunk of `chunk` bytes, -1 where the chunk lacks it."""
    n = data.numel()
    pos = torch.arange(n, dtype=_I32, device=data.device)
    idx = (pos.to(torch.int64) // chunk) * SIGMA + data.to(torch.int64)
    last = torch.full((-(-n // chunk) * SIGMA,), -1, dtype=_I32, device=data.device)
    last.scatter_reduce_(0, idx, pos, reduce="amax")
    return last.view(-1, SIGMA)


def entry_positions(last: torch.Tensor) -> torch.Tensor:
    """J2: the exclusive running max of J1's rows, [C, 256] int32: each
    symbol's last position before each chunk, -1 where it has none."""
    if last.shape[0] == 0:
        return last.clone()
    inc = torch.cummax(last, dim=0).values
    return torch.cat([torch.full_like(last[:1], -1), inc[:-1]])


def _keys(entry: torch.Tensor) -> torch.Tensor:
    """Sort keys whose ascending order is the MTF table: seen symbols by
    their last position, latest first, then the unseen ones by value."""
    sym = torch.arange(SIGMA, dtype=torch.int64, device=entry.device)
    e = entry.to(torch.int64)
    return torch.where(e >= 0, 0x7FFFFFFF - e, 0x80000000 + sym)


def entry_tables(entry: torch.Tensor) -> torch.Tensor:
    """J3's start: [C, 256] u8, the MTF table at the start of each chunk
    (position p holds the symbol of rank p), from J2's entry positions."""
    return torch.argsort(_keys(entry), dim=1).to(_U8)


def walker_last_positions(data: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """[C, WALKERS, 256] int32: the last position (in data) of each symbol in
    each walker's sub-chunk of chunk / WALKERS bytes, -1 where it lacks it
    (and for the sub-chunks past the end of data)."""
    n = data.numel()
    C = -(-n // chunk)
    last = chunk_last_positions(data, chunk // WALKERS)
    pad = torch.full((C * WALKERS - last.shape[0], SIGMA), -1, dtype=_I32, device=data.device)
    return torch.cat([last, pad]).view(C, WALKERS, SIGMA)


def walker_tables(data: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """J3's walkers' entry tables, [C, WALKERS, 256] u8 (position p holds the
    symbol of rank p): walker 0's the chunk's entry table, walker t + 1's
    sub-chunk t's symbols by their last position there, latest first, then
    walker t's other symbols in their order."""
    cur = entry_tables(entry_positions(chunk_last_positions(data, chunk))).to(torch.int64)
    last = walker_last_positions(data, chunk).to(torch.int64)
    pos = torch.arange(SIGMA, dtype=torch.int64, device=data.device)
    tables = [cur]
    for t in range(WALKERS - 1):
        lt = torch.gather(last[:, t], 1, cur)  # the last position of the symbol at each table position
        cur = torch.gather(cur, 1, torch.argsort(torch.where(lt >= 0, -lt, (1 << 40) + pos), dim=1))
        tables.append(cur)
    return torch.stack(tables, 1).to(_U8)


def mtf_encode_plain(data: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """Kernel J's plain version: [n] u8 -> [n] u8 MTF ranks, on data's device.

    The closed form of ops/mtf.py:27-58 over chunks, each chunk's carry its
    entry positions (J1, J2): rank = #{symbols whose last occurrence is
    later than c's} for a seen c, else #seen + c - #{seen symbols below c}."""
    if data.dim() != 1 or data.dtype != _U8:
        raise ValueError("expected a 1-d uint8 tensor")
    n = data.numel()
    out = torch.empty(n, dtype=_U8, device=data.device)
    if n == 0:
        return out
    if n >= 1 << 31:
        raise ValueError("MTF positions are int32: at most 2^31 - 1 bytes")
    entry = entry_positions(chunk_last_positions(data, chunk))
    C = entry.shape[0]
    per = max(1, PLAIN_ROWS // chunk)
    for c0 in range(0, C, per):
        c1 = min(C, c0 + per)
        k, lo, hi = c1 - c0, c0 * chunk, min(n, c1 * chunk)
        x = torch.zeros(k * chunk, dtype=torch.int64, device=data.device)
        x[: hi - lo] = data[lo:hi]
        x = x.view(k, chunk, 1)
        pos = torch.arange(lo, lo + k * chunk, dtype=_I32, device=data.device).view(k, chunk, 1)
        M = torch.full((k, chunk, SIGMA), -1, dtype=_I32, device=data.device)
        M.scatter_(2, x, pos)
        M = torch.cummax(M, dim=1).values
        base = entry[c0:c1, None, :]
        L = torch.cat([base, torch.maximum(M[:, :-1], base)], dim=1)  # last occurrence before each row
        del M
        prev = torch.gather(L, 2, x)
        cnt_gt = (L > prev).sum(2)
        seen = L >= 0
        seen_less = torch.gather(torch.cumsum(seen, 2, dtype=_I32) - seen.to(_I32), 2, x)
        rank = torch.where(prev >= 0, cnt_gt[..., None], seen.sum(2, keepdim=True) + x - seen_less)
        out[lo:hi] = rank.view(-1)[: hi - lo].to(_U8)
    return out


def mtf_encode_device(data: torch.Tensor) -> torch.Tensor:
    """[n] u8 -> [n] u8 MTF ranks on data's device: kernel J on a CUDA
    tensor, the plain version on a CPU tensor."""
    from .mtf_cuda import mtf_encode_chunks

    return mtf_encode_chunks(data)
