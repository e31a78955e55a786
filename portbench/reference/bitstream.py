"""tudocomp's bit stream, written from token arrays in plain PyTorch.

A token is a value and its width in bits; a stream is its tokens one after
another, most significant bit first within each byte (tudocomp's
BitOStream). Closing a stream stores the count of valid bits in the last
byte, `rem` = bits mod 8, in that byte's low 3 bits: for `rem` 1 to 5 it is
ORed into the last byte, for 6 and 7 a byte holding `rem` follows, and
for 0 a 0x00 byte follows (so an empty stream is the one byte 0x00).

Tokens are placed by an exclusive prefix sum of the widths and ORed into
32-bit words (an add of disjoint bits) on whatever device the tensors are
on. Imports nothing but numpy and torch.
"""

from __future__ import annotations

import numpy as np
import torch

I64 = torch.int64
MASK32 = 0xFFFFFFFF


def bits_for(v: int) -> int:
    """Bits to store v; 1 for 0 (tudocomp's bits_for)."""
    return max(1, int(v).bit_length())


def compressed_int(v: int, b: int = 7) -> list:
    """Tokens of BitOStream::write_compressed_int: b-bit groups from the
    least significant, each after a bit that says whether another follows."""
    v = int(v)
    out = []
    while True:
        cur = v & ((1 << b) - 1)
        v >>= b
        out += [(int(v > 0), 1), (cur, b)]
        if v <= 0:
            return out


def _split_wide(values: torch.Tensor, widths: torch.Tensor, starts: torch.Tensor):
    """Tokens wider than 32 bits as two: the high part, then the low 32."""
    wide = widths > 32
    if not bool(wide.any()):
        return values, widths, starts
    reps = 1 + wide.to(I64)
    v = torch.repeat_interleave(values, reps)
    w = torch.repeat_interleave(widths, reps)
    s = torch.repeat_interleave(starts, reps)
    first = torch.ones_like(v, dtype=torch.bool)
    ends = torch.cumsum(reps, 0)
    first[ends[wide] - 1] = False  # the second of each pair
    hi = first & (w > 32)
    lo = ~first
    v = torch.where(hi, v >> 32, torch.where(lo, v & MASK32, v))
    s = torch.where(lo, s + w - 32, s)
    w = torch.where(hi, w - 32, torch.where(lo, torch.full_like(w, 32), w))
    return v, w, s


def pack_streams(values: torch.Tensor, widths: torch.Tensor, counts) -> list:
    """Streams of tokens -> one closed tudocomp bit stream (bytes) each.

    values, widths: [T] integer tensors, the tokens of stream 0, then of
    stream 1, ...; counts: tokens in each stream. Each value must fit its
    width (widths 1 to 63)."""
    dev = values.device
    values = values.to(I64)
    widths = widths.to(I64)
    counts = torch.as_tensor(np.asarray(counts, np.int64)).to(dev)
    ns = int(counts.numel())
    stream = torch.repeat_interleave(torch.arange(ns, device=dev), counts)
    end = torch.cumsum(widths, 0)
    bits = torch.zeros(ns, dtype=I64, device=dev)
    bits.index_add_(0, stream, widths)
    # each stream starts on a word of its own
    words = (bits + 31) // 32
    word0 = torch.cumsum(words, 0) - words
    before = torch.cumsum(bits, 0) - bits  # bits of the earlier streams
    start = end - widths - before[stream] + 32 * word0[stream]
    values, widths, start = _split_wide(values, widths, start)
    q = start >> 5
    stop = (start & 31) + widths  # 1 .. 63
    out = torch.zeros(int(words.sum()) + 1, dtype=I64, device=dev)
    out.index_add_(0, q, torch.where(stop <= 32, values << (32 - stop).clamp(min=0), values >> (stop - 32).clamp(min=0)))
    spill = stop > 32
    out.index_add_(0, q[spill] + 1, (values[spill] << (64 - stop[spill])) & MASK32)
    shifts = torch.tensor([24, 16, 8, 0], dtype=I64, device=dev)
    raw = ((out[:-1, None] >> shifts) & 255).to(torch.uint8).reshape(-1).cpu().numpy()
    bits_h = bits.cpu().numpy()
    word0_h = word0.cpu().numpy()
    streams = []
    for s in range(ns):
        total = int(bits_h[s])
        b0 = 4 * int(word0_h[s])
        body = bytearray(raw[b0 : b0 + (total + 7) // 8].tobytes())
        rem = total % 8
        if 1 <= rem <= 5:
            body[-1] |= rem
        else:
            body.append(rem)
        streams.append(bytes(body))
    return streams


def pack(values: torch.Tensor, widths: torch.Tensor) -> bytes:
    """One stream's tokens -> its closed bit stream."""
    return pack_streams(values, widths, [int(values.numel())])[0]
