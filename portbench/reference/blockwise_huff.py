"""Plain reference of `blockwise(encode(huff), bs=B)`: the container, from scratch.

The container is the algorithm id, '%', then TBK1: b"TBK1", vbyte(B),
vbyte(block count), and for each block vbyte(payload length) and the
payload. The input is cut into blocks of B bytes (the last one shorter; an
empty input is one empty block). A block's payload is a closed tudocomp
bit stream: its own Huffman table (huffman.Table) and then each of its
bytes' codes. The histograms and the codes are taken with plain PyTorch
on `device`, the tables in Python; the decompressed bytes of such a
container are the input itself.
"""

from __future__ import annotations

import numpy as np
import torch

from .bitstream import pack_streams
from .huffman import Table


def vbyte(v: int) -> bytes:
    """Little-endian 7-bit groups, the high bit set where another follows."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def frame(payloads: list, block_size: int) -> bytes:
    out = bytearray(b"TBK1") + vbyte(block_size) + vbyte(len(payloads))
    for p in payloads:
        out += vbyte(len(p)) + p
    return bytes(out)


def tables(counts: np.ndarray) -> list:
    return [Table(c) for c in counts]


def block_streams(data: bytes, block_size: int, device, table_fn=tables) -> list:
    """Each block's payload. `table_fn` maps the [blocks, 256] histograms
    to one Table a block (a control swaps it)."""
    arr = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data else torch.zeros(0, dtype=torch.uint8)
    x = arr.to(device).to(torch.int64)
    n = int(x.numel())
    nb = max(1, -(-n // block_size))
    blk = torch.arange(n, device=device) // block_size
    counts = torch.bincount(blk * 256 + x, minlength=nb * 256).view(nb, 256)
    tabs = table_fn(counts.cpu().numpy())
    code = torch.from_numpy(np.stack([t.code for t in tabs])).to(device)
    length = torch.from_numpy(np.stack([t.length for t in tabs])).to(device)
    head_v = [v for t in tabs for v, _ in t.header]
    head_w = [w for t in tabs for _, w in t.header]
    n_head = torch.tensor([len(t.header) for t in tabs], dtype=torch.int64, device=device)
    n_data = torch.bincount(blk, minlength=nb)
    per = n_head + n_data
    base = torch.cumsum(per, 0) - per  # first token of each block
    total = int(per.sum())
    values = torch.empty(total, dtype=torch.int64, device=device)
    widths = torch.empty(total, dtype=torch.int64, device=device)
    hblk = torch.repeat_interleave(torch.arange(nb, device=device), n_head)
    hpos = base[hblk] + torch.arange(len(head_v), device=device) - (torch.cumsum(n_head, 0) - n_head)[hblk]
    values[hpos] = torch.tensor(head_v, dtype=torch.int64, device=device)
    widths[hpos] = torch.tensor(head_w, dtype=torch.int64, device=device)
    dpos = base[blk] + n_head[blk] + torch.arange(n, device=device) - blk * block_size
    values[dpos] = code[blk, x]
    widths[dpos] = length[blk, x]
    return pack_streams(values, widths, per.cpu().numpy())


def compress(algorithm: str, data: bytes, config: dict, device) -> bytes:
    """The container `driver.compress(algorithm, data)` must return."""
    bs = int(config["block_size"])
    return algorithm.encode() + b"%" + frame(block_streams(data, bs, device), bs)


def control(algorithm: str, data: bytes, config: dict, device) -> bytes:
    """The control: every block coded with one table of the whole input
    (what shared=1 does), a decodable container that is not shared=0's."""
    bs = int(config["block_size"])

    def one_table(counts):
        return [Table(counts.sum(axis=0))] * len(counts)

    return algorithm.encode() + b"%" + frame(block_streams(data, bs, device, one_table), bs)
