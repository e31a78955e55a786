"""Block partitioner + framed container format for block-parallel codecs.

The port's copy of tudocomp_tpu/parallel/blocks.py. Container layout
(bit-exact, deterministic block order):
    magic "TBK1" | vbyte(block_size) | vbyte(n_blocks)
    | per block: vbyte(payload_byte_len) | payload bytes
Each payload is a complete tudocomp bitstream (with the final-byte EOF
convention), so any per-block decoder, host or device, applies unchanged.
"""

from __future__ import annotations

import numpy as np

from ..io.vbyte import vbyte_decode_stream, vbyte_encode

MAGIC = b"TBK1"


def split_blocks(data, block_size: int):
    """Partition bytes into padded fixed-shape blocks.

    Returns (blocks [B, block_size] u8, n_valid [B] i32). Empty input yields
    a single empty block so the pipeline shape stays static.
    """
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)
    ) else np.asarray(data, dtype=np.uint8)
    n = len(arr)
    nb = max(1, -(-n // block_size))
    blocks = np.zeros((nb, block_size), dtype=np.uint8)
    n_valid = np.zeros(nb, dtype=np.int32)
    flat = blocks.reshape(-1)
    flat[:n] = arr
    full, rem = divmod(n, block_size)
    n_valid[:full] = block_size
    if rem or n == 0:
        n_valid[full if full < nb else nb - 1] = rem
    return blocks, n_valid


def frame_streams(payloads: list[bytes], block_size: int) -> bytes:
    """Concatenate per-block payloads into the framed container."""
    out = bytearray(MAGIC)
    out += vbyte_encode(block_size)
    out += vbyte_encode(len(payloads))
    for p in payloads:
        out += vbyte_encode(len(p))
        out += p
    return bytes(out)


def unframe_streams(data: bytes):
    """Parse a framed container -> (block_size, [payload bytes])."""
    if data[:4] != MAGIC:
        raise ValueError("not a TBK1 block container")
    arr = np.frombuffer(data, dtype=np.uint8)
    pos = 4
    block_size, used = vbyte_decode_stream(arr, pos)
    pos += used
    n_blocks, used = vbyte_decode_stream(arr, pos)
    pos += used
    payloads = []
    for _ in range(n_blocks):
        ln, used = vbyte_decode_stream(arr, pos)
        pos += used
        payloads.append(bytes(data[pos : pos + ln]))
        pos += ln
    return block_size, payloads
