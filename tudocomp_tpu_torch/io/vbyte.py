"""vbyte: 7-bits-per-byte varint on byte streams.

Mirror of include/tudocomp/util/vbyte.hpp:11-37: little-endian 7-bit groups,
the high bit of each byte marks that another byte follows. The port's copy
of tudocomp_tpu/io/vbyte.py.
"""

from __future__ import annotations

import numpy as np


def vbyte_encode(v: int) -> bytes:
    out = bytearray()
    v = int(v)
    while True:
        b = v & 0x7F
        v >>= 7
        if v > 0:
            b |= 0x80
        out.append(b)
        if v <= 0:
            break
    return bytes(out)


def vbyte_decode_stream(data: np.ndarray, pos: int) -> tuple[int, int]:
    """Decode one vbyte at data[pos:]; returns (value, bytes_consumed)."""
    v = 0
    i = 0
    while True:
        b = int(data[pos + i])
        v |= (b & 0x7F) << (7 * i)
        i += 1
        if not (b & 0x80):
            return v, i
