"""vbyte: 7-bits-per-byte varint on byte streams.

Mirror of include/tudocomp/util/vbyte.hpp:11-37: little-endian 7-bit groups,
the high bit of each byte marks that another byte follows. The port's copy
of tudocomp_tpu/io/vbyte.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class VByteArrays:
    """Flattened vbyte encodings of many integers."""

    bytes: np.ndarray  # all vbyte bytes concatenated (uint8)
    lengths: np.ndarray  # bytes per input value (int64)
    intra_offsets: np.ndarray  # position of each byte within its own vbyte


def vbyte_encode_array(values) -> VByteArrays:
    values = np.asarray(values, dtype=np.uint64)
    if len(values) == 0:
        z = np.zeros(0, dtype=np.int64)
        return VByteArrays(np.zeros(0, np.uint8), z, z)
    # number of 7-bit groups
    nbits = np.ones(len(values), dtype=np.int64)
    x = values >> np.uint64(7)
    while (x > 0).any():
        nbits += (x > 0).astype(np.int64)
        x >>= np.uint64(7)
    total = int(nbits.sum())
    sym = np.repeat(np.arange(len(values), dtype=np.int64), nbits)
    offsets = np.cumsum(nbits) - nbits
    intra = np.arange(total, dtype=np.int64) - offsets[sym]
    groups = (values[sym] >> (intra * 7).astype(np.uint64)) & np.uint64(0x7F)
    is_last = intra == (nbits[sym] - 1)
    out = np.where(is_last, groups, groups | np.uint64(0x80)).astype(np.uint8)
    return VByteArrays(out, nbits, intra)


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
