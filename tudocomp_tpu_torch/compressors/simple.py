"""Streaming transform compressors: noop, rle, mtf, encode.

The port's copy of tudocomp_tpu/compressors/simple.py. Formats mirror the
reference byte-for-byte:
  - NoopCompressor (compressors/NoopCompressor.hpp): copy-through.
  - RunLengthEncoder (compressors/RunLengthEncoder.hpp:16-50): each run of
    the same character of length >= 2 is emitted as the character twice
    followed by vbyte(run_length - 2 + offset).
  - MTFCompressor (compressors/MTFCompressor.hpp:17-68): move-to-front over
    a 256-entry table initialized to identity.
  - LiteralEncoder (compressors/LiteralEncoder.hpp:12-42): per-byte
    coder.encode(c, literal_r); decode until eof.

The RLE run split and the MTF encode have device stages
(ops/transforms_torch.py; the MTF encode is kernel J on a card), each
behind its gate (device.use_rle_device, use_mtf_device); the vbyte
serialization and both decodes stay on the host (C++ where it builds).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..base import Compressor
from ..device import use_mtf_device, use_rle_device
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..io.vbyte import vbyte_decode_stream, vbyte_encode_array
from ..literals import ViewLiterals
from ..meta import Meta
from ..ranges import literal_r
from ..stats.phase import StatPhase


class NoopCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "noop")
        m.option("mode").dynamic("stream")
        m.option("debug").dynamic(False)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        out.write(inp.as_array())

    def decompress(self, inp: Input, out: Output) -> None:
        out.write(inp.as_array())


def rle_runs(data: np.ndarray, device="cpu"):
    """(starts, lengths, chars) of the runs of equal bytes of a non-empty
    data, on the host. The split runs on `device` where its gate opens
    (ops/transforms_torch.rle_runs_device: only the run lengths come back,
    the run characters are read here)."""
    n = len(data)
    if use_rle_device(n, torch.device(device)):
        from ..ops.transforms_torch import rle_runs_device, upload

        _, lens_d, _ = rle_runs_device(upload(data, device))
        run_lens = lens_d.cpu().numpy().astype(np.int64)
        run_starts = np.cumsum(run_lens) - run_lens
    else:
        change = np.empty(n, dtype=bool)
        change[0] = True
        np.not_equal(data[1:], data[:-1], out=change[1:])
        run_starts = np.flatnonzero(change)
        run_lens = np.diff(np.append(run_starts, n))
    return run_starts, run_lens, data[run_starts]


def rle_encode(data: np.ndarray, offset: int = 0, device="cpu") -> np.ndarray:
    """Vectorized RLE matching rle_encode (RunLengthEncoder.hpp:16-32): the
    runs from rle_runs (on `device` where its gate opens), the vbyte
    serialization on the host."""
    data = np.ascontiguousarray(data, np.uint8)
    if len(data) == 0:
        return data
    run_starts, run_lens, chars = rle_runs(data, device)
    # runs of length 1 -> char; runs >= 2 -> char char vbyte(len-2+offset)
    is_run = run_lens >= 2
    vbytes = vbyte_encode_array(run_lens[is_run] - 2 + offset)
    # assemble: per run, 1 or 2 chars + optional vbyte
    out_lens = np.where(is_run, 2, 1).astype(np.int64)
    vb_lens = np.zeros(len(run_starts), dtype=np.int64)
    vb_lens[is_run] = vbytes.lengths
    total = int(out_lens.sum() + vb_lens.sum())
    out = np.empty(total, dtype=np.uint8)
    piece_lens = out_lens + vb_lens
    starts = np.cumsum(piece_lens) - piece_lens
    out[starts] = chars
    out[starts[is_run] + 1] = chars[is_run]
    # scatter vbyte payloads
    vb_starts_out = starts[is_run] + 2
    if len(vb_starts_out):
        idx = np.repeat(vb_starts_out, vbytes.lengths) + vbytes.intra_offsets
        out[idx] = vbytes.bytes
    return out


def rle_decode(data: np.ndarray, offset: int = 0) -> np.ndarray:
    """RLE decode matching rle_decode (RunLengthEncoder.hpp:37-50): the C++
    cursor (tdc_rle_decode), or a Python walk over the run headers."""
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    if n == 0:
        return data
    lib = native.get_lib()
    if lib is not None:
        cap = max(64, 4 * n)
        while True:
            out = np.empty(cap, np.uint8)
            got = lib.tdc_rle_decode(data, n, offset, out, cap)
            if got >= 0:
                return out[:got]
            cap *= 4
    # a doubled character marks a run header followed by a vbyte; pairs
    # inside a vbyte payload are skipped by advancing past it
    out_parts = []
    pairs = np.flatnonzero(data[:-1] == data[1:])
    i = 0
    while i < n:
        k = int(np.searchsorted(pairs, i))
        if k == len(pairs):
            out_parts.append(data[i:])
            break
        j = int(pairs[k])  # data[j] == data[j+1]
        out_parts.append(data[i : j + 2])
        run, consumed = vbyte_decode_stream(data, j + 2)
        run -= offset
        if run > 0:
            out_parts.append(np.full(run, data[j], dtype=np.uint8))
        i = j + 2 + consumed
    return np.concatenate(out_parts) if out_parts else np.zeros(0, np.uint8)


class RunLengthEncoder(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "rle", "Run Length Encoding Compressor")
        m.option("offset").dynamic(0)
        return m

    def __init__(self, env):
        super().__init__(env)
        self.offset = env.option("offset").as_integer()

    def compress(self, inp: Input, out: Output) -> None:
        with StatPhase("rle_encode"):
            out.write(rle_encode(inp.as_array(), self.offset, self.env.registry.device))

    def decompress(self, inp: Input, out: Output) -> None:
        with StatPhase("rle_decode"):
            out.write(rle_decode(inp.as_array(), self.offset))


def mtf_encode(data: np.ndarray, device="cpu") -> np.ndarray:
    """MTF encode: on `device` where its gate opens
    (ops/transforms_torch.mtf_encode_device: kernel J on a card), else the
    C++ table walk (tdc_mtf_encode), else the plain version on the CPU."""
    data = np.ascontiguousarray(data, np.uint8)
    n = len(data)
    if n == 0:
        return data
    from ..ops.transforms_torch import mtf_encode_device, mtf_encode_plain, upload

    if use_mtf_device(n, torch.device(device)):
        return mtf_encode_device(upload(data, device)).cpu().numpy()
    lib = native.get_lib()
    if lib is not None:
        out = np.empty(n, np.uint8)
        lib.tdc_mtf_encode(data, n, out)
        return out
    return mtf_encode_plain(upload(data, "cpu")).numpy()


def mtf_decode(data: np.ndarray) -> np.ndarray:
    """MTF decode: the C++ table walk (tdc_mtf_decode), or the same walk in
    Python."""
    data = np.ascontiguousarray(data, np.uint8)
    lib = native.get_lib()
    if lib is not None and len(data):
        out = np.empty(len(data), np.uint8)
        lib.tdc_mtf_decode(data, len(data), out)
        return out
    table = list(range(256))
    out = np.empty(len(data), dtype=np.uint8)
    for i, v in enumerate(data):
        c = table.pop(v)
        table.insert(0, c)
        out[i] = c
    return out


class MTFCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        return Meta("compressor", "mtf", "Move To Front Compressor")

    def compress(self, inp: Input, out: Output) -> None:
        with StatPhase("mtf_encode"):
            out.write(mtf_encode(inp.as_array(), self.env.registry.device))

    def decompress(self, inp: Input, out: Output) -> None:
        with StatPhase("mtf_decode"):
            out.write(mtf_decode(inp.as_array()))


class LiteralEncoder(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta(
            "compressor", "encode", "Simply encodes the input's individual characters."
        )
        m.option("coder").templated("coder", None)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        data = inp.as_array()
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        w = BitWriter()
        enc = coder_cls.Encoder(coder_env, w, ViewLiterals(data))
        with StatPhase("encode"):
            enc.encode_array(data, literal_r)
            enc.finalize()
        out.write(w.getvalue())

    def decompress(self, inp: Input, out: Output) -> None:
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        r = BitReader(inp.as_bytes())
        dec = coder_cls.Decoder(coder_env, r)
        if hasattr(dec, "decode_literals_until_eof"):
            out.write(dec.decode_literals_until_eof())
            return
        width = dec.literal_fixed_width()
        if width:
            count = max(0, (r._valid - r.pos)) // width
            out.write(dec.decode_array(count, literal_r).astype(np.uint8))
            return
        chunks = []
        while not dec.eof():
            chunks.append(dec.decode(literal_r) & 0xFF)
        out.write(np.array(chunks, dtype=np.uint8))
