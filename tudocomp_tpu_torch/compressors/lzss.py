"""LZSS sliding-window compressor (id "lzss").

The port's copy of tudocomp_tpu/compressors/lzss.py, host only. Format
mirror of compressors/LZSSSlidingWindowCompressor.hpp:39-144: online
parse with a `window`-size back buffer (default 16) and brute-force longest
match >= `threshold` (default 3, leftmost preferred); per token either
  1-bit | delta in Range(pos) | len in Range(window)       (factor)
  0-bit | literal (literal_r)                              (literal)
Decode grows a back buffer until stream EOF. The parse runs in the C++
host helpers (csrc/host/tdc_host.cpp tdc_lzss_window_parse) with a Python
fallback; token emission is vectorized through the coder token API.
"""

from __future__ import annotations

import numpy as np

from ..base import Compressor
from ..coders.base import write_segmented
from ..io.bitio import BitReader, BitWriter
from ..io.inout import Input, Output
from ..literals import NoLiterals
from ..meta import Meta
from ..ranges import Range, bit_r, literal_r
from ..stats.phase import StatPhase
from .. import native


def window_parse(data: np.ndarray, window: int, threshold: int):
    """Returns (kind, pos, delta, length) token arrays."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    if n == 0:
        z = np.zeros(0, np.uint32)
        return np.zeros(0, np.uint8), z, z, z
    lib = native.get_lib()
    if lib is not None:
        kind = np.empty(n, np.uint8)
        pos = np.empty(n, np.uint32)
        delta = np.empty(n, np.uint32)
        length = np.empty(n, np.uint32)
        nt = lib.tdc_lzss_window_parse(data, n, window, threshold, kind, pos, delta, length)
        return kind[:nt].copy(), pos[:nt].copy(), delta[:nt].copy(), length[:nt].copy()
    kind_l, pos_l, delta_l, len_l = [], [], [], []
    ahead = 0
    while ahead < n:
        limit = min(ahead + window, n)
        fnum, fsrc = 0, 0
        for k in range(max(0, ahead - window), ahead):
            j = 0
            while ahead + j < limit and data[k + j] == data[ahead + j]:
                j += 1
            if j >= threshold and j > fnum:
                fnum, fsrc = j, k
        if fnum:
            kind_l.append(1)
            pos_l.append(ahead)
            delta_l.append(ahead - fsrc)
            len_l.append(fnum)
            ahead += fnum
        else:
            kind_l.append(0)
            pos_l.append(ahead)
            delta_l.append(0)
            len_l.append(int(data[ahead]))
            ahead += 1
    return (
        np.array(kind_l, np.uint8),
        np.array(pos_l, np.uint32),
        np.array(delta_l, np.uint32),
        np.array(len_l, np.uint32),
    )


class LZSSSlidingWindowCompressor(Compressor):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "lzss", "Lempel-Ziv-Storer-Szymanski (Sliding Window)")
        m.option("coder").templated("coder")
        m.option("window").dynamic(16)
        m.option("threshold").dynamic(3)
        return m

    def compress(self, inp: Input, out: Output) -> None:
        window = self.env.option("window").as_integer()
        threshold = self.env.option("threshold").as_integer()
        data = inp.as_array()
        with StatPhase("Factorize") as phase:
            kind, pos, delta, length = window_parse(data, window, threshold)
            phase.log("threshold", threshold)
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        w = BitWriter()
        enc = coder_cls.Encoder(coder_env, w, NoLiterals())
        nt = len(kind)
        is_f = kind == 1
        win_r = Range(window)
        # columns: flag bit | delta (growing Range(pos)) | len | literal
        ok = write_segmented(
            w,
            enc,
            [
                (is_f.astype(np.uint64), bit_r, np.ones(nt, np.int64)),
                (delta[is_f], pos[is_f].astype(np.int64), is_f.astype(np.int64)),
                (length[is_f], win_r, is_f.astype(np.int64)),
                (length[~is_f], literal_r, (~is_f).astype(np.int64)),
            ],
        )
        if not ok:
            for t in range(nt):
                if kind[t]:
                    enc.encode(1, bit_r)
                    enc.encode(int(delta[t]), Range(int(pos[t])))
                    enc.encode(int(length[t]), win_r)
                else:
                    enc.encode(0, bit_r)
                    enc.encode(int(length[t]), literal_r)
        enc.finalize()
        out.write(w.getvalue())

    def decompress(self, inp: Input, out: Output) -> None:
        window = self.env.option("window").as_integer()
        coder_cls, coder_env = self.env.algorithm_for_option("coder")
        r = BitReader(inp.as_bytes())
        dec = coder_cls.Decoder(coder_env, r)
        win_r = Range(window)
        text = bytearray()
        while not dec.eof():
            if dec.decode(bit_r):
                delta = dec.decode(Range(len(text)))
                num = dec.decode(win_r)
                src = len(text) - delta
                for i in range(num):
                    text.append(text[src + i])
            else:
                text.append(dec.decode(literal_r))
        out.write(bytes(text))
