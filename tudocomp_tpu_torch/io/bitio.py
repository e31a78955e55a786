"""Bit-level IO reproducing tudocomp's bitstream format exactly.

Reference semantics (tudocomp):
  - MSB-first bit order within each byte
    (include/tudocomp/io/BitOStream.hpp:79-88, cursor starts at 7).
  - EOF convention (include/tudocomp/io/BitOStream.hpp:53-64): on close, the
    number of valid bits in the final partial byte ("set" = bits written mod
    8) is stored in the low 3 bits of the final byte. If set <= 5 it is OR'ed
    into the partial byte itself; if set is 6 or 7 (low bits occupied), the
    partial byte is flushed and an extra marker byte containing just `set`
    is appended; if set == 0 a 0x00 marker byte is appended. An empty stream
    therefore serializes to the single byte 0x00.
  - Reader mirror: include/tudocomp/io/BitIStream.hpp:27-63,191-193.
  - Integer codes: write_int (MSB-first binary), write_unary (v zeros then a
    one), write_ternary (base-3 digits in 2-bit codes, terminator 0b11),
    write_elias_gamma (unary(bits_for(v)) + v in bits_for(v) bits),
    write_elias_delta (gamma(bits_for(v)) + v), write_compressed_int
    (little-endian b-bit blocks, each preceded by a continuation flag bit)
    (include/tudocomp/io/BitOStream.hpp:104-163).

This implementation buffers (value, nbits) pairs and packs them at finalize
time, through the port's C++ host helper (native.py) or with numpy; the
device pack is ops/bitpack.py. The port's copy of tudocomp_tpu/io/bitio.py.
"""

from __future__ import annotations

import numpy as np

__all__ = ["bits_for", "bits_for_arr", "BitWriter", "BitReader", "valid_bit_count"]


def bits_for(n: int) -> int:
    """Bits required to store n; bits_for(0) == 1 (util.hpp:194)."""
    n = int(n)
    return 1 if n == 0 else n.bit_length()


def bits_for_arr(arr) -> np.ndarray:
    """Vectorized bits_for over a numpy array of non-negative ints."""
    a = np.asarray(arr, dtype=np.uint64)
    out = np.zeros(a.shape, dtype=np.int64)
    x = a.copy()
    while True:
        nz = x > 0
        if not nz.any():
            break
        out[nz] += 1
        x >>= np.uint64(1)
    return np.maximum(out, 1)


_FLUSH_THRESHOLD = 8192


def _pack_token_bits(values: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """Expand (value, nbits) token arrays into a flat MSB-first bit array."""
    nbits = nbits.astype(np.int64)
    total = int(nbits.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8)
    offsets = np.cumsum(nbits) - nbits  # exclusive prefix sum
    sym = np.repeat(np.arange(len(values), dtype=np.int64), nbits)
    pos_in_sym = np.arange(total, dtype=np.int64) - offsets[sym]
    shifts = (nbits[sym] - 1 - pos_in_sym).astype(np.uint64)
    return ((values[sym] >> shifts) & np.uint64(1)).astype(np.uint8)


def valid_bit_count(data: bytes) -> int:
    """Number of valid payload bits in a tudocomp bitstream byte string.

    Mirrors BitIStream's final-byte handling
    (include/tudocomp/io/BitIStream.hpp:27-63,191-193).
    """
    n = len(data)
    if n == 0:
        return 0
    final_bits = data[-1] & 0x7
    if final_bits >= 6:
        return 8 * (n - 2) + final_bits
    return 8 * (n - 1) + final_bits


class BitWriter:
    """Buffered bit writer producing tudocomp-format bytes."""

    def __init__(self):
        self._chunks: list[tuple[np.ndarray, np.ndarray]] = []
        self._vals: list[int] = []
        self._bits: list[int] = []
        self._nbits_total = 0

    # -- core -------------------------------------------------------------

    @property
    def bit_len(self) -> int:
        return self._nbits_total

    def _flush_scalars(self):
        if self._vals:
            self._chunks.append(
                (
                    np.array(self._vals, dtype=np.uint64),
                    np.array(self._bits, dtype=np.int64),
                )
            )
            self._vals = []
            self._bits = []

    def write_bit(self, b) -> None:
        self._vals.append(1 if b else 0)
        self._bits.append(1)
        self._nbits_total += 1
        if len(self._vals) >= _FLUSH_THRESHOLD:
            self._flush_scalars()

    def write_int(self, v: int, bits: int) -> None:
        v = int(v)
        bits = int(bits)
        if bits <= 0:
            return
        while bits > 64:
            # leading chunk beyond 64 bits
            hi_bits = bits - 64
            take = min(hi_bits, 64)
            self._vals.append((v >> (bits - take)) & ((1 << take) - 1))
            self._bits.append(take)
            self._nbits_total += take
            bits -= take
        self._vals.append(v & ((1 << bits) - 1) if bits < 64 else v & 0xFFFFFFFFFFFFFFFF)
        self._bits.append(bits)
        self._nbits_total += bits
        if len(self._vals) >= _FLUSH_THRESHOLD:
            self._flush_scalars()

    def write_ints(self, values, nbits, masked: bool = False) -> None:
        """Vectorized write of many (value, nbits<=64) tokens.

        With masked=True the caller guarantees each value already fits its
        declared width (skips the masking pass)."""
        if values.dtype != np.uint64 if isinstance(values, np.ndarray) else True:
            values = np.asarray(values, dtype=np.uint64)
        values = values.ravel()
        if np.isscalar(nbits) or getattr(nbits, "ndim", 0) == 0:
            nb = np.full(values.shape, int(nbits), dtype=np.int64)
        else:
            nb = np.asarray(nbits, dtype=np.int64).ravel()
        if len(values) == 0:
            return
        if not masked:
            mask = np.where(
                nb >= 64,
                np.uint64(0xFFFFFFFFFFFFFFFF),
                (np.uint64(1) << nb.astype(np.uint64)) - np.uint64(1),
            )
            values = values & mask
        self._flush_scalars()
        self._chunks.append((values, nb))
        self._nbits_total += int(nb.sum())

    # -- universal codes ----------------------------------------------------

    def write_unary(self, v: int) -> None:
        # v zero bits followed by a one bit (BitOStream.hpp:104-111)
        v = int(v)
        while v >= 64:
            self.write_int(0, 64)
            v -= 64
        self.write_int(1, v + 1)

    def write_ternary(self, v: int) -> None:
        # base-3 little-endian digits as 2-bit codes, terminator 0b11
        # (BitOStream.hpp:113-123)
        v = int(v)
        if v:
            v -= 1
            while True:
                self.write_int(v % 3, 2)
                v //= 3
                if not v:
                    break
        self.write_int(3, 2)

    def write_elias_gamma(self, v: int) -> None:
        nb = bits_for(v)
        self.write_unary(nb)
        self.write_int(v, nb)

    def write_elias_delta(self, v: int) -> None:
        nb = bits_for(v)
        self.write_elias_gamma(nb)
        self.write_int(v, nb)

    def write_unaries(self, values) -> None:
        """Vectorized unary write: each v becomes v zeros + a one, the bits
        write_unary writes (v // 64 zero tokens of 64 bits, then a one in
        v % 64 + 1 bits)."""
        values = np.asarray(values, dtype=np.int64).ravel()
        if not len(values):
            return
        zeros = values // 64
        ones_at = np.cumsum(zeros + 1) - 1  # each value's last token
        nb = np.full(int(ones_at[-1]) + 1, 64, np.int64)
        nb[ones_at] = values % 64 + 1
        tok = np.zeros(len(nb), np.uint64)
        tok[ones_at] = 1
        self.write_ints(tok, nb, masked=True)

    def write_compressed_int(self, v: int, b: int = 7) -> None:
        # flag bit (1 = more blocks) + b-bit block, little-endian blocks
        # (BitOStream.hpp:150-163)
        v = int(v)
        assert b > 0
        while True:
            current = v & ((1 << b) - 1)
            v >>= b
            self.write_bit(v > 0)
            self.write_int(current, b)
            if v <= 0:
                break

    # -- vectorized universal codes ------------------------------------------

    def write_elias_gammas(self, values) -> None:
        """Vectorized interleaved gamma codes: per value unary(nb) then v in nb bits."""
        values = np.asarray(values, dtype=np.uint64).ravel()
        if len(values) == 0:
            return
        nb = bits_for_arr(values)
        # unary(nb) == the integer 1 written in nb+1 bits (nb zeros + a one)
        vals2 = np.stack([np.ones(len(values), np.uint64), values], axis=1).ravel()
        bits2 = np.stack([nb + 1, nb], axis=1).ravel()
        self.write_ints(vals2, bits2)

    def write_elias_deltas(self, values) -> None:
        """Vectorized interleaved delta codes: gamma(nb) then v in nb bits."""
        values = np.asarray(values, dtype=np.uint64).ravel()
        if len(values) == 0:
            return
        nb = bits_for_arr(values)
        nnb = bits_for_arr(nb)
        vals3 = np.stack(
            [np.ones(len(values), np.uint64), nb.astype(np.uint64), values], axis=1
        ).ravel()
        bits3 = np.stack([nnb + 1, nnb, nb], axis=1).ravel()
        self.write_ints(vals3, bits3)

    # -- finalize -------------------------------------------------------------

    def bit_array(self) -> np.ndarray:
        """All written bits as a flat uint8 array (no EOF convention applied)."""
        self._flush_scalars()
        parts = [_pack_token_bits(v, b) for v, b in self._chunks]
        if not parts:
            return np.zeros(0, dtype=np.uint8)
        return np.concatenate(parts)

    def getvalue(self) -> bytes:
        self._flush_scalars()
        total = self._nbits_total
        from .. import native

        lib = native.get_lib()
        if lib is not None and hasattr(lib, "tdc_pack_tokens"):
            nbytes = (total + 7) // 8
            out = np.zeros(max(nbytes, 1), dtype=np.uint8)
            pos = 0
            for v, b in self._chunks:
                if len(v) == 0:
                    continue
                pos = lib.tdc_pack_tokens(
                    np.ascontiguousarray(v, np.uint64),
                    np.ascontiguousarray(b, np.int64),
                    len(v),
                    out,
                    pos,
                )
            assert pos == total, (pos, total)
            packed = out[:nbytes]
        else:
            bits = self.bit_array()
            packed = np.packbits(bits) if total else np.zeros(0, dtype=np.uint8)
        rem = total % 8
        if 1 <= rem <= 5:
            packed[-1] |= rem
            return packed.tobytes()
        elif rem >= 6:
            return packed.tobytes() + bytes([rem])
        else:
            return packed.tobytes() + b"\x00"


_POW2 = (np.uint64(1) << np.arange(64, dtype=np.uint64))[::-1].copy()


class BitReader:
    """Bit reader over a complete tudocomp bitstream byte string."""

    def __init__(self, data: bytes):
        self._data = bytes(data)
        self._valid = valid_bit_count(self._data)
        self._pos = 0
        self._bits_cache = None  # lazy unpacked bit array (vector paths)
        self._ones = None  # lazy: positions of 1-bits for fast unary reads
        # set when any read crosses the valid end — streams never do this
        # legitimately (the EOF convention bounds every decode loop), so
        # it marks a truncated/corrupt container for the decoders to check
        self.overran = False

    @property
    def _bits(self) -> np.ndarray:
        if self._bits_cache is None:
            arr = np.frombuffer(self._data, dtype=np.uint8)
            self._bits_cache = (
                np.unpackbits(arr) if len(arr) else np.zeros(0, dtype=np.uint8)
            )
        return self._bits_cache

    @property
    def pos(self) -> int:
        return self._pos

    def eof(self) -> bool:
        return self._pos >= self._valid

    def read_bit(self) -> int:
        if self._pos >= self._valid:
            self.overran = True
            return 0
        p = self._pos
        self._pos = p + 1
        return (self._data[p >> 3] >> (7 - (p & 7))) & 1

    def read_int(self, bits: int) -> int:
        bits = int(bits)
        if bits == 0:
            return 0
        pos = self._pos
        end = pos + bits
        first = pos >> 3
        lastb = (end + 7) >> 3
        raw = int.from_bytes(self._data[first:lastb], "big")
        have = (min(lastb, len(self._data)) - first) * 8
        span = end - first * 8
        if have < span:  # past buffer end: pad zeros
            raw <<= span - have
            have = span
        v = (raw >> (have - span)) & ((1 << bits) - 1)
        # bits past EOF read as 0 (BitIStream.hpp:107)
        if end > self._valid:
            self.overran = True
            over = end - max(self._valid, pos)
            if over >= bits:
                v = 0
            else:
                v &= ~((1 << over) - 1)
            self._pos = self._valid
        else:
            self._pos = end
        return v

    def read_ints(self, count: int, bits: int) -> np.ndarray:
        """Vectorized read of `count` fixed-width integers."""
        bits = int(bits)
        count = int(count)
        if count == 0 or bits == 0:
            self._pos += count * bits
            return np.zeros(count, dtype=np.uint64)
        if bits == 8 and (self._pos & 7) == 0:
            # byte-aligned literal runs (vbyte/ascii/degenerate-huff):
            # a direct byte-slice, no bit unpack / matmul
            p8 = self._pos >> 3
            arr = np.frombuffer(self._data, np.uint8)[p8 : p8 + count]
            if len(arr) < count:
                arr = np.concatenate(
                    [arr, np.zeros(count - len(arr), np.uint8)]
                )
            self._pos += count * 8
            return arr.astype(np.uint64)
        need = count * bits
        chunk = self._bits[self._pos : self._pos + need]
        if len(chunk) < need:
            chunk = np.concatenate([chunk, np.zeros(need - len(chunk), np.uint8)])
        self._pos += need
        m = chunk.reshape(count, bits).astype(np.uint64)
        return m @ _POW2[64 - bits :]

    def read_tokens(self, widths) -> np.ndarray:
        """Batched read of variable-width tokens (native fast path)."""
        widths = np.ascontiguousarray(widths, dtype=np.int64)
        n = len(widths)
        if n == 0:
            return np.zeros(0, np.uint64)
        from .. import native

        lib = native.get_lib()
        if lib is not None and hasattr(lib, "tdc_read_tokens"):
            out = np.empty(n, np.uint64)
            data = np.frombuffer(self._data, dtype=np.uint8)
            end = lib.tdc_read_tokens(data, len(data), self._pos, widths, n, out)
            # zero out bits past the valid region (EOF semantics)
            self._pos = min(end, self._valid)
            return out
        return np.array([self.read_int(int(w)) for w in widths], np.uint64)

    def read_unary(self) -> int:
        if self._ones is None:
            self._ones = np.flatnonzero(self._bits[: self._valid])
        idx = np.searchsorted(self._ones, self._pos)
        if idx >= len(self._ones):
            # no terminating 1 before EOF: reference would spin reading 0s
            v = self._valid - self._pos
            self._pos = self._valid
            return v
        one_pos = int(self._ones[idx])
        v = one_pos - self._pos
        self._pos = one_pos + 1
        return v

    def read_ternary(self) -> int:
        mod = self.read_int(2)
        v = 0
        if mod < 3:
            b = 1
            while True:
                v += mod * b
                b *= 3
                mod = self.read_int(2)
                if mod == 3:
                    break
            v += 1
        return v

    def read_elias_gamma(self) -> int:
        nb = self.read_unary()
        return self.read_int(nb)

    def read_elias_delta(self) -> int:
        nb = self.read_elias_gamma()
        return self.read_int(nb)

    def read_unaries(self, count: int) -> np.ndarray:
        """Vectorized read of `count` unary codes (mirror of read_unary)."""
        count = int(count)
        if count == 0:
            return np.zeros(0, dtype=np.int64)
        if self._ones is None:
            self._ones = np.flatnonzero(self._bits[: self._valid])
        idx = np.searchsorted(self._ones, self._pos)
        if idx + count > len(self._ones):
            return np.array([self.read_unary() for _ in range(count)], np.int64)
        ones = self._ones[idx : idx + count].astype(np.int64)
        starts = np.concatenate([[self._pos], ones[:-1] + 1])
        self._pos = int(ones[-1]) + 1
        return ones - starts

    def read_compressed_int(self, b: int = 7) -> int:
        assert b > 0
        value = 0
        i = 0
        while True:
            has_next = self.read_bit()
            value |= self.read_int(b) << (b * i)
            i += 1
            if not has_next:
                break
        return value
