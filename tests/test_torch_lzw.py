"""Kernel F's schedule (csrc/lz78.cu, parse_warp<true>), emulated lane by lane.

The CUDA kernel cannot run here. This emulation follows its warp walk step
by step: 32 lanes, the ring of prefix hashes that a refill fills 128 bytes
at a time with a shuffle scan (each ring read checked to lie in the ring's
live window), ballots as bit masks, linear probing in a table of 64-bit
slots with the kernel's collision and restart rules, and the table sized
by ops/lz78_cuda.lzw_table_log2 (or shrunk, to force long probe runs and
wrap-around). Its codes are held to the host lzw_parse and to the JAX
package's _lzw_kernel in interpret mode. The same walk with LZW false is
kernel E's (parse_warp<false>), held to the host lz78_parse. Tolerance:
exact equality, since codes are integers.
"""

import os

import numpy as np
import pytest

from tudocomp_tpu.compressors.lz78 import lz78_parse
from tudocomp_tpu.compressors.lzw import lzw_parse
from tudocomp_tpu.ops.lz78_pallas import lzw_parse_blocks_device as jax_lzw_blocks
from tudocomp_tpu_torch.ops import lz78_cuda as lc

from tests import torch_cases as tc

M64 = (1 << 64) - 1
P = 0x9E3779B97F4A7C15
MIX = 0xBF58476D1CE4E5B9
EMPTY = M64
RING, CHUNK, LANES = 256, 128, 32


class _Window:
    """The warp's rings: G(i) and t[i] by position, each entry tagged with
    the position it holds, so that a read of a position the ring has
    dropped, or not filled yet, fails."""

    def __init__(self, t, n):
        self.t, self.n = t, n
        self.g, self.c = [None] * RING, [None] * RING
        self.g[0] = (0, 0)  # G(0)
        self.hi, self.g_hi = 0, 0

    def refill(self):
        q = [[int(self.t[i]) if i < self.n else 0 for i in range(self.hi + 4 * k, self.hi + 4 * k + 4)]
             for k in range(LANES)]
        x = [0] * LANES
        for k in range(LANES):
            for m in range(4):
                x[k] = (x[k] * P + q[k][m] + 1) & M64
        a, d = pow(P, 4, 1 << 64), 1
        while d < LANES:  # the shuffle scan: every lane reads the values before this step
            y = list(x)
            for k in range(d, LANES):
                x[k] = (x[k] + y[k - d] * a) & M64
            a, d = a * a & M64, 2 * d
        end = [(self.g_hi * pow(P, 4 * k + 4, 1 << 64) + x[k]) & M64 for k in range(LANES)]
        for k in range(LANES):
            gi = self.g_hi if k == 0 else end[k - 1]
            i0 = self.hi + 4 * k
            for m in range(4):
                self.c[(i0 + m) % RING] = (i0 + m, q[k][m])
                gi = (gi * P + q[k][m] + 1) & M64
                self.g[(i0 + m + 1) % RING] = (i0 + m + 1, gi)
        self.g_hi = end[-1]
        self.hi += CHUNK

    def G(self, i):
        at, v = self.g[i % RING]
        assert at == i and self.hi - RING < i <= self.hi, (i, self.hi)
        return v

    def C(self, i):
        at, v = self.c[i % RING]
        assert at == i and self.hi - RING <= i < self.hi, (i, self.hi)
        return v


def emulate_walk(t, n, log2_slots, lzw=True):
    """The kernel's walk of one block: (out, chars, stats). F: out the
    codes, chars None. E: out the factors' parents, chars their bytes.
    stats: rounds, table loads, probe steps past the home slot, the longest
    probe run, whether a probe wrapped past the table's end, the longest
    entry. A table of at most 2^BITMAP_LOG2 slots starts as garbage (the
    wrapper leaves it unfilled) with an empty occupancy bitmap: a slot whose
    bit is clear reads as empty without a load."""
    off, first_id = (1, 256) if lzw else (0, 1)
    mask = (1 << log2_slots) - 1
    bitmap = log2_slots <= lc.BITMAP_LOG2
    if bitmap:
        rng = np.random.default_rng(log2_slots)
        tab = [int(x) for x in rng.integers(0, 1 << 63, mask + 1, dtype=np.int64)]  # torch.empty
        occupied = [False] * (mask + 1)
    else:
        tab = [EMPTY] * (mask + 1)

    def load(h):
        if bitmap and not occupied[h]:
            return EMPTY
        stats["loads"] += 1
        return tab[h]

    w = _Window(t, n)
    out, chars = [], None if lzw else []
    stats = {"rounds": 0, "loads": 0, "probe_steps": 0, "longest_run": 0, "wrapped": False}
    maxlen, s = off, 0
    while s < n:
        node, base, gs = 0, 0, 0
        while True:
            stats["rounds"] += 1
            need = min(n, s + base + off + LANES)
            while w.hi < need:
                w.refill()
            if base == 0:
                gs = w.G(s)
                if lzw:
                    node = w.C(s)
            pos = [s + base + off + k for k in range(LANES)]
            valid = [p < n for p in pos]
            c = [w.C(p) if v else 0 for p, v in zip(pos, valid)]
            h, e, run = [0] * LANES, [EMPTY] * LANES, [0] * LANES
            for k in range(LANES):
                if valid[k] and base + off + k <= maxlen:
                    x = (w.G(pos[k] + 1) - gs * pow(P, base + off + k + 1, 1 << 64)) & M64
                    x = ((x ^ (x >> 29)) * MIX) & M64
                    h[k] = x >> (64 - log2_slots)
                    e[k] = load(h[k])
            while True:
                child = [x & 0xFFFFFF for x in e]
                prev = [node] + child[:-1]
                full = [x != EMPTY for x in e]
                byte_ok = [(x >> 24) & 0xFF == ck for x, ck in zip(e, c)]
                parent_ok = [(x >> 32) == p for x, p in zip(e, prev)]
                fail = [valid[k] and not (full[k] and byte_ok[k] and parent_ok[k]) for k in range(LANES)]
                f = fail.index(True) if any(fail) else LANES
                if f == LANES or not full[f]:
                    break
                empty = [valid[k] and not full[k] for k in range(LANES)]
                g = empty.index(True) if any(empty) else LANES
                for k in range(LANES):
                    if k < g and full[k] and (not byte_ok[k] or (k <= f and not parent_ok[k])):
                        stats["wrapped"] |= h[k] == mask
                        h[k] = (h[k] + 1) & mask
                        e[k] = load(h[k])
                        run[k] += 1
                        stats["probe_steps"] += 1
                        stats["longest_run"] = max(stats["longest_run"], run[k])
            if f < LANES:  # prefix f is absent
                tab[h[f]] = (prev[f] << 32) | (c[f] << 24) | (first_id + len(out))
                if bitmap:
                    occupied[h[f]] = True
                out.append(prev[f])
                if not lzw:
                    chars.append(c[f])
                maxlen = max(maxlen, base + off + f + 1)
                s += base + f + 1
                break
            nv = n - (s + base + off)
            last = child[min(max(nv - 1, 0), LANES - 1)]
            if nv >= LANES:
                node, base = last, base + LANES
                continue
            if nv > 0:
                node = last
            if lzw:
                out.append(node)
            else:
                out.append(out[node - 1])
                chars.append(chars[node - 1])
            s = n
            break
    stats["longest_entry"] = maxlen
    stats["entries"] = sum(occupied) if bitmap else sum(x != EMPTY for x in tab)
    return out, chars, stats


def _emulate_blocks(blocks, n_valid, log2_slots=None):
    bs = blocks.shape[1]
    log2 = lc.lzw_table_log2(bs) if log2_slots is None else log2_slots
    return [emulate_walk(blocks[b], int(n_valid[b]), log2) for b in range(len(blocks))]


@pytest.mark.parametrize("name", tc.LZW_CASES)
def test_kernel_f_schedule(name):
    """The emulated walk gives the host lzw_parse's codes on every case, and
    its dictionary holds one entry a phrase but the last."""
    blocks, n_valid = tc.lzw_case(name)
    for b, (codes, _, st) in enumerate(_emulate_blocks(blocks, n_valid)):
        want = lzw_parse(blocks[b, : n_valid[b]])
        np.testing.assert_array_equal(np.array(codes, np.uint32), want, err_msg=f"block {b}")
        assert st["entries"] == max(len(codes) - 1, 0) <= lc.lzw_z_max(int(n_valid[b]))


def test_kernel_f_schedule_matches_lockstep_kernel():
    """The JAX package's _lzw_kernel (interpret mode) on the cases of at
    most 4 KiB a block, padded into one batch, against the emulation."""
    cases = [tc.lzw_case(name) for name in tc.LZW_CASES]
    bs = max(b.shape[1] for b, _ in cases)
    blocks = np.zeros((sum(len(b) for b, _ in cases), bs), np.uint8)
    n_valid = np.concatenate([nv for _, nv in cases]).astype(np.int32)
    row = 0
    for b, _ in cases:
        blocks[row : row + len(b), : b.shape[1]] = b
        row += len(b)
    want = jax_lzw_blocks(blocks, n_valid, interpret=True)
    for b, (codes, _, _) in enumerate(_emulate_blocks(blocks, n_valid)):
        np.testing.assert_array_equal(np.array(codes, np.uint32), want[b], err_msg=f"block {b}")


def test_kernel_f_schedule_walks():
    """What the cases make the walk do: phrases past two warps' 64 lanes
    (base 64), a block ending exactly on a phrase and one past it, and the
    random bytes' dictionary near lzw_z_max."""
    run = _emulate_blocks(*tc.lzw_case("run"))
    assert run[0][2]["longest_entry"] > 2 * 32
    on, past = _emulate_blocks(*tc.lzw_case("run-ends-on-phrase"))
    assert len(on[0]) == 76 and len(past[0]) == 77 and past[0][-1] == ord("a")  # one byte past: a root
    rand = _emulate_blocks(*tc.lzw_case("random"))
    assert rand[0][2]["entries"] >= 0.95 * lc.lzw_z_max(4096)
    assert [len(c) for c, _, _ in _emulate_blocks(*tc.lzw_case("short"))] == [0, 1, 2]


@pytest.mark.parametrize("name,log2", [("random", 12), ("english", 10), ("corpus", 9)])
def test_kernel_f_shrunk_table(name, log2):
    """The least power of two of slots above the entries, 74-97% full:
    long probe runs that wrap past the table's end, the codes still the
    host's."""
    blocks, n_valid = tc.lzw_case(name)
    walks = _emulate_blocks(blocks, n_valid, log2)
    for b, (codes, _, st) in enumerate(walks):
        np.testing.assert_array_equal(np.array(codes, np.uint32), lzw_parse(blocks[b, : n_valid[b]]))
        assert st["entries"] < 1 << log2
    assert max(st["longest_run"] for _, _, st in walks) >= 32
    assert any(st["wrapped"] for _, _, st in walks)


@pytest.mark.parametrize("name", ["corpus", "run", "random", "short", "english"])
def test_kernel_e_schedule(name):
    """The same walk with LZW false is kernel E's: the host lz78_parse's
    factors, the trailing partial factor included, at E's table size."""
    blocks, n_valid = tc.lzw_case(name)
    log2 = lc.table_log2(blocks.shape[1])
    for b in range(len(blocks)):
        parents, chars, _ = emulate_walk(blocks[b], int(n_valid[b]), log2, lzw=False)
        hp, hc = lz78_parse(blocks[b, : n_valid[b]])
        np.testing.assert_array_equal(np.array(parents, np.uint32), hp)
        np.testing.assert_array_equal(np.array(chars, np.uint8), hc)


def _lzw_z_closed(bs):
    """lzw_z_max by its closed form below 4-byte entries."""
    if bs <= 1:
        return 0
    if bs - 1 <= 65536:
        return bs - 1
    return 65536 + (bs - 1 - 65536) // 2


@pytest.mark.parametrize("bs", [0, 1, 2, 3, 64, 4096, 8192, 65536, 65537, 65538, 65539, 1 << 20, 1 << 22])
def test_kernel_f_table_size(bs):
    """Kernel F's table: lzw_z_max(bs) entries at most (its closed form), a
    power of two of slots at most 55% full at lzw_z_max + 1 entries, and no
    power of two below it is; 2^14 slots at 8 KiB, 2^22 at 4 MiB."""
    z = lc.lzw_z_max(bs)
    assert z == _lzw_z_closed(bs)
    slots = 1 << lc.lzw_table_log2(bs)
    assert 20 * (z + 1) <= 11 * slots
    assert slots == 16 or 20 * (z + 1) > 11 * (slots // 2)
    assert (lc.lzw_z_max(8192), 1 << lc.lzw_table_log2(8192)) == (8191, 1 << 14)
    assert (lc.lzw_z_max(1 << 22), 1 << lc.lzw_table_log2(1 << 22)) == (2129919, 1 << 22)


@pytest.mark.parametrize("bs", [64, 256, 1000, 4096, 8192])
def test_kernel_f_table_holds_every_parse(bs):
    """lzw_z_max bounds the entries of every block of the corpus of
    tests/test_lz78_device.py and of uniform random bytes, which come
    within 6% of it up to 8 KiB (the table near its worst load)."""
    rng = np.random.default_rng(bs)
    blocks = [tc.lzw_case("corpus")[0][i, : min(bs, 512)] for i in range(6)]
    blocks += [rng.integers(0, 256, bs).astype(np.uint8), rng.integers(0, 256, bs - 1).astype(np.uint8)]
    for blk in blocks:
        entries = max(len(lzw_parse(blk)) - 1, 0)
        assert entries <= lc.lzw_z_max(len(blk)) <= lc.lzw_z_max(bs)
    assert max(len(lzw_parse(blocks[-2])) - 1, 0) >= 0.94 * lc.lzw_z_max(bs)


@pytest.mark.parametrize("name", ["english", "random", "run"])
def test_kernel_f_bitmap(name):
    """Up to 2^BITMAP_LOG2 slots the walk keeps an occupancy bitmap and its
    table is garbage where empty; one power of two above, the table is
    filled and every probe loads. Both give the host's codes, and the
    bitmap saves the loads of empty slots. The constant is csrc/lz78.cu's."""
    src = open(os.path.join(os.path.dirname(lc.__file__), "..", "csrc", "lz78.cu")).read()
    assert f"constexpr int BITMAP_LOG2 = {lc.BITMAP_LOG2};" in src
    blocks, n_valid = tc.lzw_case(name)
    small = _emulate_blocks(blocks, n_valid, lc.BITMAP_LOG2)
    big = _emulate_blocks(blocks, n_valid, lc.BITMAP_LOG2 + 1)
    for b in range(len(blocks)):
        want = lzw_parse(blocks[b, : n_valid[b]])
        for codes, _, _ in (small[b], big[b]):
            np.testing.assert_array_equal(np.array(codes, np.uint32), want)
    assert sum(w[2]["loads"] for w in small) < sum(w[2]["loads"] for w in big)
