"""The transforms' device stages on the CPU, against the JAX package.

ops/transforms_torch.py on CPU tensors:
  - mtf_encode_plain (kernel J's plain version) against
    tudocomp_tpu/ops/transforms.py:mtf_encode_device (plain JAX on the CPU,
    every input padded to one length so that it compiles once; MTF is
    causal, so the padding leaves the first n ranks as they are) and
    against tudocomp_tpu/compressors/simple.py:mtf_encode, at alphabets of
    2, 26 and 256 and at lengths that are no multiple of the chunk, and on
    tests/torch_cases.py's edge inputs at two chunk sizes;
  - the chunking behind kernel J: the entry tables that J1's and J2's
    arrays rank to (chunk_last_positions, entry_positions, entry_tables)
    against the table of a sequential walk at each chunk start; the
    walkers' grain inside a chunk (walker_last_positions against a direct
    count, walker_tables against the walk's table at each sub-chunk start,
    mtf_encode_plain at sub-chunk sizes against the JAX scan and
    ops/mtf.py); and numpy models of J3's steps, lane by lane: the bitonic
    network that sorts a chunk's entry keys across the warp, the warp pass
    that builds each walker's table from the last one's (each sub-chunk's
    symbols by a backward scan, a warp scan placing the rest), and the
    walkers' walk (the table in 64 words, the SWAR search, the funnel
    shifts), against entry_tables, walker_tables and the host's walk;
  - rle_runs_device against tudocomp_tpu/ops/transforms.py:rle_runs_device;
  - the gates TDC_DEVICE_RLE and TDC_DEVICE_MTF.
Tolerance: exact equality (every stage is integer arithmetic).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tudocomp_tpu.compressors.simple import mtf_encode as jax_mtf_encode
from tudocomp_tpu.ops import transforms as jax_transforms
from tudocomp_tpu.ops.mtf import mtf_encode_host as jax_mtf_encode_host
from tudocomp_tpu_torch import device as tdev
from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.ops import transforms_torch as tt
from tudocomp_tpu_torch.ops.mtf_cuda import MAX_CHUNK, mtf_encode_chunks

from .torch_cases import english, mtf_edge_cases

JAX_CHUNK = 4096
JAX_LEN = 4 * JAX_CHUNK  # every MTF input is padded to this: one compiled scan
RLE_LEN = 20480  # every RLE input is padded to this, by one run of another byte
MTF_CU = os.path.join(os.path.dirname(tt.__file__), "..", "csrc", "mtf.cu")
# the JAX package's scan under one jit, so that it compiles once, not a call
JAX_MTF = jax.jit(jax_transforms.mtf_encode_device, static_argnums=1)


def _alphabet(sigma: int, n: int, seed: int = 5) -> bytes:
    rng = np.random.default_rng(seed + sigma)
    if sigma == 26:
        return bytes((rng.zipf(1.4, n) % 26 + 97).astype(np.uint8))
    return bytes(rng.integers(0, sigma, n).astype(np.uint8))


def _host(data: bytes) -> np.ndarray:
    arr = np.frombuffer(data, np.uint8)
    out = np.empty(len(arr), np.uint8)
    if len(arr):
        native.get_lib().tdc_mtf_encode(np.ascontiguousarray(arr), len(arr), out)
    return out


def _t(data: bytes) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, np.uint8).copy())


@pytest.mark.parametrize("n", [1, 4095, 4097, 3 * JAX_CHUNK + 1000])
@pytest.mark.parametrize("sigma", [2, 26, 256])
def test_mtf_plain_matches_jax(sigma, n):
    data = _alphabet(sigma, n)
    arr = np.frombuffer(data, np.uint8)
    padded = np.zeros(JAX_LEN, np.uint8)
    padded[:n] = arr
    want = np.asarray(JAX_MTF(jnp.asarray(padded), JAX_CHUNK))[:n]
    np.testing.assert_array_equal(want, jax_mtf_encode(arr))
    np.testing.assert_array_equal(tt.mtf_encode_plain(_t(data), 128).numpy(), want)
    np.testing.assert_array_equal(tt.mtf_encode_device(_t(data)).numpy(), want)  # chunks of tt.CHUNK


@pytest.mark.parametrize("chunk", [128, tt.CHUNK])
@pytest.mark.parametrize("case", sorted(mtf_edge_cases()))
def test_mtf_plain_edge_cases(case, chunk):
    data = mtf_edge_cases()[case]
    want = jax_mtf_encode(np.frombuffer(data, np.uint8))
    np.testing.assert_array_equal(_host(data), want)
    np.testing.assert_array_equal(mtf_encode_chunks(_t(data), chunk).numpy(), want)


def _walk_tables(arr: np.ndarray, chunk: int) -> np.ndarray:
    """The MTF table at each chunk start, by a sequential walk."""
    table = list(range(256))
    out = []
    for i, c in enumerate(arr.tolist()):
        if i % chunk == 0:
            out.append(list(table))
        table.remove(c)
        table.insert(0, c)
    return np.array(out, np.uint8).reshape(-1, 256)


@pytest.mark.parametrize("chunk", [128, 512])
@pytest.mark.parametrize("case", ["ragged chunks", "cycle of 256", "zipf 256", "one repeated byte"])
def test_entry_tables_match_a_sequential_walk(case, chunk):
    data = _alphabet(256, 5000) if case == "zipf 256" else mtf_edge_cases()[case]
    arr = np.frombuffer(data, np.uint8)
    last = tt.chunk_last_positions(_t(data), chunk)
    assert last.shape == (-(-len(arr) // chunk), 256) and last.dtype == torch.int32
    entry = tt.entry_positions(last)
    np.testing.assert_array_equal(tt.entry_tables(entry).numpy(), _walk_tables(arr, chunk))


def _popc(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.astype("<u4").view(np.uint8).reshape(-1, 4), axis=1).sum(1).astype(np.uint32)


def _walker_walk(blocks: np.ndarray, lens: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """J3's walk (csrc/mtf.cu: mtf_step), the 32 walkers of a chunk in
    lockstep: walker t walks blocks[t, :lens[t]] from tables[t], its table
    in 64 little-endian words, 4 words a group: in each word the SWAR
    zero-byte test on word ^ (byte * 0x01010101), the bits that move
    ((2 * lowest bit - 1) while the byte is not yet found), the funnel shift
    from the word before; the rank from the popcount of the moved bits; the
    warp stops after the group where its last walker found its byte."""
    u32 = np.uint32
    w = np.ascontiguousarray(tables).view(np.uint32).reshape(len(tables), 64).copy()
    out = np.zeros(blocks.shape, np.uint8)
    for i in range(blocks.shape[1]):
        ch = blocks[:, i].astype(np.uint32)
        c4 = ch * u32(0x01010101)
        prev, alive, moved = ch << u32(24), np.full(len(w), 0xFFFFFFFF, np.uint32), np.zeros(len(w), np.uint32)
        for g in range(16):
            for k in range(4 * g, 4 * g + 4):
                cur = w[:, k].copy()
                x = cur ^ c4
                z = (x - u32(0x01010101)) & ~x & u32(0x80808080)
                low = z & (u32(0) - z)
                move = (u32(2) * low - u32(1)) & alive
                shifted = (cur << u32(8)) | (prev >> u32(24))  # __funnelshift_l(prev, cur, 8)
                w[:, k] = (shifted & move) | (cur & ~move)
                moved += _popc(move)
                alive &= ((low - u32(1)).view(np.int32) >> 31).view(np.uint32)
                prev = cur
            if not alive.any():
                break
        live = i < lens
        out[:, i] = np.where(live, moved // 8 - 1, 0)
    return out


@pytest.mark.parametrize("case", ["ragged chunks", "cycle of 256", "zipf 256", "permutations of 256"])
def test_lane_walk_model_matches_the_host(case):
    for chunk in (128, 1024):
        data = (_alphabet(256, 3000) if case == "zipf 256" else mtf_edge_cases()[case])[: 3 * chunk - 40]
        arr = np.frombuffer(data, np.uint8)
        sub = chunk // tt.WALKERS
        tables = tt.walker_tables(_t(data), chunk).numpy()
        got = []
        for c in range(len(tables)):
            part = arr[c * chunk : (c + 1) * chunk]
            blocks = np.zeros((tt.WALKERS, sub), np.uint8)
            blocks.reshape(-1)[: len(part)] = part
            lens = np.clip(len(part) - sub * np.arange(tt.WALKERS), 0, sub)
            got.append(_walker_walk(blocks, lens, tables[c]).reshape(-1)[: len(part)])
        np.testing.assert_array_equal(np.concatenate(got), _host(data))


@pytest.mark.parametrize("chunk", [128, 1024, 4096])
@pytest.mark.parametrize("case", ["ragged chunks", "runs across sub-chunks", "one past a chunk", "zipf 256"])
def test_walker_last_positions_match_a_direct_count(case, chunk):
    data = _alphabet(256, 9000) if case == "zipf 256" else mtf_edge_cases()[case]
    arr = np.frombuffer(data, np.uint8)
    sub = chunk // tt.WALKERS
    C = -(-len(arr) // chunk)
    want = np.full((C * tt.WALKERS, 256), -1, np.int64)
    pos = np.arange(len(arr))
    np.maximum.at(want, (pos // sub, arr), pos)
    got = tt.walker_last_positions(_t(data), chunk)
    assert got.shape == (C, tt.WALKERS, 256) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().reshape(-1, 256), want)


@pytest.mark.parametrize("chunk", [128, 1024])
@pytest.mark.parametrize("case", ["ragged chunks", "cycle of 256", "runs across sub-chunks", "permutations of 256",
                                  "zipf 256"])
def test_walker_tables_match_a_sequential_walk(case, chunk):
    data = _alphabet(256, 5000) if case == "zipf 256" else mtf_edge_cases()[case]
    arr = np.frombuffer(data, np.uint8)
    sub = chunk // tt.WALKERS
    got = tt.walker_tables(_t(data), chunk).numpy().reshape(-1, 256)
    want = _walk_tables(arr, sub)  # one table a sub-chunk start inside the data
    np.testing.assert_array_equal(got[: len(want)], want)


def _bitonic_tables(keys: np.ndarray) -> np.ndarray:
    """J3's bitonic network (csrc/mtf.cu, step 3) over [C, 256] distinct
    keys, lane by lane: lane l holds keys 8l .. 8l + 7; a stride of 8 or
    more pairs lanes l and l ^ (stride / 8) through a shuffle, a smaller one
    pairs j and j | stride in the lane. Returns the symbols in sorted key
    order, [C, 256]."""
    key = keys.reshape(-1, 32, 8).astype(np.uint64)
    sym = np.broadcast_to(np.arange(256).reshape(32, 8), key.shape).copy()
    lane = np.arange(32)[:, None]
    i = 8 * lane + np.arange(8)[None, :]
    for ls in range(1, 9):
        size = 1 << ls
        for st in range(ls - 1, -1, -1):
            stride = 1 << st
            if stride >= 8:
                partner = np.arange(32) ^ (stride >> 3)
                ok, os_ = key[:, partner], sym[:, partner]
                want_min = ((i & size) == 0) == ((i & stride) == 0)
                take = np.where(want_min, ok < key, ok > key)
                key, sym = np.where(take, ok, key), np.where(take, os_, sym)
            else:
                for j in range(8):
                    if j & stride:
                        continue
                    jj = j | stride
                    up = ((8 * np.arange(32) + j) & size) == 0
                    swap = np.where(up, key[:, :, j] > key[:, :, jj], key[:, :, j] < key[:, :, jj])
                    for a in (key, sym):
                        a[:, :, j], a[:, :, jj] = np.where(swap, a[:, :, jj], a[:, :, j]), np.where(swap, a[:, :, j], a[:, :, jj])
    return sym.reshape(-1, 256)


@pytest.mark.parametrize("case", ["ragged chunks", "cycle of 256", "zipf 256", "permutations of 256", "random keys"])
def test_bitonic_model_gives_the_entry_tables(case):
    if case == "random keys":
        keys = np.random.default_rng(8).permutation(1 << 20)[: 4 * 256].reshape(4, 256)
        np.testing.assert_array_equal(_bitonic_tables(keys), np.argsort(keys, 1))
        return
    data = _alphabet(256, 5000) if case == "zipf 256" else mtf_edge_cases()[case]
    entry = tt.entry_positions(tt.chunk_last_positions(_t(data), 512)).numpy().astype(np.int64)
    sym = np.arange(256)
    keys = np.where(entry >= 0, 0x7FFFFFFF - entry, 0x80000000 + sym)  # csrc/mtf.cu's keys
    np.testing.assert_array_equal(_bitonic_tables(keys), tt.entry_tables(torch.from_numpy(entry).to(torch.int32)).numpy())


def _warp_tables(part: np.ndarray, entry_table: np.ndarray, chunk: int) -> np.ndarray:
    """J3's steps 2 and 4 (csrc/mtf.cu) for one chunk, lane by lane: each
    walker's D_t by a backward scan of its sub-chunk with a seen set, then
    walker t + 1's table from walker t's: D_t to the front, the other
    symbols of lane l's table bytes 8l .. 8l + 7 placed at |D_t| plus the
    lanes' exclusive scan of their counts."""
    sub = chunk // tt.WALKERS
    lists = []
    for t in range(tt.WALKERS):
        seen, d = set(), []
        for ch in part[t * sub : (t + 1) * sub][::-1].tolist():
            if ch not in seen:
                seen.add(ch)
                d.append(ch)
        lists.append(d)
    cur = entry_table.astype(np.int64)
    out = [cur]
    for t in range(tt.WALKERS - 1):
        d = np.array(lists[t], np.int64)
        nxt = np.full(256, -1, np.int64)
        nxt[: len(d)] = d
        stay = ~np.isin(cur, d).reshape(32, 8)
        cnt = stay.sum(1)
        before = np.cumsum(cnt) - cnt
        for lane in range(32):
            kept = cur[8 * lane : 8 * lane + 8][stay[lane]]
            nxt[len(d) + before[lane] : len(d) + before[lane] + len(kept)] = kept
        assert (nxt >= 0).all()
        cur = nxt
        out.append(cur)
    return np.stack(out).astype(np.uint8)


@pytest.mark.parametrize("chunk", [128, 1024])
@pytest.mark.parametrize("case", ["ragged chunks", "runs across sub-chunks", "permutations of 256", "one past a chunk"])
def test_warp_table_pass_model_matches_walker_tables(case, chunk):
    data = mtf_edge_cases()[case][: 3 * chunk + 50]
    arr = np.frombuffer(data, np.uint8)
    entry = tt.entry_tables(tt.entry_positions(tt.chunk_last_positions(_t(data), chunk))).numpy()
    want = tt.walker_tables(_t(data), chunk).numpy()
    for c in range(len(entry)):
        np.testing.assert_array_equal(_warp_tables(arr[c * chunk : (c + 1) * chunk], entry[c], chunk), want[c])


@pytest.mark.parametrize("sub", [4, 32, 128])
@pytest.mark.parametrize("sigma", [26, 256])
def test_mtf_plain_at_the_walkers_grain_matches_jax(sigma, sub):
    """mtf_encode_plain with chunks of a walker's sub-chunk (chunks of 128,
    1024 and 4096 over 32 walkers) against the JAX scan and ops/mtf.py."""
    data = _alphabet(sigma, 3 * JAX_CHUNK + 555, seed=9)
    arr = np.frombuffer(data, np.uint8)
    padded = np.zeros(JAX_LEN, np.uint8)
    padded[: len(arr)] = arr
    want = np.asarray(JAX_MTF(jnp.asarray(padded), JAX_CHUNK))[: len(arr)]
    np.testing.assert_array_equal(jax_mtf_encode_host(arr), want)
    np.testing.assert_array_equal(tt.mtf_encode_plain(_t(data), sub).numpy(), want)


def test_chunk_limits_match_mtf_cu():
    src = open(MTF_CU).read()
    assert re.search(rf"chunk > {MAX_CHUNK}\b", src) and "chunk % 128" in src
    assert tt.CHUNK % 128 == 0 and tt.CHUNK <= MAX_CHUNK


@pytest.mark.parametrize("args", [(torch.zeros(4, dtype=torch.int32), 4096), (torch.zeros(4, dtype=torch.uint8), 100),
                                  (torch.zeros(4, dtype=torch.uint8), 2 * MAX_CHUNK), (torch.zeros(2, 2, dtype=torch.uint8), 4096)])
def test_mtf_wrapper_raises_on_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        mtf_encode_chunks(*args)


RLE_INPUTS = {
    "one byte": b"q",
    "no runs": bytes(range(256)),
    "one run": b"a" * 3000,
    "runs": b"".join(bytes([c]) * n for c, n in zip(b"abcabz", (3000, 1, 777, 2, 4096, 2))),
    "english": english(1 << 14),
    "zipf": _alphabet(26, 20000),
}


@pytest.mark.parametrize("name", sorted(RLE_INPUTS))
def test_rle_runs_match_jax(name):
    data = RLE_INPUTS[name]
    chars, lens, n_runs = tt.rle_runs_device(_t(data))
    padded = np.full(RLE_LEN, (data[-1] + 1) % 256, np.uint8)  # one more run: JAX compiles one shape
    padded[: len(data)] = np.frombuffer(data, np.uint8)
    jc, jl, jn = jax_transforms.rle_runs_device(jnp.asarray(padded))
    assert n_runs == int(jn) - 1 and chars.shape == lens.shape == (n_runs,)
    np.testing.assert_array_equal(chars.numpy(), np.asarray(jc)[:n_runs])
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jl)[:n_runs])
    assert int(lens.sum()) == len(data)


def test_rle_runs_of_nothing():
    chars, lens, n_runs = tt.rle_runs_device(torch.zeros(0, dtype=torch.uint8))
    assert n_runs == 0 and chars.numel() == lens.numel() == 0


@pytest.mark.parametrize("var,gate,min_n", [("TDC_DEVICE_RLE", tdev.use_rle_device, tdev.RLE_MIN_N),
                                            ("TDC_DEVICE_MTF", tdev.use_mtf_device, tdev.MTF_MIN_N)])
def test_transform_gates(var, gate, min_n, monkeypatch):
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    monkeypatch.delenv(var, raising=False)
    assert not gate(1 << 30, cpu)
    assert gate(min_n, card) and not gate(min_n - 1, card)
    monkeypatch.setenv(var, "1")
    assert gate(1, cpu) and gate(1, card)
    monkeypatch.setenv(var, "0")
    assert not gate(1 << 30, card)
