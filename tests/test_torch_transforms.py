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
    against the table of a sequential walk at each chunk start, and a
    lane-by-lane numpy model of J3's warp walk (8 table bytes a lane, the
    rank by a minimum over the lanes, the shift by one lane's top byte
    handed up) against the host's table walk;
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
from tudocomp_tpu_torch import device as tdev
from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.ops import transforms_torch as tt
from tudocomp_tpu_torch.ops.mtf_cuda import MAX_CHUNK, mtf_encode_chunks

from .torch_cases import english, mtf_edge_cases

JAX_CHUNK = 4096
JAX_LEN = 4 * JAX_CHUNK  # every MTF input is padded to this: one compiled scan
RLE_LEN = 20480  # every RLE input is padded to this, by one run of another byte
MTF_CU = os.path.join(os.path.dirname(tt.__file__), "..", "csrc", "mtf.cu")
SHIFTS = np.arange(0, 32, 8, dtype=np.uint32)
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


def _lane_walk(block: np.ndarray, table: np.ndarray) -> np.ndarray:
    """J3's walk of one chunk (csrc/mtf.cu: mtf_walk_kernel), lane by lane:
    lane l holds table positions 8l..8l+7 as two little-endian words."""
    words = table.view(np.uint32).reshape(32, 2).copy()
    lo, hi = words[:, 0].copy(), words[:, 1].copy()
    lane8 = np.arange(32, dtype=np.int64) * 8
    full = np.uint32(0xFFFFFFFF)
    out = np.empty(len(block), np.uint8)
    for i, ch in enumerate(block.tolist()):
        # __vcmpeq4: which of each word's 4 bytes equal ch
        elo, ehi = (((w[:, None] >> SHIFTS) & np.uint32(0xFF)) == ch for w in (lo, hi))
        cand = np.full(32, 256, np.int64)
        has_lo, has_hi = elo.any(1), ehi.any(1)
        cand[has_hi] = lane8[has_hi] + 4 + ehi[has_hi].argmax(1)
        cand[has_lo] = lane8[has_lo] + elo[has_lo].argmax(1)
        rank = int(cand.min())  # __reduce_min_sync
        cin = np.roll(hi >> np.uint32(24), 1)  # __shfl_up_sync(hi >> 24, 1)
        cin[0] = ch
        take = np.clip(rank - lane8 + 1, 0, 8)
        take_lo = np.where(take >= 4, full, (np.uint64(1) << (8 * np.minimum(take, 3)).astype(np.uint64)) - 1).astype(np.uint32)
        hi_bits = (np.uint64(1) << (8 * np.clip(take - 4, 0, 3)).astype(np.uint64)) - 1
        take_hi = np.where(take >= 8, full, np.where(take <= 4, 0, hi_bits)).astype(np.uint32)
        slo = (lo << np.uint32(8)) | cin.astype(np.uint32)
        shi = (hi << np.uint32(8)) | (lo >> np.uint32(24))
        lo, hi = (slo & take_lo) | (lo & ~take_lo), (shi & take_hi) | (hi & ~take_hi)
        out[i] = rank
    return out


@pytest.mark.parametrize("case", ["ragged chunks", "cycle of 256", "zipf 256"])
def test_lane_walk_model_matches_the_host(case):
    chunk = 256
    data = (_alphabet(256, 700) if case == "zipf 256" else mtf_edge_cases()[case])[: 3 * chunk - 40]
    arr = np.frombuffer(data, np.uint8)
    tables = tt.entry_tables(tt.entry_positions(tt.chunk_last_positions(_t(data), chunk))).numpy()
    got = np.concatenate([_lane_walk(arr[c * chunk : (c + 1) * chunk], tables[c]) for c in range(len(tables))])
    np.testing.assert_array_equal(got, _host(data))


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
