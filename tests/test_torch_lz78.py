"""The LZ78/LZW block parse of the port on the CPU, against the JAX package.

Kernels E and F's plain versions (tudocomp_tpu_torch/ops/lz78_cuda.py)
against the Pallas kernels they replace, run in interpret mode, and
against the host parses; then blockwise(lz78) / blockwise(lzw) and the
unwrapped compressors through the port's driver, whose containers must
equal the JAX package's byte for byte, each package decoding the other's.
Tolerance: exact equality, since factors and codes are integers.

TDC_DEVICE_LZ78 is read by both packages: it is set (monkeypatch) around
the port's calls only.
"""

import numpy as np
import pytest

import torch

from tudocomp_tpu.compressors.lz78 import lz78_parse
from tudocomp_tpu.compressors.lzw import lzw_parse
from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.ops.lz78_bucket_pallas import lz78_parse_blocks_bucket
from tudocomp_tpu.ops.lz78_pallas import lz78_parse_blocks_device as jax_lz78_blocks
from tudocomp_tpu.ops.lz78_pallas import lzw_parse_blocks_device as jax_lzw_blocks
from tudocomp_tpu_torch import __main__ as cli
from tudocomp_tpu_torch.compressors import lz78 as port_lz78
from tudocomp_tpu_torch.compressors import lzw as port_lzw
from tudocomp_tpu_torch.device import PARSE_MAX_BS, PARSE_MIN_BLOCKS, PARSE_ONE_BLOCK_BS, use_parse_device
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.ops import lz78_cuda as lc


def _corpus(bs):  # the corpus of tests/test_lz78_device.py
    rng = np.random.default_rng(1)
    blocks = np.zeros((6, bs), np.uint8)
    blocks[0] = rng.integers(0, 256, bs)
    blocks[1] = rng.integers(97, 100, bs)  # tiny alphabet -> deep trie
    blocks[2] = 65  # single run
    pat = (b"abracadabra " * (bs // 12 + 1))[:bs]
    blocks[3] = np.frombuffer(pat, np.uint8)
    blocks[4, : bs // 2] = rng.integers(0, 4, bs // 2)
    n_valid = np.array([bs, bs, bs, bs, bs // 2, 0], np.int32)
    return blocks, n_valid


def _assert_lz78_equal(got, want, blocks, n_valid):
    assert len(got) == len(want) == len(blocks)
    for b, ((gp, gc), (wp, wc)) in enumerate(zip(got, want)):
        hp, hc = lz78_parse(blocks[b, : n_valid[b]])
        for g, w, h in ((gp, wp, hp), (gc, wc, hc)):
            np.testing.assert_array_equal(g, w, err_msg=f"block {b}")
            np.testing.assert_array_equal(g, h, err_msg=f"block {b}")
            assert g.dtype == h.dtype


@pytest.mark.parametrize("bs", [128, 512])
def test_lz78_plain_matches_lockstep_kernel(bs):
    blocks, n_valid = _corpus(bs)
    want = jax_lz78_blocks(blocks, n_valid, interpret=True)
    _assert_lz78_equal(lc.lz78_parse_blocks_device(blocks, n_valid, "cpu"), want, blocks, n_valid)


def test_lz78_plain_matches_bucket_kernel():
    """Blocks over the lockstep kernel's 8 KiB cap: the cases of
    tests/test_lz78_device.py's bucket test."""
    rng = np.random.default_rng(17)
    cases = [
        rng.integers(0, 256, 10000).astype(np.uint8),
        rng.integers(0, 4, 12000).astype(np.uint8),
        np.zeros(9000, np.uint8),
        np.frombuffer(b"the quick brown fox " * 600, np.uint8),
    ]
    bs = max(len(c) for c in cases)
    blocks = np.zeros((len(cases), bs), np.uint8)
    n_valid = np.array([len(c) for c in cases], np.int32)
    for i, c in enumerate(cases):
        blocks[i, : len(c)] = c
    want = lz78_parse_blocks_bucket(blocks, n_valid, interpret=True)
    _assert_lz78_equal(lc.lz78_parse_blocks_device(blocks, n_valid, "cpu"), want, blocks, n_valid)


@pytest.mark.parametrize("bs", [128, 512])
def test_lzw_plain_matches_lockstep_kernel(bs):
    blocks, n_valid = _corpus(bs)
    want = jax_lzw_blocks(blocks, n_valid, interpret=True)
    got = lc.lzw_parse_blocks_device(blocks, n_valid, "cpu")
    for b in range(len(blocks)):
        host = lzw_parse(blocks[b, : n_valid[b]])
        np.testing.assert_array_equal(got[b], want[b], err_msg=f"block {b}")
        np.testing.assert_array_equal(got[b], host, err_msg=f"block {b}")
        assert got[b].dtype == host.dtype


def test_wrappers_shapes_and_zero_padding():
    """The wrappers' tensors: [B, bs + 1] / [B, bs] rows, zeros past nf."""
    blocks, n_valid = _corpus(300)
    b, nv = torch.from_numpy(blocks), torch.from_numpy(n_valid)
    parents, chars, nf = lc.lz78_parse_blocks(b, nv)
    codes, nfw = lc.lzw_parse_blocks(b, nv)
    assert parents.shape == chars.shape == (6, 301) and codes.shape == (6, 300)
    assert (parents.dtype, chars.dtype, nf.dtype, codes.dtype) == (torch.int32, torch.uint8, torch.int32, torch.int32)
    for i in range(6):
        assert not parents[i, nf[i] :].any() and not chars[i, nf[i] :].any()
        assert not codes[i, nfw[i] :].any()
    assert nf[5] == nfw[5] == 0  # the empty block
    with pytest.raises(TypeError):
        lc.lz78_parse_blocks(b.to(torch.int32), nv)
    with pytest.raises(ValueError, match="n_valid"):
        lc.lzw_parse_blocks(b, nv + 301)


def _z_closed(bs):
    """z_max by its closed form below 3-byte phrases: every 1-byte string,
    then 2-byte ones, then 3-byte ones."""
    if bs <= 256:
        return bs
    if bs <= 256 + 2 * 65536:
        return 256 + (bs - 256) // 2
    return 256 + 65536 + (bs - 256 - 2 * 65536) // 3


@pytest.mark.parametrize("bs", [0, 1, 64, 255, 256, 257, 300, 1024, 4096, 8192, 131328, 131329, 131331, 1 << 18])
def test_kernel_e_table_size(bs):
    """Kernel E's table: z_max(bs) nodes at most, a power of two of slots at
    most 55% full at z_max + 1 entries, and no power of two below it is."""
    z = lc.z_max(bs)
    assert z == _z_closed(bs)
    slots = 1 << lc.table_log2(bs)
    assert 20 * (z + 1) <= 11 * slots
    assert slots == 16 or 20 * (z + 1) > 11 * (slots // 2)
    assert (lc.z_max(8192), 1 << lc.table_log2(8192)) == (4224, 1 << 13)
    assert (lc.z_max(1 << 18), 1 << lc.table_log2(1 << 18)) == (109397, 1 << 18)


def _nodes(parents, chars):
    """The trie nodes a parse creates: its distinct factors."""
    return len(set(zip(parents.tolist(), chars.tolist())))


@pytest.mark.parametrize("bs", [64, 256, 1000, 4096, 8192])
def test_kernel_e_table_holds_every_parse(bs):
    """z_max bounds the nodes of the _corpus blocks and of uniform random
    bytes, which come within 5% of it from 1000 bytes on (the table near
    its worst load; shorter blocks repeat 1-byte phrases)."""
    blocks, n_valid = _corpus(bs)
    rng = np.random.default_rng(bs)
    blocks = np.concatenate([blocks, rng.integers(0, 256, (2, bs)).astype(np.uint8)])
    n_valid = np.concatenate([n_valid, [bs, bs - 1]]).astype(np.int32)
    for b in range(len(blocks)):
        parents, chars = lz78_parse(blocks[b, : n_valid[b]])
        assert _nodes(parents, chars) <= lc.z_max(int(n_valid[b])) <= lc.z_max(bs)
    parents, chars = lz78_parse(blocks[-2])
    assert bs < 1000 or _nodes(parents, chars) >= 0.95 * lc.z_max(bs)


def test_parse_gate(monkeypatch):
    """The host routings of the device parse are the size gate and, with
    TDC_DEVICE_LZ78 unset, the block count."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")  # no card needed to name one
    monkeypatch.delenv("TDC_DEVICE_LZ78", raising=False)
    cap, few, alone = PARSE_MAX_BS, PARSE_MIN_BLOCKS, PARSE_ONE_BLOCK_BS
    assert use_parse_device(cap, few, cuda) and not use_parse_device(cap + 1, few, cuda)
    assert use_parse_device(8192, few, cuda) and not use_parse_device(8192, few - 1, cuda)
    assert use_parse_device(alone, 1, cuda) and not use_parse_device(alone - 1, 1, cuda)
    assert not use_parse_device(cap, few, cpu)
    monkeypatch.setenv("TDC_DEVICE_LZ78", "1")
    assert use_parse_device(cap, 1, cpu) and not use_parse_device(cap + 1, few, cpu)
    monkeypatch.setenv("TDC_DEVICE_LZ78", "0")
    assert not use_parse_device(1024, few, cuda)

    calls = []
    real = port_lzw.lzw_parse_blocks_device
    monkeypatch.setattr(port_lzw, "lzw_parse_blocks_device", lambda *a: calls.append(a[0].shape) or real(*a))
    monkeypatch.setenv("TDC_DEVICE_LZ78", "1")
    data = b"a gate at one MiB " * 1000
    for bs in (cap, cap + 1):
        assert compress(f"blockwise(lzw(coder=bit),bs={bs})", data, device="cpu") == jax_compress(
            f"blockwise(lzw(coder=bit),bs={bs})", data
        )
    assert calls == [(1, cap)]


def _cases():
    rng = np.random.default_rng(23)
    return {
        "empty": b"",
        "one-byte": b"x",
        "block-plus-one": bytes(rng.integers(0, 256, 1025).astype(np.uint8)),
        "run": b"z" * 5000,
        "mid-phrase": b"abracadabra " * 300 + b"abra",
    }


CASES = _cases()
BLOCK_ALGOS = ["blockwise(lz78(coder=bit),bs=1024)", "blockwise(lzw(coder=bit),bs=1024)"]


def _check_both_ways(algo, data, monkeypatch, env):
    want = jax_compress(algo, data)
    if env is None:
        monkeypatch.delenv("TDC_DEVICE_LZ78", raising=False)
    else:
        monkeypatch.setenv("TDC_DEVICE_LZ78", env)
    got = compress(algo, data, device="cpu")
    back = decompress(want, device="cpu")
    monkeypatch.delenv("TDC_DEVICE_LZ78", raising=False)
    assert got == want
    assert back == data
    assert jax_decompress(got) == data


@pytest.mark.parametrize("env", ["1", None])
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("algo", BLOCK_ALGOS)
def test_blockwise_matches_jax_driver(algo, name, env, monkeypatch):
    _check_both_ways(algo, CASES[name], monkeypatch, env)


def test_blockwise_default_block_size(monkeypatch):
    data = CASES["mid-phrase"][:3000]
    _check_both_ways("blockwise(lz78(coder=bit))", data, monkeypatch, None)


@pytest.mark.parametrize("algo", ["lz78(coder=bit)", "lzw(coder=bit)", "lz78(coder=gamma)"])
def test_unwrapped_matches_jax_driver(algo, monkeypatch):
    data = CASES["mid-phrase"] + CASES["block-plus-one"]
    _check_both_ways(algo, data, monkeypatch, None)


def test_device_parse_is_used(monkeypatch):
    """With TDC_DEVICE_LZ78=1 the CPU blockwise path parses through the
    plain versions; unset, it takes the host parse."""
    calls = []
    real = port_lz78.lz78_parse_blocks_device
    monkeypatch.setattr(port_lz78, "lz78_parse_blocks_device", lambda *a: calls.append(1) or real(*a))
    data = CASES["mid-phrase"]
    _check_both_ways(BLOCK_ALGOS[0], data, monkeypatch, None)
    assert not calls
    _check_both_ways(BLOCK_ALGOS[0], data, monkeypatch, "1")
    assert calls == [1]


def test_cli_roundtrip(tmp_path, monkeypatch):
    algo = "blockwise(lz78(coder=bit),bs=1024)"
    data = CASES["mid-phrase"]
    want = jax_compress(algo, data)
    monkeypatch.setenv("TDC_DEVICE_LZ78", "1")
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    assert cli.main(["-a", algo, "--device", "cpu", str(src)]) == 0
    packed = tmp_path / "in.bin.tdc"
    assert packed.read_bytes() == want
    out = tmp_path / "out.bin"
    assert cli.main(["-d", str(packed), "-o", str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == data
