"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `cuda`: every test skips where torch.cuda.is_available() is false.
On a machine with a card, run them with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance: exact equality, since every stage is integer arithmetic.
"""

import numpy as np
import pytest

import torch

from tudocomp_tpu_torch import kernels
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.ops import bitpack_cuda as bc
from tudocomp_tpu_torch.ops import huffman_decode_cuda as hd
from tudocomp_tpu_torch.ops import huffman_torch as ht
from tudocomp_tpu_torch.ops import lz78_cuda as lc
from tudocomp_tpu_torch.ops import table_kernels as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


def _zipf_blocks(dev, B=5, bs=3001):  # odd: rows start unaligned, tiles end ragged
    rng = np.random.default_rng(0)
    blocks = rng.zipf(1.3, (B, bs)).clip(0, 255).astype(np.uint8)
    blocks[1] = 7  # degenerate block
    n_valid = np.array([bs, bs, 1, 0, bs - 5][:B], np.int32)
    return torch.from_numpy(blocks).to(dev), torch.from_numpy(n_valid).to(dev)


def test_huffman_tables_kernel(dev):
    blocks, n_valid = _zipf_blocks(dev)
    hists = ht.block_histograms(blocks, n_valid)
    _equal(tk.huffman_tables(hists), tk.huffman_tables_plain(hists))


def test_pack_blocks_kernel(dev):
    rng = np.random.default_rng(1)
    nbits = torch.from_numpy(rng.integers(0, 33, (3, 5000)).astype(np.int32)).to(dev)
    values = torch.from_numpy(rng.integers(0, 1 << 32, (3, 5000)).astype(np.uint32).view(np.int32)).to(dev)
    for n_words in (100, 6000):  # the first drops bits
        _equal(bc.pack_blocks(values, nbits, n_words), bc.pack_blocks_plain(values, nbits, n_words))
    with pytest.raises(ValueError, match="outside"):
        bc.pack_blocks(values, nbits + 1, 100)


def test_pack_bytes_blocks_kernel(dev):
    blocks, n_valid = _zipf_blocks(dev)
    t = tk.huffman_tables(ht.block_histograms(blocks, n_valid))
    normal = (t.sigma >= 2)[:, None]
    tbl_v = torch.where(normal, t.cw, torch.arange(256, dtype=torch.int32, device=dev))
    tbl_nb = torch.where(normal, t.lengths, 8)
    tv, tb = ht.huffman_table_tokens(t.numl, t.ordered_sym, t.sigma, t.longest)
    hdr_w, hdr_b = bc.pack_blocks(tv, tb, ht.N_TABLE_TOKENS)
    for n_words in (50, 4000):
        args = (blocks, n_valid, tbl_v, tbl_nb, hdr_w, hdr_b, n_words)
        _equal(bc.pack_bytes_blocks(*args), bc.pack_bytes_blocks_plain(*args))


def test_decode_kernel(dev):
    rng = np.random.default_rng(2)
    cases = [b"", b"q", b"zz" * 9, bytes(rng.zipf(1.4, 3000).clip(0, 255).astype(np.uint8))]
    parsed = [hd.parse_payload_tables(compress("encode(huff)", c, device="cpu", raw=True)) for c in cases]
    W = max(len(p[3]) for p in parsed)
    words = np.zeros((len(parsed), W), np.uint32)
    for i, p in enumerate(parsed):
        words[i, : len(p[3])] = p[3]
    args = (
        torch.from_numpy(words.view(np.int32)).to(dev),
        torch.tensor([p[4] for p in parsed], dtype=torch.int32, device=dev),
        torch.from_numpy(np.stack([p[0] for p in parsed])).to(dev),
        torch.from_numpy(np.stack([p[1] for p in parsed])).to(dev),
        torch.from_numpy(np.stack([p[2] for p in parsed])).to(dev),
        4096,
    )
    out, counts = hd.decode_payloads(*args)
    _equal((out, counts), hd.decode_payloads_plain(*args))
    assert [out[i, : int(c)].cpu().numpy().tobytes() for i, c in enumerate(counts)] == cases


def test_roundtrip_launches_every_kernel(dev, monkeypatch):
    monkeypatch.delenv("TDC_DEVICE_HUFF", raising=False)
    rng = np.random.default_rng(3)
    data = bytes(rng.zipf(1.3, 200_000).clip(0, 255).astype(np.uint8))
    algo = "blockwise(encode(huff),bs=65536)"
    kernels.reset_counts()
    c = compress(algo, data, device="cuda")
    assert decompress(c, device="cuda") == data
    launches = kernels.counts()
    assert all(launches[k] for k in ("pack_blocks", "pack_bytes_blocks", "huffman_tables", "decode_payloads"))
    monkeypatch.setenv("TDC_DEVICE_HUFF", "1")
    assert compress(algo, data, device="cpu") == c


def _text_blocks(dev, B=5, bs=3001):
    rng = np.random.default_rng(4)
    blocks = rng.integers(97, 101, (B, bs)).astype(np.uint8)  # deep tries
    blocks[1] = 0  # one run of the byte whose keys include key 0
    blocks[2] = rng.integers(0, 256, bs)
    n_valid = np.array([bs, bs, bs - 7, 0, 1][:B], np.int32)  # ragged, one empty block
    return torch.from_numpy(blocks).to(dev), torch.from_numpy(n_valid).to(dev)


def test_lz78_parse_kernel(dev):
    blocks, n_valid = _text_blocks(dev)
    kernels.reset_counts()
    got = lc.lz78_parse_blocks(blocks, n_valid)
    torch.cuda.synchronize()
    assert kernels.counts()["lz78_parse"] == 1
    _equal(got, lc.lz78_parse_blocks_plain(blocks, n_valid))


def test_lzw_parse_kernel(dev):
    blocks, n_valid = _text_blocks(dev)
    kernels.reset_counts()
    got = lc.lzw_parse_blocks(blocks, n_valid)
    torch.cuda.synchronize()
    assert kernels.counts()["lzw_parse"] == 1
    _equal(got, lc.lzw_parse_blocks_plain(blocks, n_valid))


@pytest.mark.parametrize("algo", ["blockwise(lz78(coder=bit),bs=4096)", "blockwise(lzw(coder=bit),bs=4096)"])
def test_lz78_roundtrip_on_the_card(dev, algo, monkeypatch):
    monkeypatch.delenv("TDC_DEVICE_LZ78", raising=False)
    rng = np.random.default_rng(5)
    data = b"".join(rng.choice([b"lz78 ", b"parse ", b"on ", b"the ", b"card. "], 40000))
    kernels.reset_counts()
    c = compress(algo, data, device="cuda")
    assert kernels.counts()["lz78_parse"] + kernels.counts()["lzw_parse"] == 1
    assert decompress(c, device="cuda") == data
    assert c == compress(algo, data, device="cpu")  # the host parse


def test_moffat_phase12_kernel(dev):
    """Kernel G against its plain version: sorted zipf weights, the edge
    rows of sigma 0, 1, 2 and 256, and weights past 2^31."""
    rng = np.random.default_rng(6)
    hists = np.zeros((6, 256), np.int64)
    hists[0] = np.bincount(rng.zipf(1.3, 1 << 20).clip(0, 255), minlength=256)
    hists[2, 65] = 7
    hists[3, [3, 200]] = [5, 9]
    hists[4] = np.arange(1, 257)
    hists[5] = hists[0] * (1 << 22)
    weights, sigma, _ = ht._sort_hist(torch.from_numpy(hists).to(dev))
    sigma[1] = 300  # clamped to 256 by both versions
    kernels.reset_counts()
    got = tk.moffat_phase12(weights, sigma)
    torch.cuda.synchronize()
    assert kernels.counts()["moffat_phase12"] == 1
    _equal((got,), (tk.moffat_phase12_plain(weights, sigma),))


@pytest.mark.parametrize("data", ["zipf", "32-bit codes"])
def test_shared_roundtrip_on_the_card(dev, data, monkeypatch):
    monkeypatch.delenv("TDC_DEVICE_HUFF", raising=False)
    rng = np.random.default_rng(7)
    if data == "zipf":
        raw = bytes(rng.zipf(1.3, 300_000).clip(0, 255).astype(np.uint8))
    else:  # Fibonacci counts: a caterpillar tree whose longest codes have 32 bits
        fib = [1, 1]
        while len(fib) < 33:
            fib.append(fib[-1] + fib[-2])
        raw = bytes(rng.permutation(np.repeat(np.arange(33, dtype=np.uint8), fib)))
    algo = "blockwise(encode(huff),bs=1048576,shared=1)"
    kernels.reset_counts()
    c = compress(algo, raw, device="cuda")
    assert decompress(c, device="cuda") == raw
    launches = kernels.counts()
    assert all(launches[k] for k in ("moffat_phase12", "pack_blocks", "pack_bytes_blocks", "decode_payloads"))
    assert launches["huffman_tables"] == 0
    assert c == compress(algo, raw, device="cpu")  # the plain versions
    assert decompress(c, device="cpu") == raw  # the host decoder
