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

from tests import torch_cases as tc

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


@pytest.mark.parametrize("instance", ["int32", "int64"])
def test_table_kernel_edge_rows(dev, instance):
    """Kernel C's int32 and int64 instances against their plain version on
    tc.table_rows (chip_smoke.py's edge rows, all-equal and tie-heavy rows):
    the int32 instance on the rows its key takes, the int64 one on all but
    the row whose code needs 33 bits."""
    rows = tc.table_rows()
    names = tc.INT32_ROWS if instance == "int32" else [n for n in rows if n != "fibonacci 33-bit"]
    hists = torch.from_numpy(np.stack([rows[n] for n in names])).to(dev)
    fn = tk.huffman_tables if instance == "int32" else tk.huffman_tables64
    kernels.reset_counts()
    got = fn(hists)
    torch.cuda.synchronize()
    assert kernels.counts()["huffman_tables" if instance == "int32" else "huffman_tables64"] == 1
    _equal(got, tk.huffman_tables_plain(hists))


def test_table_kernel64_raises_past_32_bits(dev):
    """The int64 instance reports a 33-bit code through the flag word with
    the plain chain's ValueError, and the next call is right."""
    rows = tc.table_rows()
    hists = torch.from_numpy(np.stack([rows["zipf 4096"], rows["fibonacci 33-bit"]])).to(dev)
    with pytest.raises(ValueError, match="33-bit codes"):
        tk.huffman_tables_plain(hists)
    with pytest.raises(ValueError, match="33-bit codes"):
        tk.huffman_tables64(hists)
    with pytest.raises(ValueError, match="33-bit codes"):
        ht.shared_tables(hists[1])
    _equal(tk.huffman_tables64(hists[:1]), tk.huffman_tables_plain(hists[:1]))


def _dev_i32(a, dev):
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)


def test_pack_blocks_kernel(dev):
    """Random tokens, then every case of tc.pack_edge_cases (tile boundaries,
    zero runs, 32-bit tokens, drops at a boundary, the header's one-tile
    rows), each into an arena of random words (torch.empty leaves what was
    there: the kernel has to write every word)."""
    rng = np.random.default_rng(1)
    nbits = torch.from_numpy(rng.integers(0, 33, (3, 5000)).astype(np.int32)).to(dev)
    values = torch.from_numpy(rng.integers(0, 1 << 32, (3, 5000)).astype(np.uint32).view(np.int32)).to(dev)
    for n_words in (100, 6000):  # the first drops bits
        _equal(bc.pack_blocks(values, nbits, n_words), bc.pack_blocks_plain(values, nbits, n_words))
    with pytest.raises(ValueError, match="outside"):
        bc.pack_blocks(values, nbits + 1, 100)
    for name, (v, nb, n_words) in tc.pack_edge_cases().items():
        torch.randint(-(1 << 31), 1 << 31, (1 << 20,), dtype=torch.int32, device=dev)  # garbage for torch.empty
        v, nb = _dev_i32(v, dev), _dev_i32(nb, dev)
        got = bc.pack_blocks(v, nb, n_words)
        torch.cuda.synchronize()
        for g, w in zip(got, bc.pack_blocks_plain(v, nb, n_words)):
            assert torch.equal(g.cpu(), w.cpu()), name


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
    # every case of tc.pack_bytes_edge_cases: headers ending mid-word and on a word
    # boundary, n_valid mid-tile and 0, degenerate blocks, 32-bit codes, tile
    # boundaries that cut words, a drop at a boundary, the shared table (stride 0)
    for name, (blk, nv, tv, tb, hw, hb, n_words) in tc.pack_bytes_edge_cases().items():
        torch.randint(-(1 << 31), 1 << 31, (1 << 20,), dtype=torch.int32, device=dev)
        tv, tb, hw, hb = (_dev_i32(x, dev) for x in (tv, tb, hw, hb))
        if tv.shape[0] != blk.shape[0]:
            tv, tb, hw, hb = (x.expand(blk.shape[0], *x.shape[1:]) for x in (tv, tb, hw, hb))
        args = (torch.from_numpy(blk).to(dev), torch.from_numpy(nv).to(dev), tv, tb, hw, hb, n_words)
        got = bc.pack_bytes_blocks(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, bc.pack_bytes_blocks_plain(*args)):
            assert torch.equal(g.cpu(), w.cpu()), name


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


def _lz78_case(name):
    """numpy blocks and n_valid of one case of kernel E."""
    rng = np.random.default_rng(8)
    if name == "one letter [2, 262144]":  # phrases up to 724 bytes, far past a warp's 32
        blocks = np.full((2, 1 << 18), ord("a"), np.uint8)
        return blocks, np.array([1 << 18, (1 << 18) - 1000], np.int32)
    if name == "random [4, 8192]":  # the table near its worst load
        return rng.integers(0, 256, (4, 8192)).astype(np.uint8), np.full(4, 8192, np.int32)
    if name == "random [2, 65536]":  # tables in device memory
        return rng.integers(0, 256, (2, 65536)).astype(np.uint8), np.array([65536, 65000], np.int32)
    if name == "corpus [6, 4096]":  # tests/test_torch_lz78.py's _corpus
        bs = 4096
        blocks = np.zeros((6, bs), np.uint8)
        blocks[0] = rng.integers(0, 256, bs)
        blocks[1] = rng.integers(97, 100, bs)
        blocks[2] = 65
        blocks[3] = np.frombuffer((b"abracadabra " * (bs // 12 + 1))[:bs], np.uint8)
        blocks[4, : bs // 2] = rng.integers(0, 4, bs // 2)
        return blocks, np.array([bs, bs, bs, bs, bs // 2, 0], np.int32)
    if name == "empty, one byte, ragged [5, 3001]":
        b, nv = _text_blocks("cpu")
        return b.numpy(), nv.numpy()
    if name == "odd B [131, 1024]":
        words = [b"lz78 ", b"parse ", b"on ", b"the ", b"card. ", b"warp "]
        text = b"".join(rng.choice(words, 40000))[: 131 * 1024]
        blocks = np.frombuffer(text, np.uint8).reshape(131, 1024).copy()
        return blocks, rng.integers(0, 1025, 131).astype(np.int32)
    raise KeyError(name)


LZ78_CASES = ["one letter [2, 262144]", "random [4, 8192]", "random [2, 65536]", "corpus [6, 4096]",
              "empty, one byte, ragged [5, 3001]", "odd B [131, 1024]"]


@pytest.mark.parametrize("case", LZ78_CASES)
def test_lz78_parse_kernel_cases(dev, case):
    """Kernel E against its plain version and the host parse."""
    from tudocomp_tpu_torch.compressors.lz78 import lz78_parse

    blocks, n_valid = _lz78_case(case)
    b, nv = torch.from_numpy(blocks).to(dev), torch.from_numpy(n_valid).to(dev)
    kernels.reset_counts()
    got = lc.lz78_parse_blocks(b, nv)
    torch.cuda.synchronize()
    assert kernels.counts()["lz78_parse"] == 1
    _equal(got, lc.lz78_parse_blocks_plain(b, nv))
    parents, chars, nf = (t.cpu().numpy() for t in got)
    for i in range(len(blocks)):
        hp, hc = lz78_parse(blocks[i, : n_valid[i]])
        assert nf[i] == len(hp)
        np.testing.assert_array_equal(parents[i, : nf[i]], hp)
        np.testing.assert_array_equal(chars[i, : nf[i]], hc)


def test_lzw_parse_kernel(dev):
    blocks, n_valid = _text_blocks(dev)
    kernels.reset_counts()
    got = lc.lzw_parse_blocks(blocks, n_valid)
    torch.cuda.synchronize()
    assert kernels.counts()["lzw_parse"] == 1
    _equal(got, lc.lzw_parse_blocks_plain(blocks, n_valid))


@pytest.mark.parametrize("case", tc.LZW_CASES)
def test_lzw_parse_kernel_cases(dev, case):
    """Kernel F on the edge cases of its CPU emulation (tests/test_torch_lzw.py)
    against its plain version and the host parse; then launched on the least
    power of two of slots above the entries (long probe runs, wrap-around,
    the occupancy bitmap) and on a filled table too large for a bitmap."""
    from tudocomp_tpu_torch.compressors.lzw import lzw_parse

    blocks, n_valid = tc.lzw_case(case)
    b, nv = torch.from_numpy(blocks).to(dev), torch.from_numpy(n_valid).to(dev)
    kernels.reset_counts()
    got = lc.lzw_parse_blocks(b, nv)
    torch.cuda.synchronize()
    assert kernels.counts()["lzw_parse"] == 1
    _equal(got, lc.lzw_parse_blocks_plain(b, nv))
    want = [lzw_parse(blocks[i, : n_valid[i]]) for i in range(len(blocks))]
    for i, (g, w) in enumerate(zip(_equal_rows(got[0], got[1]), want)):
        np.testing.assert_array_equal(g, w, err_msg=f"block {i}")
    B, bs = blocks.shape
    for log2 in (max(4, max(len(w) for w in want).bit_length()), lc.BITMAP_LOG2 + 1):
        table = torch.full((B, 1 << log2), -1, dtype=torch.int64, device=dev)  # filled: read where no bitmap
        codes = torch.zeros((B, bs), dtype=torch.int32, device=dev)
        nf = torch.zeros(B, dtype=torch.int32, device=dev)
        kernels.launch("tdc_lzw_parse", b, bs, nv, B, table, log2, codes, nf)
        for i, (g, w) in enumerate(zip(_equal_rows(codes, nf), want)):
            np.testing.assert_array_equal(g, w, err_msg=f"block {i}, 2^{log2} slots")


def _equal_rows(codes, nf):
    codes, nf = codes.cpu().numpy(), nf.cpu().numpy()
    return [codes[i, : nf[i]].astype(np.uint32) for i in range(len(nf))]


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
    rows of sigma 0, 1, 2 and 256, weights past 2^31, and tc.table_rows."""
    rng = np.random.default_rng(6)
    hists = np.zeros((6, 256), np.int64)
    hists[0] = np.bincount(rng.zipf(1.3, 1 << 20).clip(0, 255), minlength=256)
    hists[2, 65] = 7
    hists[3, [3, 200]] = [5, 9]
    hists[4] = np.arange(1, 257)
    hists[5] = hists[0] * (1 << 22)
    hists = np.concatenate([hists, np.stack(list(tc.table_rows().values()))])
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
    assert all(launches[k] for k in ("pack_blocks", "pack_bytes_blocks", "decode_payloads"))
    assert launches["huffman_tables64"] == 1  # the one table, one launch
    assert launches["huffman_tables"] == launches["moffat_phase12"] == 0
    assert c == compress(algo, raw, device="cpu")  # the plain versions
    assert decompress(c, device="cpu") == raw  # the host decoder


# ---- the probe kernels (csrc/probes.cu) and the lzss_lcp suffix stack -----------------------


def test_probe3_gather_kernel(dev):
    from tudocomp_tpu_torch import probes

    vals, nb = probes.probe3_inputs(dev, B=5, bs=3001)
    S = probes.hillis_xor(vals)
    idx = probes.hist2(nb, 900).clamp(0, S.shape[1] - 1)
    kernels.reset_counts()
    got = probes.gather(S, idx)
    torch.cuda.synchronize()
    assert kernels.counts()["probe3_gather"] == 1
    _equal((got,), (probes.gather_plain(S, idx),))
    with pytest.raises(IndexError):
        probes.gather(S, idx + S.shape[1])


@pytest.mark.parametrize("tile", ["arange", "signed"])
def test_probe6_kernels(dev, tile):
    from tudocomp_tpu_torch import probes

    if tile == "arange":
        x = torch.arange(1024, dtype=torch.int32, device=dev).reshape(8, 128)
    else:
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (8, 128)).astype(np.int32)).to(dev)
    pairs = [
        (probes.roll_lane, probes.roll_lane_plain, "probe6_roll_lane"),
        (probes.roll_sublane, probes.roll_sublane_plain, "probe6_roll_sublane"),
        (probes.scalar_extract, probes.scalar_extract_plain, "probe6_extract"),
        (probes.broadcast_last_lane, probes.broadcast_last_lane_plain, "probe6_bid"),
        (probes.onehot_count, probes.onehot_count_plain, "probe6_dot3"),
        (probes.var_shift, probes.var_shift_plain, "probe6_shift"),
    ]
    kernels.reset_counts()
    for kernel, plain, name in pairs:
        _equal((kernel(x),), (plain(x),))
        assert kernels.counts()[name] == 1, name
    for i in (0, 300, 767):
        t = torch.tensor([[i]], dtype=torch.int32, device=dev)
        _equal((probes.window_rmw(t),), (probes.window_rmw_plain(t),))
    assert kernels.counts()["probe6_rmw"] == 3
    with pytest.raises(IndexError):
        probes.window_rmw(torch.tensor([[1152]], dtype=torch.int32, device=dev))


@pytest.mark.parametrize("layout", ["contiguous", "misaligned", "transposed"])
def test_probe6_roll_sublane_kernel(dev, layout):
    """The row copy against torch.roll on tiles off a 16-byte bound or not
    contiguous (the wrapper copies those into an aligned tile)."""
    from tudocomp_tpu_torch import probes

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (8, 128)).astype(np.int32)).to(dev)
    if layout == "misaligned":  # one word past a 16-byte bound
        x = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape).copy_(x)
        assert x.data_ptr() % 16
    elif layout == "transposed":
        x = x.t().contiguous().t()
        assert not x.is_contiguous()
    kernels.reset_counts()
    assert torch.equal(probes.roll_sublane(x).cpu(), torch.roll(x, 1, 0).cpu())
    assert kernels.counts()["probe6_roll_sublane"] == 1


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_probe7_pack_kernel(dev, level):
    from tudocomp_tpu_torch import probes

    vals, nbits = probes.probe7_inputs(dev)
    nbits[0, 100:140] = 0  # runs of empty tokens
    nbits[1, 2000:2040] = 32
    kernels.reset_counts()
    got = probes.pack_levels(vals, nbits, probes.P7_NWP, level, want_mid=True)
    torch.cuda.synchronize()
    assert kernels.counts()["probe7_pack"] == 1
    want = probes.pack_levels_plain(vals, nbits, probes.P7_NWP, level, want_mid=True)
    _equal(got[:2], want[:2])
    if level in (2, 3, 4):
        _equal(got[2:], want[2:])
    else:
        assert got[2] is None and want[2] is None
    if level == 5:  # kernel A packs the same arena; a short arena drops bits in both
        for n_wp in (probes.P7_NWP, 1000):
            words, bits = probes.pack_levels(vals, nbits, n_wp, 5)
            a_words, a_bits = bc.pack_blocks(vals, nbits, n_wp)
            _equal((words[:, 0], bits[:, 0, 0]), (a_words, a_bits))
    with pytest.raises(ValueError):
        probes.pack_levels(vals, nbits + 1, probes.P7_NWP, level)


@pytest.mark.parametrize("widths", tc.P7_WIDTHS)
@pytest.mark.parametrize("nt", [1024, 3072, 5120])
def test_probe7_pack_kernel_tiles(dev, nt, widths):
    """The tile-parallel pack at every level against its plain version, mid
    included: widths 0, 32 and a mix whose row 0 shares a boundary word
    between every two tiles; level 5 also on an arena that drops bits, and
    against kernel A."""
    from tudocomp_tpu_torch import probes

    vals, nbits = tc.p7_tokens(nt, widths, seed=nt)
    v, nb = torch.from_numpy(vals.view(np.int32)).to(dev), torch.from_numpy(nbits).to(dev)
    for n_wp in (nt + 32, nt // 3):
        for level in (1, 2, 3, 4, 5) if n_wp > nt else (5,):
            kernels.reset_counts()
            got = probes.pack_levels(v, nb, n_wp, level, want_mid=True)
            assert kernels.counts()["probe7_pack"] == 1
            want = probes.pack_levels_plain(v, nb, n_wp, level, want_mid=True)
            _equal(got[:2], want[:2])
            if want[2] is not None:
                _equal(got[2:], want[2:])
        a_words, a_bits = bc.pack_blocks(v, nb, n_wp)
        _equal((got[0][:, 0], got[1][:, 0, 0]), (a_words, a_bits))


def test_probe8_kernels(dev):
    from tudocomp_tpu_torch import probes

    rng = np.random.default_rng(8)
    inputs = [
        torch.ones((2, 3, 8, 128), dtype=torch.int32, device=dev),
        torch.from_numpy(rng.integers(0, 33, (5, 4, 8, 128)).astype(np.int32)).to(dev),
    ]
    pairs = [
        (probes.carry_revisit, probes.carry_revisit_plain, "probe8_a"),
        (probes.carry_scans, probes.carry_scans_plain, "probe8_b"),
        (probes.carry_into_vector, probes.carry_into_vector_plain, "probe8_c"),
        (probes.rmw_loop8, probes.rmw_loop8_plain, "probe8_d"),
    ]
    kernels.reset_counts()
    for v in inputs:
        for kernel, plain, _ in pairs:
            _equal(kernel(v), plain(v))
    assert all(kernels.counts()[name] == 2 for _, _, name in pairs)


def test_probes_entry_point_on_the_card(dev, capsys):
    from tudocomp_tpu_torch import probes

    kernels.reset_counts()
    assert probes.main([]) == 0
    assert "done" in capsys.readouterr().out
    assert all(n > 0 for k, n in kernels.counts().items() if k.startswith("probe"))


def _suffix_texts():
    rng = np.random.default_rng(9)
    words = [b"suffix ", b"array ", b"on ", b"the ", b"card. ", b"lcp "]
    return {
        "english": b"".join(rng.choice(words, 60000)),
        "dna": bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 300000)),
        "a^n": b"a" * 50000,
        "twice": b"".join(rng.choice(words, 20000)) * 2,
    }


@pytest.mark.parametrize("name", ["english", "dna", "a^n", "twice"])
def test_suffix_stack_on_the_card(dev, name):
    """SA, ISA, PLCP, LCP and the factors on the card equal the C++ host code's."""
    from tudocomp_tpu_torch.compressors.lzss_lcp import lcp_factorize
    from tudocomp_tpu_torch.ds.suffix_array import suffix_array_device
    from tudocomp_tpu_torch.ds.textds import TextDS
    from tudocomp_tpu_torch.ops.lzss_torch import lzss_lcp_factorize_device
    from tudocomp_tpu_torch.ops.plcp_torch import lcp_device, plcp_device, plcp_device_plain

    text = np.frombuffer(_suffix_texts()[name] + b"\0", np.uint8).copy()
    ds = TextDS(text, device="cpu")
    sa, isa, lcp = ds.require_sa(), ds.require_isa(), ds.require_lcp()
    t = torch.from_numpy(text).to(dev)
    sa_d, isa_d = suffix_array_device(t, return_isa=True)
    assert np.array_equal(sa_d.cpu().numpy(), sa) and np.array_equal(isa_d.cpu().numpy(), isa)
    kernels.reset_counts()
    assert np.array_equal(lcp_device(t, sa_d).cpu().numpy(), lcp)
    assert kernels.counts()["plcp_segments"] == 1
    if name not in ("a^n", "twice"):  # the lockstep walk takes max_lcp / 4 steps for its first lane
        assert torch.equal(plcp_device(t, sa_d), plcp_device_plain(t, sa_d, seg=512))
    lcp_d = torch.from_numpy(lcp).to(dev)
    for threshold in (2, 3):
        pos, src, ln = lzss_lcp_factorize_device(sa_d, isa_d, lcp_d, threshold)
        want = lcp_factorize(sa, isa, lcp, threshold, "cpu")
        assert np.array_equal(pos, want.pos) and np.array_equal(src, want.src) and np.array_equal(ln, want.len)


@pytest.mark.parametrize("seg", [2, 3, 32, 1000])
def test_kernel_h_levels(dev, seg):
    """Kernel H gives the host's PLCP whatever its chain length, that is
    however many levels it runs in."""
    from tudocomp_tpu_torch.ds.textds import TextDS

    for name in ("a^n", "twice"):
        text = np.frombuffer(_suffix_texts()[name][:30011] + b"\0", np.uint8).copy()
        ds = TextDS(text, device="cpu")
        sa, want = ds.require_sa(), ds.require_plcp()
        phi = torch.empty(len(text), dtype=torch.int32, device=dev)
        plcp = torch.full((len(text),), -1, dtype=torch.int32, device=dev)  # every entry is written
        t = torch.from_numpy(text).to(dev)
        kernels.launch("tdc_plcp_segments", t, torch.from_numpy(sa).to(dev), len(text), seg, phi, plcp)
        assert np.array_equal(plcp.cpu().numpy(), want)


@pytest.mark.parametrize("name", tc.PLCP_CASES)
def test_kernel_h_cases(dev, name):
    """Kernel H (phi on the card, the levels' chains) against the host's
    PLCP and its plain version: n = 0, 1, 2, the sizes around its level
    boundaries, one letter, a period of 1000, English and DNA; a text one
    byte off an 8-byte bound is copied to one on it."""
    from tudocomp_tpu_torch.ds.textds import TextDS
    from tudocomp_tpu_torch.ops.plcp_torch import lcp_device, plcp_device, plcp_device_plain

    text = tc.plcp_text(name)
    if len(text):
        ds = TextDS(text, device="cpu")
        sa, want, lcp = ds.require_sa(), ds.require_plcp(), ds.require_lcp()
    else:
        sa = want = lcp = np.zeros(0, np.int32)
    sa_d = torch.from_numpy(np.ascontiguousarray(sa, np.int32)).to(dev)
    for t in (torch.from_numpy(text).to(dev),
              torch.empty(len(text) + 1, dtype=torch.uint8, device=dev)[1:].copy_(torch.from_numpy(text))):
        kernels.reset_counts()
        got = plcp_device(t, sa_d)
        torch.cuda.synchronize()
        assert kernels.counts()["plcp_segments"] == (1 if len(text) else 0)
        assert np.array_equal(got.cpu().numpy(), want)
        assert np.array_equal(lcp_device(t, sa_d).cpu().numpy(), lcp)
    assert torch.equal(got, plcp_device_plain(t, sa_d))


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("name", tc.DECODE_CASES)
def test_decode_kernel_cases(dev, name, wide):
    """Kernel D against its plain version (out and counts, also where the
    wrapper raises: a code past 32 bits, a stream past max_out) on the
    cases of tests/torch_cases.py; wide: the words padded to 16384 a row,
    so the launch takes 1024 threads and chunks of 32 bits, which start
    inside codes."""
    case = tc.decode_case(name)
    arrays = tc.stack_streams([case["stream"]], min_words=16384 if wide else 1)
    args = tuple(torch.from_numpy(a).to(dev) for a in arrays)
    n, W = args[0].shape
    max_out = case["max_out"]
    out = torch.zeros((n, max_out), dtype=torch.uint8, device=dev)
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    rounds = torch.zeros(n, dtype=torch.int32, device=dev)
    kernels.reset_counts()
    kernels.launch("tdc_decode_payloads", args[0], W, *args[1:], n, out, max_out, counts, rounds)
    torch.cuda.synchronize()
    assert kernels.counts()["decode_payloads"] == 1
    _equal((out, counts), hd.decode_payloads_plain(*args, max_out))
    if name in ("identity", "all-8", "all-5", "tail-4"):  # one code length: no round
        assert int(rounds[0]) == 0
    if case["data"] is None:
        with pytest.raises(ValueError):
            hd.decode_payloads(*args, max_out)
    else:
        got, cnt = hd.decode_payloads(*args, max_out)
        assert got[0, : int(cnt[0])].cpu().numpy().tobytes() == case["data"]


@pytest.mark.parametrize(
    "algo", ["lzss_lcp(coder=huff)", "blockwise(lzss_lcp(coder=huff),bs=65536)",
             "blockwise(lzss_lcp(coder=huff),bs=65536,shared=1)"],
)
def test_lzss_roundtrip_on_the_card(dev, algo, monkeypatch):
    """The device stack (both gates forced on) writes the host stack's bytes."""
    data = _suffix_texts()["english"][:300000] + _suffix_texts()["dna"][:100000] + b"\0\0tail"
    monkeypatch.setenv("TDC_DEVICE_SA", "1")
    monkeypatch.setenv("TDC_DEVICE_LZSS", "1")
    c = compress(algo, data, device="cuda")
    assert decompress(c, device="cuda") == data
    monkeypatch.setenv("TDC_DEVICE_SA", "0")
    monkeypatch.setenv("TDC_DEVICE_LZSS", "0")
    assert c == compress(algo, data, device="cpu")


ESP_EDGE = sorted(tc.esp_edge_spans())


@pytest.mark.parametrize("case", ESP_EDGE)
def test_esp_adjust_kernel_edge_spans(dev, case):
    """Kernel I against its plain version on the edge spans: widths 1 to 260,
    all ones, alternating types, no spans, spans past ns; for its warps,
    spans of width 1, ns at the static bound with the last warp partly
    filled, a span wider than the shared slot, spans past a warp's staging
    capacity."""
    from tudocomp_tpu_torch.ops.esp_kernels import esp_adjust_windows, esp_adjust_windows_plain

    lens, typs, ws, we, ns = tc.esp_edge_spans(dev)[case]
    want = [lens.cpu(), typs.cpu()]
    esp_adjust_windows_plain(*want, ws.cpu(), we.cpu(), ns.cpu())
    kernels.reset_counts()
    esp_adjust_windows(lens, typs, ws, we, ns)  # in place
    torch.cuda.synchronize()
    assert kernels.counts()["esp_adjust_windows"] == 1
    _equal((lens, typs), want)


def test_esp_rounds_on_the_card(dev):
    """Every device round of 1 MiB of text: kernel I against its plain
    version on the round's spans, and the grammar equal to the host rounds'."""
    from tudocomp_tpu_torch.compressors.esp import generate_grammar
    from tudocomp_tpu_torch.ops import esp_torch as et
    from tudocomp_tpu_torch.ops.esp_kernels import esp_adjust_windows, esp_adjust_windows_plain

    data = np.frombuffer(tc.english(1 << 20, seed=5) + bytes(range(256)) * 16, np.uint8)
    size = 1 << 21
    src = et.padded(data, size, dev)
    m = torch.tensor(len(data), dtype=torch.int32, device=dev)
    alphabet = torch.tensor(256, dtype=torch.int32, device=dev)
    while size // 2 >= 1 << 12:
        lens, typs, nb = et.stage_blocks(src, m, alphabet)
        ws, we, ns = et.adjust_spans(lens, nb)
        want = [lens.clone(), typs.clone()]
        esp_adjust_windows_plain(*want, ws, we, ns)
        esp_adjust_windows(lens, typs, ws, we, ns)  # in place
        _equal((lens, typs), want)
        src, m, _rl, _rr, alphabet, overflow = et.round_body(src, m, alphabet)
        assert not bool(overflow)
        size //= 2
    kernels.reset_counts()
    got = et.esp_grammar_device(data, threshold=1 << 12, device=dev)
    assert kernels.counts()["esp_adjust_windows"] == 9
    want = generate_grammar(data)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


@pytest.mark.parametrize("threshold", [1, 5])
def test_lcpcomp_plcppeaks_stage_on_the_card(dev, threshold, monkeypatch):
    """plcppeaks_factorize_device on CUDA tensors equals its run on the CPU,
    from the arrays of TextDS (the card's, where the card built the SA)."""
    from tudocomp_tpu_torch.ds.textds import TextDS
    from tudocomp_tpu_torch.ops.lcpcomp_torch import plcppeaks_factorize_device

    monkeypatch.setenv("TDC_DEVICE_SA", "1")
    text = np.frombuffer(_suffix_texts()["english"][:300000] + b"abcab" * 4000 + b"\0", np.uint8)
    ds = TextDS(text, device=dev)
    arrays = ds.device_arrays()
    assert arrays is not None and all(a.is_cuda for a in arrays)
    got = plcppeaks_factorize_device(*arrays, threshold)
    want = plcppeaks_factorize_device(*(a.cpu() for a in arrays), threshold)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) > 1000


@pytest.mark.parametrize("seed", [0, 1])
def test_lcpcomp_resolve_stage_on_the_card(dev, seed):
    """resolve_factors_device on the card equals its run on the CPU, on a
    seeded factor set with forward and backward chains."""
    from tests.test_torch_lcpcomp import _random_factors
    from tudocomp_tpu_torch.ops.lcpcomp_torch import resolve_factors_device

    text, buf, tgt, src, lens = _random_factors(seed)
    got = resolve_factors_device(buf.copy(), tgt, src, lens, dev)
    np.testing.assert_array_equal(got, resolve_factors_device(buf.copy(), tgt, src, lens, "cpu"))
    np.testing.assert_array_equal(got, text)


def test_lcpcomp_plcppeaks_roundtrip_on_the_card(dev, monkeypatch):
    """1 MiB through lcpcomp(coder=huff,comp=plcppeaks) with the device
    stages forced: the container equals the host path's and both decodes
    return the input."""
    algo = "lcpcomp(coder=huff,comp=plcppeaks)"
    data = tc.english(1 << 20, seed=3)
    monkeypatch.setenv("TDC_DEVICE_LCPCOMP", "1")
    c = compress(algo, data, device="cuda")
    assert decompress(c, device="cuda") == data
    for var in ("TDC_DEVICE_LCPCOMP", "TDC_DEVICE_SA", "TDC_DEVICE_LZSS"):
        monkeypatch.setenv(var, "0")
    assert c == compress(algo, data, device="cpu")
    assert decompress(c, device="cpu") == data


MTF_CASES = [*sorted(tc.mtf_edge_cases()), "random 256", "english 1 MiB"]


def _mtf_input(case: str) -> bytes:
    if case == "random 256":
        return bytes(np.random.default_rng(21).integers(0, 256, 300_001).astype(np.uint8))
    if case == "english 1 MiB":
        return tc.english(1 << 20, seed=4)
    return tc.mtf_edge_cases()[case]


def _host_mtf(data: bytes) -> np.ndarray:
    from tudocomp_tpu_torch import native

    arr = np.ascontiguousarray(np.frombuffer(data, np.uint8))
    out = np.empty(len(arr), np.uint8)
    if len(arr):
        native.get_lib().tdc_mtf_encode(arr, len(arr), out)
    return out


@pytest.mark.parametrize("chunk", [128, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("case", MTF_CASES)
def test_mtf_kernel_cases(dev, case, chunk):
    """Kernel J against its plain version and the host's table walk, at the
    smallest chunk and each of chip_smoke.py's MTF_CHUNKS (the walkers'
    edges: less than a sub-chunk, one byte past a chunk, runs across every
    sub-chunk boundary, all 256 symbols in each sub-chunk at 8192, rank 255
    at every step in the cycle of 256); one launch a call (none for an
    empty input)."""
    from tudocomp_tpu_torch.ops.mtf_cuda import mtf_encode_chunks
    from tudocomp_tpu_torch.ops.transforms_torch import mtf_encode_plain

    data = _mtf_input(case)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    kernels.reset_counts()
    got = mtf_encode_chunks(x, chunk)
    assert kernels.counts()["mtf_encode"] == (1 if data else 0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), _host_mtf(data))
    np.testing.assert_array_equal(got.cpu().numpy(), mtf_encode_plain(x, chunk).cpu().numpy())


def test_bwt_gather_on_the_card(dev, monkeypatch):
    """TextDS.bwt gathers on the card where the card built the SA and gives
    the host's BWT."""
    from tudocomp_tpu_torch.ds.textds import TextDS

    text = np.frombuffer(tc.english(1 << 18, seed=5) + b"\0", np.uint8)
    monkeypatch.setenv("TDC_DEVICE_SA", "1")
    ds = TextDS(text, device=dev)
    got = ds.bwt()
    assert ds._sa_d is not None and ds._sa_d.is_cuda
    monkeypatch.setenv("TDC_DEVICE_SA", "0")
    np.testing.assert_array_equal(got, TextDS(text).bwt())


@pytest.mark.parametrize("algo", ["rle:mtf:encode(vbyte)", "bwt:rle:mtf:encode(huff)"])
def test_transforms_roundtrip_on_the_card(dev, algo, monkeypatch):
    """1 MiB through the transform chains with the device stages forced: J
    launched, the container equal to the host path's, both decodes the
    input."""
    data = tc.english(1 << 20, seed=6)
    for var in ("TDC_DEVICE_RLE", "TDC_DEVICE_MTF", "TDC_DEVICE_SA"):
        monkeypatch.setenv(var, "1")
    kernels.reset_counts()
    c = compress(algo, data, device="cuda")
    assert kernels.counts()["mtf_encode"] == 1
    assert decompress(c, device="cuda") == data
    for var in ("TDC_DEVICE_RLE", "TDC_DEVICE_MTF", "TDC_DEVICE_SA"):
        monkeypatch.setenv(var, "0")
    assert c == compress(algo, data, device="cpu")
    assert decompress(c, device="cpu") == data


def test_cli_stats_on_the_card(dev, tmp_path):
    """`python -m tudocomp_tpu_torch -a lz78u -s` on the card: the container
    equals the host path's and the phases carry the card's memory."""
    import json
    import os
    import subprocess
    import sys

    src = tmp_path / "in.txt"
    src.write_bytes(tc.english(300 << 10, seed=5))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "tudocomp_tpu_torch", "-a", "lz78u", str(src), "-s"],
                       capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=root), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    doc = json.loads(r.stdout.splitlines()[-1])
    keys = {s["key"] for s in doc["data"]["stats"]}
    assert {"devMemOff", "devMemPeak", "devMemFinal"} <= keys
    peak = int(next(s["value"] for s in doc["data"]["stats"] if s["key"] == "devMemPeak"))
    assert peak > 300 << 10  # the text and its suffix array were on the card
    os.environ["TDC_DEVICE_SA"] = "0"
    try:
        want = compress("lz78u", src.read_bytes(), device="cpu")
    finally:
        del os.environ["TDC_DEVICE_SA"]
    assert (tmp_path / "in.txt.tdc").read_bytes() == want


@pytest.mark.parametrize("algo", ["lz78u", "lfs_comp(computing_strat=sim_st)", "lfs2",
                                  "blockwise(blockwise(encode(huff),bs=65536),bs=262144)"])
def test_matrix_tail_on_the_card(dev, algo):
    """The suffix-tree families with the suffix array, ISA and LCP from the
    card (kernel H launched), and the nested blockwise through kernels A-D,
    give the host path's bytes."""
    data = tc.english((256 << 10) + 1, seed=6)
    kernels.reset_counts()
    got = compress(algo, data, device="cuda")
    counts = kernels.counts()
    if algo.startswith("blockwise"):
        assert all(counts[k] > 0 for k in ("pack_blocks", "pack_bytes_blocks", "huffman_tables"))
    else:
        assert counts["plcp_segments"] > 0
    assert decompress(got, device="cuda") == data
    import os

    env = ("TDC_DEVICE_SA", "TDC_DEVICE_HUFF")
    os.environ.update({v: "0" for v in env})
    try:
        want = compress(algo, data, device="cpu")
    finally:
        for v in env:
            del os.environ[v]
    assert got == want


_RANK = """
import os, sys
import torch
from tudocomp_tpu_torch import kernels
from tudocomp_tpu_torch.parallel.distributed import init_distributed, pod_compress

assert init_distributed(timeout_s=300)
out, rank = sys.argv[1], int(os.environ["TDC_PROCESS_ID"])
for name in sorted(f for f in os.listdir(out) if f.endswith(".input")):
    with open(os.path.join(out, name), "rb") as f:
        data = f.read()
    inner = name.split(".")[0]
    for shared in (False, True):
        kernels.reset_counts()
        bs = 262144 if inner == "lzss" else 65536  # lzss: the SA, and kernel H, on the card from 256 KiB
        got = pod_compress(data, bs, shared_table=shared, inner=inner, device="cuda:0")
        torch.cuda.synchronize()
        launches = kernels.counts()
        assert launches["plcp_segments" if inner == "lzss" else "pack_bytes_blocks"] > 0, launches
        assert (got is None) == (rank != 0)
        if got is not None:
            with open(os.path.join(out, f"{inner}-{int(shared)}.bin"), "wb") as f:
                f.write(got)
assert "jax" not in sys.modules and "tudocomp_tpu" not in sys.modules
"""


def test_two_gloo_ranks_on_one_card(dev, tmp_path):
    """Two gloo ranks sharing card 0 (each encodes its half of the blocks on
    the card; the histogram and the payloads cross on the host): pod_compress
    with the huff inner and the lzss inner, shared 0 and 1, gives the
    one-process card run's container and the host path's."""
    import os
    import socket
    import subprocess
    import sys

    from tudocomp_tpu_torch.parallel import runtime

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rng = np.random.default_rng(4)
    inputs = {"huff": bytes(rng.zipf(1.3, 1 << 20).clip(0, 255).astype(np.uint8)),
              "lzss": tc.english(1 << 20, seed=8)}  # 16 blocks of 64 KiB, 4 of 256 KiB
    for inner, data in inputs.items():
        (tmp_path / f"{inner}.input").write_bytes(data)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=root, TDC_NUM_PROCESSES="2", TDC_PROCESS_ID=str(r),
                                       TDC_COORDINATOR=f"127.0.0.1:{port}"))
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    for inner, data in inputs.items():
        fn = runtime.blockwise_lzss_compress if inner == "lzss" else runtime.blockwise_huffman_compress
        bs = 262144 if inner == "lzss" else 65536
        for shared in (False, True):
            got = (tmp_path / f"{inner}-{int(shared)}.bin").read_bytes()
            assert got == fn(data, bs, dev, shared_table=shared)
            os.environ.update({v: "0" for v in ("TDC_DEVICE_SA", "TDC_DEVICE_LZSS", "TDC_DEVICE_HUFF")})
            try:
                assert got == fn(data, bs, "cpu", shared_table=shared)
            finally:
                for v in ("TDC_DEVICE_SA", "TDC_DEVICE_LZSS", "TDC_DEVICE_HUFF"):
                    del os.environ[v]
