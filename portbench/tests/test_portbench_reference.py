"""The plain references against the port on the CPU, their independence, and the controls.

The tests import the port (`tudocomp_tpu_torch`, on the CPU: its host
paths); the references themselves import nothing of it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.corpora import synth_english
from portbench.reference import bitstream, blockwise_huff, lzss_lcp

port = pytest.importorskip("tudocomp_tpu_torch.driver")

RNG = np.random.default_rng(20)
INPUTS = {
    "empty": b"",
    "one": b"a",
    "run": b"z" * 5000,
    "two": b"ab",
    "period": b"abababababababab" * 37,
    "nul_and_ff": b"\x00\xff\x00abc\xff\xffabcabc\x00" * 9,
    "all_bytes": bytes(range(256)) * 3,
    "english": synth_english.generate(2**31 + 5, 0, 70_001),
    "dna": RNG.integers(0, 4, 60_000).astype(np.uint8).tobytes(),
    "random": RNG.integers(0, 256, 20_000).astype(np.uint8).tobytes(),
    "zipf": RNG.zipf(1.3, 50_000).clip(0, 255).astype(np.uint8).tobytes(),
    "long_repeat": b"x" * 3000 + b"y" + b"x" * 3000 + synth_english.generate(1, 1, 3000) * 3,
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_lzss_lcp_container_equals_the_port(name):
    data = INPUTS[name]
    algo = "lzss_lcp(coder=huff)"
    assert lzss_lcp.compress(algo, data, {"threshold": 3}, "cpu") == port.compress(algo, data, device="cpu")


@pytest.mark.parametrize("threshold", [1, 2, 5, 16])
def test_lzss_lcp_thresholds(threshold):
    data = INPUTS["english"][:20_000]
    algo = f"lzss_lcp(coder=huff,threshold={threshold})"
    assert lzss_lcp.compress(algo, data, {"threshold": threshold}, "cpu") == port.compress(algo, data, device="cpu")


@pytest.mark.parametrize("bs", [4096, 65536])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_blockwise_huff_container_equals_the_port(name, bs):
    data = INPUTS[name]
    algo = f"blockwise(encode(huff),bs={bs})"
    got = blockwise_huff.compress(algo, data, {"block_size": bs}, "cpu")
    assert got == port.compress(algo, data, device="cpu")
    assert port.decompress(got, device="cpu") == data


def test_lzss_lcp_reference_arrays():
    """The suffix array, LCP and smaller values by brute force."""
    for data in (b"mississippi", INPUTS["period"][:300], INPUTS["english"][:2000]):
        text = torch.from_numpy(lzss_lcp.escaped_text(data))
        t = bytes(text.numpy())
        sa, isa, levels = lzss_lcp.suffix_ranks(text)
        want = sorted(range(len(t)), key=lambda i: t[i:])
        assert sa.tolist() == want
        assert isa[sa].tolist() == list(range(len(t)))
        lcp = lzss_lcp.lcp_array(sa, levels)

        def lcp2(a, b):
            k = 0
            while a + k < len(t) and b + k < len(t) and t[a + k] == t[b + k]:
                k += 1
            return k

        assert lcp.tolist() == [0] + [lcp2(want[c - 1], want[c]) for c in range(1, len(t))]
        psv_src, psv_lcp, nsv_src, nsv_lcp = lzss_lcp.smaller_values(sa, lcp)
        s = sa.tolist()
        for c in range(0, len(t), 7):
            p = next((j for j in range(c - 1, -1, -1) if s[j] < s[c]), -1)
            q = next((j for j in range(c + 1, len(t)) if s[j] < s[c]), len(t))
            assert psv_src[c] == (s[p] if p >= 0 else -1)
            assert psv_lcp[c] == (min(lcp[p + 1 : c + 1].tolist()) if p >= 0 else 0)
            assert nsv_src[c] == (s[q] if q < len(t) else -1)
            assert nsv_lcp[c] == (min(lcp[c + 1 : q + 1].tolist()) if q < len(t) else 0)


def test_greedy_path():
    step = torch.tensor([3, 1, 5, 1, 2, 9, 1, 1, 1, 4, 1, 1])
    path, i = [], 0
    while i < len(step):
        path.append(i)
        i += int(step[i])
    assert lzss_lcp.greedy_path(step).tolist() == path


def test_bitstream_closing_and_wide_tokens():
    assert bitstream.pack(torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64)) == b"\x00"
    one = lambda v, w: bitstream.pack(torch.tensor(v), torch.tensor(w))  # noqa: E731
    assert one([1], [1]) == bytes([0b1000_0001])
    assert one([0b101101], [6]) == bytes([0b1011_0100, 6])
    assert one([0xAB], [8]) == bytes([0xAB, 0])
    wide = (1 << 40) + 12345
    # 41 bits in 6 bytes, the 41 % 8 = 1 valid bits of the last ORed in
    assert one([wide], [41]) == int.to_bytes((wide << 7) | 1, 6, "big")
    assert one([5, wide], [3, 41]) == int.to_bytes((5 << 45) | (wide << 4) | 4, 6, "big")
    streams = bitstream.pack_streams(torch.tensor([1, 3, 0xFFFF]), torch.tensor([1, 2, 16]), [1, 0, 2])
    assert streams == [bytes([0b1000_0001]), b"\x00", bytes([0b11111111, 0b11111111, 0b11000010])]
    assert bitstream.compressed_int(300) == [(1, 1), (300 & 127, 7), (0, 1), (2, 7)]


def test_controls_break_the_format_and_stay_decodable():
    data = synth_english.generate(9, 0, 300_000)
    algo = "lzss_lcp(coder=huff)"
    c = lzss_lcp.control(algo, data, {"threshold": 3}, "cpu")
    assert c != lzss_lcp.compress(algo, data, {"threshold": 3}, "cpu")
    assert port.decompress(c, device="cpu") == data
    algo = "blockwise(encode(huff),bs=65536)"
    cfg = {"block_size": 65536}
    c = blockwise_huff.control(algo, data, cfg, "cpu")
    assert c != blockwise_huff.compress(algo, data, cfg, "cpu")
    assert port.decompress(c, device="cpu") == data


def test_references_import_nothing_of_the_program_nor_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.reference import lzss_lcp, blockwise_huff, bitstream, huffman\n"
        "from portbench.corpora import synth_english\n"
        "d = synth_english.generate(1, 0, 5000)\n"
        "lzss_lcp.compress('lzss_lcp(coder=huff)', d, {}, 'cpu')\n"
        "blockwise_huff.compress('blockwise(encode(huff),bs=4096)', d, {'block_size': 4096}, 'cpu')\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', 'tudocomp_tpu', 'tudocomp_tpu_torch'}))\n" % ROOT
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
    for f in os.listdir(os.path.join(ROOT, "portbench", "reference")):
        if f.endswith(".py"):
            src = open(os.path.join(ROOT, "portbench", "reference", f)).read()
            assert "tudocomp_tpu" not in src.replace("tudocomp's", ""), f
