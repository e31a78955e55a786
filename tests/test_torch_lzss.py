"""The port's lzss_lcp path on the CPU against the JAX package.

ansv_minlcp, greedy_visited and lzss_lcp_factorize_device of the port run
on CPU tensors and must equal the JAX functions of tudocomp_tpu/ops/lzss_jax
and the C++ factorizer, on the corpus of tests/test_lzss_device.py with
thresholds 2 and 3. The containers of lzss_lcp(coder=C) for every coder the
port registers, and of blockwise(lzss_lcp(coder=huff)) with and without
shared=1, must equal the JAX package's byte for byte, each package decoding
the other's, with the device suffix array and the device factorization each
forced on and off, and once with the C++ helpers switched off. Everything
is integer: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.ops import lzss_jax
from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.compressors.lzss_lcp import lcp_factorize
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.ds.textds import TextDS
from tudocomp_tpu_torch.ops import lzss_torch
from tudocomp_tpu_torch.parallel.runtime import blockwise_lzss_compress
from tudocomp_tpu_torch.registry import TorchRegistry

from .util import CORPUS, generator_strings

TEXTS = [d for d in CORPUS[1:] + generator_strings()[:4] if d]


def _textds(data: bytes):
    ds = TextDS(np.frombuffer(data.replace(b"\0", b"\1") + b"\0", np.uint8))
    return ds.require_sa(), ds.require_isa(), ds.require_lcp()


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("data", TEXTS, ids=lambda d: repr(d[:12]))
def test_ansv_matches_jax(data):
    sa, _, lcp = _textds(data)
    got = lzss_torch.ansv_minlcp(*_t(sa, lcp))
    want = lzss_jax.ansv_minlcp(jnp.asarray(sa), jnp.asarray(lcp))
    for g, w, name in zip(got, want, ["psv_src", "psv_lcp", "nsv_src", "nsv_lcp"]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 3, 17, 256, 1000])
def test_greedy_visited_matches_jax_and_the_walk(n):
    step = np.random.default_rng(7).integers(0, 9, n).astype(np.int32)  # 0 counts as 1
    got = lzss_torch.greedy_visited(torch.from_numpy(step)).numpy()
    want = np.zeros(n, bool)
    i = 0
    while i < n:
        want[i] = True
        i += max(int(step[i]), 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(lzss_jax.greedy_visited(jnp.asarray(step))))


@pytest.mark.parametrize("data", TEXTS, ids=lambda d: repr(d[:12]))
@pytest.mark.parametrize("threshold", [2, 3])
def test_device_factorize_matches_host_and_jax(data, threshold, monkeypatch):
    sa, isa, lcp = _textds(data)
    pos, src, ln = lzss_torch.lzss_lcp_factorize_device(*_t(sa, isa, lcp), threshold)
    monkeypatch.setenv("TDC_DEVICE_LZSS", "0")
    want = lcp_factorize(sa, isa, lcp, threshold)  # the C++ monotone stacks
    np.testing.assert_array_equal(pos, want.pos)
    np.testing.assert_array_equal(src, want.src)
    np.testing.assert_array_equal(ln, want.len)
    jpos, jsrc, jln = lzss_jax.lzss_lcp_factorize_device(sa, isa, lcp, threshold)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(src, jsrc)
    np.testing.assert_array_equal(ln, jln)
    monkeypatch.setenv("TDC_DEVICE_LZSS", "1")  # through the gate
    via_gate = lcp_factorize(sa, isa, lcp, threshold, "cpu")
    np.testing.assert_array_equal(via_gate.pos, want.pos)
    monkeypatch.setattr(native, "_lib", None)  # the Python scans
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setenv("TDC_DEVICE_LZSS", "0")
    if len(sa) < 600:
        slow = lcp_factorize(sa, isa, lcp, threshold)
        np.testing.assert_array_equal(slow.pos, want.pos)
        np.testing.assert_array_equal(slow.src, want.src)
        np.testing.assert_array_equal(slow.len, want.len)


def _data():
    rng = np.random.default_rng(21)
    return (
        b"abracadabra, abracadabra " * 150
        + bytes(rng.integers(0, 4, 3000).astype(np.uint8))  # holds \0: escaped
        + bytes(rng.zipf(1.3, 4000).clip(0, 255).astype(np.uint8))
        + b"\xff\xfe\0\0 tail"
    )


DATA = _data()
BS = 2048


def _ids():
    coders = TorchRegistry("cpu").names("coder")
    assert "huff" in coders and len(coders) >= 7
    ids = [f"lzss_lcp(coder={c})" for c in coders]
    ids += [
        "lzss_lcp(coder=huff,threshold=2)",
        f"blockwise(lzss_lcp(coder=huff),bs={BS})",
        f"blockwise(lzss_lcp(coder=huff),bs={BS},shared=1)",
        f"blockwise(lzss_lcp(coder=huff,threshold=5),bs={BS},shared=1)",
        f"blockwise(lzss_lcp(coder=bit),bs={BS},shared=1)",  # shared is read for huff only
        "lzss_lcp(coder=huff,textds=textds(isa=sparse_isa(t=4)))",
        "lzss_lcp(coder=bit,textds=textds(lcp=compressed_lcp,cm=compressed))",
        "lzss_lcp(coder=huff,textds=textds(cm=delayed))",
        "lzss_lcp(coder=huff,textds=textds(cm=coherent_delayed))",
    ]
    return ids


@pytest.mark.parametrize("algo", _ids())
def test_containers_match_jax_package(algo, monkeypatch):
    want = jax_compress(algo, DATA)
    assert jax_decompress(want) == DATA
    for sa in "01":
        for lz in "01":  # the device stack and the host stack: the same bytes
            monkeypatch.setenv("TDC_DEVICE_SA", sa)
            monkeypatch.setenv("TDC_DEVICE_LZSS", lz)
            assert compress(algo, DATA, device="cpu") == want, (sa, lz)
    assert decompress(want, device="cpu") == DATA
    monkeypatch.delenv("TDC_DEVICE_SA")
    monkeypatch.delenv("TDC_DEVICE_LZSS")
    assert compress(algo, DATA, device="cpu") == want  # unset: the host stack on the CPU


@pytest.mark.parametrize("data", [b"", b"x", b"\0", b"\0\0\0", b"z" * 1000, b"ab" * 3000], ids=repr)
@pytest.mark.parametrize("algo", ["lzss_lcp(coder=huff)", f"blockwise(lzss_lcp(coder=huff),bs={BS},shared=1)"])
def test_edge_inputs_match_jax_package(algo, data, monkeypatch):
    monkeypatch.setenv("TDC_DEVICE_SA", "1")
    monkeypatch.setenv("TDC_DEVICE_LZSS", "1")
    got = compress(algo, data, device="cpu")
    monkeypatch.delenv("TDC_DEVICE_SA")
    monkeypatch.delenv("TDC_DEVICE_LZSS")
    assert got == jax_compress(algo, data)
    assert decompress(got, device="cpu") == data
    assert jax_decompress(got) == data


def test_runtime_without_shared_equals_the_driver_per_block():
    got = blockwise_lzss_compress(DATA, BS, "cpu")
    assert got == compress(f"blockwise(lzss_lcp(coder=huff),bs={BS})", DATA, device="cpu", raw=True)
    shared = blockwise_lzss_compress(DATA, BS, "cpu", shared_table=True)
    assert shared == jax_compress(f"blockwise(lzss_lcp(coder=huff),bs={BS},shared=1)", DATA, raw=True)
    assert shared != got


@pytest.mark.parametrize(
    "algo", ["lzss_lcp(coder=huff)", "lzss_lcp(coder=bit)", "lzss_lcp(coder=delta)",
             f"blockwise(lzss_lcp(coder=huff),bs={BS},shared=1)"],
)
def test_without_the_cpp_helpers(algo, monkeypatch):
    """Where g++ is missing the suffix stack, the factorizer and the lzss
    stream decoder take their numpy and Python paths: the same bytes."""
    data = DATA[:2500] + DATA[-1500:]
    want = compress(algo, data, device="cpu")
    assert native.get_lib() is not None
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert compress(algo, data, device="cpu") == want
    assert decompress(want, device="cpu") == data


def test_truncated_stream_raises():
    c = compress("lzss_lcp(coder=huff)", DATA, device="cpu")
    with pytest.raises(ValueError, match="truncated|malformed"):
        decompress(c[: len(c) // 2], device="cpu")
