"""The port's blockwise routing for inner compressors other than encode(huff).

Against tudocomp_tpu/compressors/blockwise.py: blocks that no device path
takes go through the driver with raw=True, which wraps each block with the
inner's input restrictions (escaping, sentinel) on both sides; `shared`
is read only for encode(huff). Tolerance: exact equality of container
bytes.
"""

import numpy as np
import pytest

from tudocomp_tpu.base import Compressor
from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.meta import Meta
from tudocomp_tpu.parallel.blocks import frame_streams, split_blocks, unframe_streams
from tudocomp_tpu.registry import Registry
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.registry import TorchRegistry

from .torch_cases import english


class _SentinelCopy(Compressor):
    """Writes its input as it sees it: escaped and 0-terminated."""

    @classmethod
    def meta(cls) -> Meta:
        m = Meta("compressor", "sentinel_copy", "copy of the restricted input")
        m.needs_sentinel_terminator()
        return m

    def compress(self, inp, out):
        out.write(inp.as_array())

    def decompress(self, inp, out):
        out.write(inp.as_array())


def _data():
    rng = np.random.default_rng(31)
    return bytes(rng.integers(0, 4, 2500).astype(np.uint8))  # many 0 bytes to escape


@pytest.mark.parametrize("bs", [1000, 4096])
def test_host_blocks_apply_inner_restrictions(bs):
    data = _data()
    ref_reg = Registry()
    ref_reg.register(_SentinelCopy)
    blocks, n_valid = split_blocks(data, bs)
    want = frame_streams(
        [jax_compress("sentinel_copy", bytes(b[:nv]), registry=ref_reg, raw=True) for b, nv in zip(blocks, n_valid)],
        bs,
    )
    assert want != frame_streams([bytes(b[:nv]) for b, nv in zip(blocks, n_valid)], bs)
    reg = TorchRegistry("cpu")
    reg.register(_SentinelCopy)
    algo = f"blockwise(sentinel_copy,bs={bs})"
    got = compress(algo, data, raw=True, registry=reg)
    assert got == want
    assert decompress(got, id_string=algo, raw=True, registry=reg) == data


@pytest.mark.parametrize(
    "algo", ["blockwise(lz78(coder=bit),shared=1)", "blockwise(lzw(coder=bit),bs=1000,shared=1)"]
)
def test_shared_is_ignored_for_other_inners(algo):
    data = _data() + b"shared tables are a Huffman option" * 40
    want = jax_compress(algo, data)
    got = compress(algo, data, device="cpu")
    assert got == want
    assert decompress(got, device="cpu") == data
    assert jax_decompress(got) == data


@pytest.mark.parametrize("procs", ["0", "4"])
@pytest.mark.parametrize("algo", ["blockwise(encode(bit),bs=1000)", "blockwise(encode(huff),bs=1000)"])
def test_host_route_matches(algo, procs, monkeypatch):
    """Inners without a batch hook (encode(bit); encode(huff) with
    TDC_DEVICE_HUFF=0). TDC_BLOCKWISE_PROCS, which sizes the JAX package's
    block pools, leaves the port's bytes alone."""
    data = _data()
    want = jax_compress(algo, data)
    monkeypatch.setenv("TDC_DEVICE_HUFF", "0")
    monkeypatch.setenv("TDC_BLOCKWISE_PROCS", procs)
    assert compress(algo, data, device="cpu") == want
    assert decompress(want, device="cpu") == data


# Nested blockwise: each outer block goes through the driver and takes the
# inner blockwise's routing, the device runtime for encode(huff) (kernels
# A-C and D's plain versions here, under TDC_DEVICE_HUFF=1, and always with
# shared=1) or the host coder (=0), the batch parse for lzw (kernel F's plain
# version under TDC_DEVICE_LZ78=1) or the host parse (=0). The bs=3000 and
# bs=10000 ids leave the inner's last block short in every outer block.
NESTED = {
    "blockwise(blockwise(encode(huff),bs=4096),bs=16384)": "TDC_DEVICE_HUFF",
    "blockwise(blockwise(encode(huff),bs=3000),bs=10000)": "TDC_DEVICE_HUFF",
    "blockwise(blockwise(encode(huff),bs=3000,shared=1),bs=10000)": "TDC_DEVICE_HUFF",
    "blockwise(blockwise(lzw,bs=1024),bs=8192)": "TDC_DEVICE_LZ78",
    "blockwise(blockwise(lzw(coder=gamma),bs=3000),bs=10000)": "TDC_DEVICE_LZ78",
}
_NESTED_DATA = english(40 << 10, seed=12)
_nested_jax = {}


def _nested_want(algo):
    """The JAX package's container of _NESTED_DATA and its own decode."""
    if algo not in _nested_jax:
        want = jax_compress(algo, _NESTED_DATA)
        _nested_jax[algo] = want, jax_decompress(want)
    return _nested_jax[algo]


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("algo", sorted(NESTED))
def test_nested_blockwise_matches(algo, gate, monkeypatch):
    want, jax_back = _nested_want(algo)
    assert jax_back == _NESTED_DATA
    monkeypatch.setenv(NESTED[algo], gate)
    assert compress(algo, _NESTED_DATA, device="cpu") == want
    assert decompress(want, device="cpu") == _NESTED_DATA


def test_nested_blockwise_frames_the_flat_payloads():
    """With the outer block a multiple of the inner one, the inner
    containers hold the flat blockwise's payloads, in order."""
    flat = compress("blockwise(encode(huff),bs=4096)", _NESTED_DATA, device="cpu", raw=True)
    nested = compress("blockwise(blockwise(encode(huff),bs=4096),bs=16384)", _NESTED_DATA, device="cpu", raw=True)
    outer_bs, outer = unframe_streams(nested)
    assert outer_bs == 16384 and len(outer) == 3
    inner = [p for o in outer for p in unframe_streams(o)[1]]
    assert unframe_streams(flat) == (4096, inner)


def test_nested_blockwise_raises_on_a_bad_inner():
    """A failure inside an outer block is not swallowed."""
    with pytest.raises(KeyError):
        compress("blockwise(blockwise(nonexistent,bs=1024),bs=4096)", _NESTED_DATA, device="cpu")
