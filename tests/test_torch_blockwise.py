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
from tudocomp_tpu.parallel.blocks import frame_streams, split_blocks
from tudocomp_tpu.registry import Registry
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.registry import TorchRegistry


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


def test_blockwise_inner_cites_its_queue_item():
    """A blockwise inner is not ported: the error names its ROADMAP item."""
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 4d\)"):
        compress("blockwise(blockwise(encode(huff)))", _data(), device="cpu")
