"""The transform, bwt, lzss and repair ids on the CPU, against the JAX package.

The 16 ids of the JAX package's compressor_matrix() that this slice ports
(noop, rle, mtf, the three bwt ids, the chain
`chain(bwt, chain(rle, chain(mtf, encode(huff))))`, four lzss and five
repair ids) and BASELINE config 1's `rle:mtf:encode(vbyte)` and the
bzip-like `bwt:rle:mtf:encode(huff)`: the port's container must equal the
JAX package's byte for byte and each package must decode the other's, with
the port's gates TDC_DEVICE_RLE, TDC_DEVICE_MTF and TDC_DEVICE_SA forced to
1 (the device stages' plain versions on the CPU: the run split, kernel J's
plain version, the device SA and the BWT's gather) and to 0 (the host
paths). The gates are read by both packages, so they are set around the
port's calls only. Inputs: tests/torch_cases.py's MTF edge inputs and
seeded English. Tolerance: exact equality.
"""

import functools

import numpy as np
import pytest

from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.registry_config import compressor_matrix
from tudocomp_tpu_torch.driver import compress, decompress

from .torch_cases import english, mtf_edge_cases

PREFIXES = ("noop", "rle", "mtf", "bwt", "chain(", "lzss(", "repair(")
IDS = [a for a in compressor_matrix() if a.startswith(PREFIXES)]
ALGOS = [*IDS, "rle:mtf:encode(vbyte)", "bwt:rle:mtf:encode(huff)"]
GATES = ("TDC_DEVICE_RLE", "TDC_DEVICE_MTF", "TDC_DEVICE_SA")
INPUTS = {**mtf_edge_cases(), "english 12 KiB": english(12 << 10, seed=3)}


@functools.lru_cache(maxsize=None)
def _jax(algo: str, name: str):
    """The JAX package's container of INPUTS[name] and its own decode."""
    want = jax_compress(algo, INPUTS[name])
    return want, jax_decompress(want)


def test_the_slice_is_16_matrix_ids():
    assert len(IDS) == 16
    assert sum(a.startswith("bwt") for a in IDS) == 3
    assert sum(a.startswith("lzss(") for a in IDS) == 4 and sum(a.startswith("repair(") for a in IDS) == 5


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("algo", ALGOS)
def test_id_matches_the_jax_package(algo, name, gate, monkeypatch):
    data = INPUTS[name]
    want, jax_back = _jax(algo, name)
    assert jax_back == data
    for var in GATES:
        monkeypatch.setenv(var, gate)
    got = compress(algo, data, device="cpu")
    assert decompress(want, device="cpu") == data
    for var in GATES:
        monkeypatch.delenv(var)
    assert got == want  # so the JAX package's decode of it is jax_back


def test_rle_offset_option_matches():
    data = b"aaaabbbcc" * 300 + b"z" * 1000
    for algo in ("rle(offset=3)", "rle(offset=300)"):
        want = jax_compress(algo, data)
        assert compress(algo, data, device="cpu") == want
        assert decompress(want, device="cpu") == data


def test_repair_max_rules_option_matches():
    data = english(4000, seed=4)
    for algo in ("repair(coder=bit,max_rules=10)", "repair(coder=huff,max_rules=1)"):
        want = jax_compress(algo, data)
        assert compress(algo, data, device="cpu") == want
        assert decompress(want, device="cpu") == data


@pytest.mark.parametrize("algo", ["rle", "mtf", "bwt", "lzss(coder=bit)", "repair(coder=gamma)"])
def test_host_paths_without_the_cpp_helpers(algo, monkeypatch):
    """Where g++ is missing, the transforms' and the host-only compressors'
    Python paths write the same bytes and decode them."""
    from tudocomp_tpu_torch import native

    data = english(3000, seed=6) + b"q" * 300 + bytes(range(256))
    want = compress(algo, data, device="cpu")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert compress(algo, data, device="cpu") == want
    assert decompress(want, device="cpu") == data


def test_bwt_gather_on_the_device_sa(monkeypatch):
    """TextDS.bwt gathers on the device where the device built the SA, and
    gives the host's BWT."""
    from tudocomp_tpu_torch.ds.textds import TextDS, bwt_from_sa

    text = np.frombuffer(english(5000, seed=8) + b"\0", np.uint8)
    monkeypatch.setenv("TDC_DEVICE_SA", "0")
    host = TextDS(text, device="cpu")
    want = host.bwt()
    assert host._sa_d is None
    np.testing.assert_array_equal(want, bwt_from_sa(text, host.require_sa()))
    monkeypatch.setenv("TDC_DEVICE_SA", "1")
    ds = TextDS(text, device="cpu")
    got = ds.bwt()
    assert ds._sa_d is not None
    np.testing.assert_array_equal(got, want)
