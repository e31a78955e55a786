"""Matrix twin: every id of the JAX package's compressor_matrix() roundtrips
through the port on the CPU.

The port's counterpart of tests/test_matrix.py (mirror of the reference's
test/matrix_tests.cpp) on its seven texts: each of the 293 ids selects in
TorchRegistry, and driver.compress / decompress(device="cpu") give each
text back, once with every device gate at 0 (the host paths) and once at 1
(the device stages, through the kernels' plain versions on the CPU). The
byte equality with the JAX package's containers is held by
the per-family id tests (tests/test_torch_*_ids.py). Tolerance: exact
equality.
"""

import pytest

from tudocomp_tpu import registry_config as jax_registry_config
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.registry_config import compressor_matrix

from .torch_cases import MATRIX_TEXTS

MATRIX = compressor_matrix()
GATES = ("TDC_DEVICE_HUFF", "TDC_DEVICE_LZ78", "TDC_DEVICE_SA", "TDC_DEVICE_LZSS", "TDC_DEVICE_ESP",
         "TDC_DEVICE_LCPCOMP", "TDC_DEVICE_RLE", "TDC_DEVICE_MTF")


def test_the_matrix_is_293_ids():
    assert len(MATRIX) == len(set(MATRIX)) == 293


@pytest.mark.parametrize("fast", [False, True])
def test_the_matrix_is_the_jax_packages(fast):
    """The port's copy of the matrix declaration lists the JAX package's ids."""
    assert compressor_matrix(fast=fast) == jax_registry_config.compressor_matrix(fast=fast)


@pytest.mark.parametrize("gate", ["0", "1"])
@pytest.mark.parametrize("config", MATRIX)
def test_matrix_roundtrip(config, gate, monkeypatch):
    for var in GATES:
        monkeypatch.setenv(var, gate)
    for text in MATRIX_TEXTS:
        comp = compress(config, text, device="cpu")
        got = decompress(comp, device="cpu")
        assert got == text, (config, text[:40], got[:40])
