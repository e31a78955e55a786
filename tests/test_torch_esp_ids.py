"""The ESP ids and encode(arithmetic) on the CPU, against the JAX package.

Every `esp(slp_coder=..., ipd=...)` id of the JAX package's
registry_config (13 slp coders x 3 ipds) and `encode(coder=arithmetic)`:
the port's container must equal the JAX package's byte for byte, and each
package must decode the other's container. Inputs: empty, one byte, zero
bytes, mississippi, 64 KiB of English-like text and long runs; the
arithmetic coder also on inputs with byte 255 and with all 256 byte values
(the two quirks its module docstring names). Tolerance: exact equality.
The port's gate keeps these inputs (all below device.ESP_MIN_N) on the host
rounds; tests/test_torch_esp.py holds the device rounds to the host ones.
"""

import numpy as np
import pytest

from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.registry_config import ESP_IPD, ESP_SLP_CODERS
from tudocomp_tpu_torch.device import ESP_MIN_N
from tudocomp_tpu_torch.driver import compress, decompress

from .torch_cases import english

ESP_IDS = [f"esp(slp_coder={slp}, ipd={ipd})" for slp in ESP_SLP_CODERS for ipd in ESP_IPD]

INPUTS = {
    "empty": b"",
    "one-byte": b"x",
    "zeros": b"\0" * 1000,
    "mississippi": b"mississippi",
    "text-64KiB": english(1 << 16),
    "runs": b"".join(bytes([c]) * n for c, n in zip(b"abcab", (3000, 1, 777, 2, 4096))),
}
ARITH_INPUTS = {
    **INPUTS,
    "byte-255": bytes([255, 1, 255, 255, 7]) * 300,
    "all-bytes": bytes(range(256)) * 3 + bytes(range(0, 256, 3)),
}


def _both_ways(algo: str, data: bytes) -> None:
    want = jax_compress(algo, data)
    got = compress(algo, data, device="cpu")
    assert got == want
    assert decompress(want, device="cpu") == data
    assert jax_decompress(got) == data


def test_esp_ids_are_the_matrix():
    assert len(ESP_IDS) == 39
    assert max(len(d) for d in INPUTS.values()) < ESP_MIN_N


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("algo", ESP_IDS)
def test_esp_id_matches_the_jax_package(algo, name):
    _both_ways(algo, INPUTS[name])


@pytest.mark.parametrize("name", sorted(ARITH_INPUTS))
def test_arithmetic_coder_matches_the_jax_package(name):
    _both_ways("encode(coder=arithmetic)", ARITH_INPUTS[name])
