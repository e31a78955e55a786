"""The lz78u ids on the CPU, against the JAX package.

The 16 `lz78u(` ids of the JAX package's compressor_matrix() (the
streaming strategy, every string coder against every ref coder) and two
buffering ids, on tests/test_matrix.py's seven texts, 12 KiB of English and
12 KiB of A/C/G/T, with TDC_DEVICE_SA at 1 and at 0: the port's container
equals the JAX package's and each package decodes the other's
(tests/torch_ids.py). Tolerance: exact equality.
"""

import pytest

from tudocomp_tpu.registry_config import compressor_matrix

from .torch_ids import INPUTS, check_id

MATRIX_IDS = [a for a in compressor_matrix() if a.startswith("lz78u(")]
IDS = [
    *MATRIX_IDS,
    "lz78u(comp=buffering(string_coder=huff), coder=bit)",
    "lz78u(comp=buffering(string_coder=ascii), coder=gamma, threshold=5)",
]


def test_the_family_is_16_matrix_ids():
    assert len(MATRIX_IDS) == 16
    assert all("streaming" in a for a in MATRIX_IDS)


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("algo", IDS)
def test_id_matches_the_jax_package(algo, name, gate, monkeypatch):
    check_id(algo, name, gate, monkeypatch)
