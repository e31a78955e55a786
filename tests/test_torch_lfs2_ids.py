"""The lfs2 and lfs2bst ids on the CPU, against the JAX package.

Both ids of the JAX package's compressor_matrix(), and lfs2 with its
`exact` and `min_lrf` options and coders other than the defaults, on
tests/test_matrix.py's seven texts, 12 KiB of English and 12 KiB of
A/C/G/T, with TDC_DEVICE_SA at 1 and at 0 (lfs2bst builds no suffix array:
its Ukkonen tree is host code either way): the port's container equals the
JAX package's and each package decodes the other's (tests/torch_ids.py).
Tolerance: exact equality.
"""

import pytest

from tudocomp_tpu.registry_config import compressor_matrix

from .torch_ids import INPUTS, check_id

MATRIX_IDS = [a for a in compressor_matrix() if a.startswith("lfs2")]
IDS = [*MATRIX_IDS, "lfs2(exact=1,min_lrf=3)", "lfs2(lfs2_lit_coder=bit,lfs2_len_coder=delta)"]


def test_the_family_is_2_matrix_ids():
    assert MATRIX_IDS == ["lfs2", "lfs2bst"]


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("algo", IDS)
def test_id_matches_the_jax_package(algo, name, gate, monkeypatch):
    check_id(algo, name, gate, monkeypatch)
