"""The lfs_comp ids of the esa and st strategies on the CPU, against the
JAX package.

The 24 `lfs_comp(computing_strat=esa|st,` ids of the JAX package's
compressor_matrix() (every literal and length coder) and the st strategy
with min_lrf=3, on tests/test_matrix.py's seven texts, 12 KiB of English
and 12 KiB of A/C/G/T, with TDC_DEVICE_SA at 1 and at 0: the port's
container equals the JAX package's and each package decodes the other's
(tests/torch_ids.py). The bst and sim_st ids are in
tests/test_torch_lfs_tree_ids.py (one file runs on one test worker).
Tolerance: exact equality.
"""

import pytest

from tudocomp_tpu.registry_config import compressor_matrix

from .torch_ids import INPUTS, check_id

FAMILY = [a for a in compressor_matrix() if a.startswith("lfs_comp(")]
MATRIX_IDS = [a for a in FAMILY if a.startswith(("lfs_comp(computing_strat=esa,", "lfs_comp(computing_strat=st,"))]
IDS = [*MATRIX_IDS, "lfs_comp(computing_strat=st(min_lrf=3))"]


def test_the_family_is_48_matrix_ids():
    assert len(FAMILY) == 48
    for strat in ("esa", "st", "bst", "sim_st"):
        assert sum(a.startswith(f"lfs_comp(computing_strat={strat},") for a in FAMILY) == 12
    assert len(MATRIX_IDS) == 24


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("algo", IDS)
def test_id_matches_the_jax_package(algo, name, gate, monkeypatch):
    check_id(algo, name, gate, monkeypatch)
