"""The lfs_comp ids of the bst and sim_st strategies on the CPU, against
the JAX package.

The 24 `lfs_comp(computing_strat=bst|sim_st,` ids of the JAX package's
compressor_matrix() (every literal and length coder) and sim_st with
min_lrf=4, on tests/test_matrix.py's seven texts, 12 KiB of English and 12
KiB of A/C/G/T, with TDC_DEVICE_SA at 1 and at 0: the port's container
equals the JAX package's and each package decodes the other's
(tests/torch_ids.py). Tolerance: exact equality.
"""

import pytest

from tudocomp_tpu.registry_config import compressor_matrix

from .torch_ids import INPUTS, check_id

MATRIX_IDS = [
    a for a in compressor_matrix()
    if a.startswith(("lfs_comp(computing_strat=bst,", "lfs_comp(computing_strat=sim_st,"))
]
IDS = [*MATRIX_IDS, "lfs_comp(computing_strat=sim_st(min_lrf=4))"]


def test_the_strategies_are_24_matrix_ids():
    assert len(MATRIX_IDS) == 24


@pytest.mark.parametrize("gate", ["1", "0"])
@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("algo", IDS)
def test_id_matches_the_jax_package(algo, name, gate, monkeypatch):
    check_id(algo, name, gate, monkeypatch)
