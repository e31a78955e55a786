"""The sle coder on the CPU, against the JAX package.

Every `lcpcomp(coder=sle, comp, dec)` id of the JAX package's
registry_config (6 strategies x 4 decoders), `encode(coder=sle)` at kmer
1-4 (3 is the default) and `lzss_lcp(coder=sle)`: the port's container must
equal the JAX package's byte for byte, and each package must decode the
other's container. Inputs: those of tests/test_torch_lcpcomp_ids.py, and
for `encode` also every byte value and a k-mer-rich text. Tolerance: exact
equality.
"""

import pytest

from .test_torch_lcpcomp_ids import INPUTS, LCPCOMP_IDS, both_ways

SLE_IDS = [i for i in LCPCOMP_IDS if "coder=sle" in i]
ENCODE_INPUTS = {**INPUTS, "all-bytes": bytes(range(256)) * 3, "kmers": b"abc" * 500 + b"xyz"}


def test_sle_ids_are_the_matrix():
    assert len(SLE_IDS) == 24


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("algo", SLE_IDS)
def test_lcpcomp_sle_id_matches_the_jax_package(algo, name):
    both_ways(algo, INPUTS[name])


@pytest.mark.parametrize("name", sorted(ENCODE_INPUTS))
@pytest.mark.parametrize("kmer", [1, 2, 3, 4])
def test_encode_sle_matches_the_jax_package(kmer, name):
    both_ways(f"encode(coder=sle(kmer={kmer}))", ENCODE_INPUTS[name])


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_lzss_lcp_sle_matches_the_jax_package(name):
    both_ways("lzss_lcp(coder=sle)", INPUTS[name])
