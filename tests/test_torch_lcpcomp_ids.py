"""The lcpcomp ids with the ascii and huff coders on the CPU, against the JAX package.

Every `lcpcomp(coder, comp, dec)` id of the JAX package's registry_config
with coder ascii or huff (2 coders x 6 strategies x 4 decoders) and the two
`textds` ids: the port's container must equal the JAX package's byte for
byte, and each package must decode the other's container. The sle ids are
in tests/test_torch_lcpcomp_sle.py. Inputs: empty, one byte, zero bytes,
mississippi, 16 KiB of English-like text, a seeded 4-letter DNA text, long
runs and `abcdeabcde` (a forward-reference factor). `lcpcomp(coder=ascii)`
is also held to tests/test_golden_formats.py's vectors. Tolerance: exact
equality. The port's gates keep these inputs on the host; the device stages
are in tests/test_torch_lcpcomp.py.
"""

import numpy as np
import pytest

from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.registry_config import compressor_matrix
from tudocomp_tpu_torch.device import LCPCOMP_DEC_MIN_N, LCPCOMP_MIN_N
from tudocomp_tpu_torch.driver import compress, decompress

from .torch_cases import english

LCPCOMP_IDS = [i for i in compressor_matrix() if i.startswith("lcpcomp(")]
IDS = [i for i in LCPCOMP_IDS if "coder=sle" not in i]

INPUTS = {
    "empty": b"",
    "one-byte": b"x",
    "zeros": b"\0" * 1000,
    "mississippi": b"mississippi",
    "text-16KiB": english(1 << 14),
    "dna": np.frombuffer(b"ACGT", np.uint8)[np.random.default_rng(7).integers(0, 4, 20000)].tobytes(),
    "runs": b"".join(bytes([c]) * n for c, n in zip(b"abcab", (3000, 1, 777, 2, 4096))),
    "forward-reference": b"abcdeabcde",
}


def both_ways(algo: str, data: bytes) -> None:
    want = jax_compress(algo, data)
    got = compress(algo, data, device="cpu")
    assert got == want
    assert decompress(want, device="cpu") == data
    assert jax_decompress(got) == data


def test_lcpcomp_ids_are_the_matrix():
    assert len(LCPCOMP_IDS) == 74  # 3 coders x 6 strategies x 4 decoders, and two textds ids
    assert len(IDS) == 50
    assert max(len(d) for d in INPUTS.values()) < min(LCPCOMP_MIN_N, LCPCOMP_DEC_MIN_N)


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("algo", IDS)
def test_lcpcomp_id_matches_the_jax_package(algo, name):
    both_ways(algo, INPUTS[name])


@pytest.mark.parametrize(
    "data, want",
    [
        (b"abc", b"4:4294967295:0:4:14:abc\x00\x00"),  # no factor
        (b"abcdeabcde", b"11:5:5:6:05:5:16:abcde\x00\x00"),  # one forward reference
    ],
)
def test_golden_lcpcomp_ascii(data, want):
    """tests/test_golden_formats.py's lcpcomp(coder=ascii) vectors."""
    algo = "lcpcomp(coder=ascii)"
    got = compress(algo, data, device="cpu", raw=True)
    assert got == want
    assert decompress(got, device="cpu", id_string=algo, raw=True) == data
