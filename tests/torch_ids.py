"""The check behind the port's per-id tests of the suffix-tree families
(tests/test_torch_lz78u_ids.py, test_torch_lfs_ids.py, test_torch_lfs2_ids.py).

For one id and one input: the JAX package's container (computed once) is
decoded by both packages; the port's container, with TDC_DEVICE_SA forced
to 1 (the suffix array by prefix doubling and the PLCP by kernel H's plain
version, on the CPU) or to 0 (the C++ SA-IS and PLCP), must equal it byte
for byte, so the JAX package's decode of it is that decode. The gate is
read by both packages, so it is set around the port's calls only.
Tolerance: exact equality.
"""

import functools

from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu_torch.driver import compress, decompress

from .torch_cases import matrix_tail_inputs

INPUTS = matrix_tail_inputs()


@functools.lru_cache(maxsize=None)
def _jax(algo: str, name: str):
    want = jax_compress(algo, INPUTS[name])
    return want, jax_decompress(want)


def check_id(algo: str, name: str, gate: str, monkeypatch) -> None:
    data = INPUTS[name]
    want, jax_back = _jax(algo, name)
    assert jax_back == data
    monkeypatch.setenv("TDC_DEVICE_SA", gate)
    got = compress(algo, data, device="cpu")
    back = decompress(want, device="cpu")
    monkeypatch.delenv("TDC_DEVICE_SA")
    assert back == data
    assert got == want
