"""lcpcomp's device stages on the CPU, against the JAX package.

ops/lcpcomp_torch.py's plcppeaks_factorize_device and
resolve_factors_device run here on CPU tensors, held to
tudocomp_tpu/ops/lcpcomp_jax.py's functions (plain JAX, run on the CPU) and
to the host strategy: on the texts of tests/test_lcpcomp_device.py at
thresholds 1 and 5, on its chain case and on seeded random factor sets with
forward and backward chains. Also: a stream whose chain reaches no literal
raises in both packages, whatever the decoder (AssertionError in the JAX
package, ValueError in the port, which checks without assert); the TDC_DEVICE_LCPCOMP gates;
the forced device stages through the driver; and the count of the JAX
package's matrix ids that the port selects. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from tests.util import CORPUS
from tudocomp_tpu.driver import compress as jax_compress, decompress as jax_decompress
from tudocomp_tpu.ops import lcpcomp_jax
from tudocomp_tpu.registry_config import compressor_matrix
from tudocomp_tpu_torch import device as tdev
from tudocomp_tpu_torch.compressors.lcpcomp import plcppeaks_factorize
from tudocomp_tpu_torch.driver import compress, decompress
from tudocomp_tpu_torch.ds.textds import TextDS
from tudocomp_tpu_torch.ops import lcpcomp_torch as lt
from tudocomp_tpu_torch.registry import TorchRegistry

from .torch_cases import english

CPU = torch.device("cpu")


def _texts():
    """tests/test_lcpcomp_device.py's texts (those without a 0 byte)."""
    texts = [t for t in CORPUS if 0 < len(t) < 4000][:12]
    texts += [b"abcabcabcabcabc" * 20, bytes(np.random.default_rng(0).integers(0, 4, 3000).astype(np.uint8))]
    return [t for t in texts if b"\0" not in t]


TEXTS = _texts()


def _arrays(text: bytes):
    ds = TextDS(np.frombuffer(text + b"\0", np.uint8))
    return ds.require_sa(), ds.require_isa(), ds.require_plcp()


@pytest.mark.parametrize("i", range(len(TEXTS)))
@pytest.mark.parametrize("threshold", [1, 5])
def test_plcppeaks_device_matches_jax_and_host(threshold, i):
    sa, isa, plcp = _arrays(TEXTS[i])
    got = lt.plcppeaks_factorize_device(*(torch.from_numpy(a) for a in (sa, isa, plcp)), threshold)
    want = lcpcomp_jax.plcppeaks_factorize_device(sa, isa, plcp, threshold)
    host = plcppeaks_factorize(sa, isa, plcp, threshold)
    for g, w, h in zip(got, want, (host.pos, host.src, host.len)):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.asarray(h, np.int64))


def test_plcppeaks_candidates_peak_test():
    plcp = torch.tensor([3, 1, 4, 4, 2, 7, 1, 6], dtype=torch.int32)
    cond, step = lt.plcppeaks_candidates(plcp, 2)
    # 0: 3 > 1; 2-3: a plateau is no peak; 5: 7 > 2 and 7 > 1; 7: the last position
    assert cond.tolist() == [True, False, False, False, False, True, False, False]
    assert step.tolist() == [3, 1, 1, 1, 1, 7, 1, 1]


def _chain_case():
    """tests/test_lcpcomp_device.py's chain case: a factor fed by its own
    output, a forward reference into a later factor, overlapping copies."""
    n = 32
    buf = np.zeros(n, np.uint8)
    buf[0], buf[1] = ord("a"), ord("b")
    buf[20:31] = np.frombuffer(b"xyzxyzxyzxy", np.uint8)
    return buf, np.array([2, 6, 12], np.uint32), np.array([0, 8, 0], np.uint32), np.array([4, 6, 8], np.uint32)


def test_resolve_chain_case():
    buf, tgt, src, lens = _chain_case()
    got = lt.resolve_factors_device(buf.copy(), tgt, src, lens, CPU)
    want = lcpcomp_jax.resolve_factors_device(buf.copy(), tgt, src, lens)
    np.testing.assert_array_equal(got, want)
    assert got[:31].all()


def _random_factors(seed: int, n: int = 3000):
    """A random text over 3 letters and disjoint factors whose sources hold
    the same bytes, forward or backward, keeping only factors whose chains
    reach a literal. Returns (text, buffer, tgt, src, lens)."""
    rng = np.random.default_rng(seed)
    text = rng.integers(1, 4, n).astype(np.uint8)
    factors, t = [], 0
    while t < n - 8:
        t += int(rng.integers(0, 6))
        ln = int(rng.integers(2, 7))
        if t + ln > n:
            break
        same = (np.lib.stride_tricks.sliding_window_view(text, ln) == text[t : t + ln]).all(1)
        cands = np.flatnonzero(same)
        cands = cands[cands != t]
        if len(cands):
            factors.append((t, int(rng.choice(cands)), ln))
        t += ln
    while True:  # drop factors whose chains reach no literal; their targets become literals
        covered = np.zeros(n, bool)
        for t, _, ln in factors:
            covered[t : t + ln] = True
        m = np.arange(n)
        for t, s, ln in factors:
            m[t : t + ln] = np.arange(s, s + ln)
        for _ in range(n.bit_length()):  # pointer doubling: m = f^(2^k)
            m = m[m]
        bad = [f for f in factors if covered[m[f[0] : f[0] + f[2]]].any()]
        if not bad:
            break
        factors = [f for f in factors if f not in bad]
    buf = np.where(covered, 0, text).astype(np.uint8)
    tgt, src, lens = (np.array(c, np.uint32) for c in zip(*factors))
    return text, buf, tgt, src, lens


@pytest.mark.parametrize("seed", range(4))
def test_resolve_random_factor_sets(seed):
    text, buf, tgt, src, lens = _random_factors(seed)
    assert (src > tgt).any() and (src < tgt).any()  # forward and backward references
    covered = np.zeros(len(text), bool)
    for t, ln in zip(tgt, lens):
        covered[t : t + ln] = True
    assert any(covered[s : s + ln].any() for s, ln in zip(src, lens))  # chains of two factors or more
    got = lt.resolve_factors_device(buf.copy(), tgt, src, lens, CPU)
    np.testing.assert_array_equal(got, lcpcomp_jax.resolve_factors_device(buf.copy(), tgt, src, lens))
    np.testing.assert_array_equal(got, text)


def test_resolve_rejects_a_source_past_the_text():
    buf, tgt, src, lens = _chain_case()
    with pytest.raises(ValueError, match="past the text"):
        lt.resolve_factors_device(buf, tgt, np.array([0, 8, 30], np.uint32), lens, CPU)


# lcpcomp(coder=ascii,threshold=3) on a 12-byte text: factors [0, 3) <- [3, 6)
# and [3, 6) <- [0, 3), a chain that reaches no literal, then 6 literals
CYCLE = b"12:3:3:9:" + b"03:3:" + b"00:3:" + b"16:xyzxy\x00"


@pytest.mark.parametrize("on_device", ["0", "1"])
@pytest.mark.parametrize("dec", ["scan", "compact", "QueueListBuffer", "MultimapListBuffer"])
def test_undecodable_stream_raises_in_both_packages(dec, on_device, monkeypatch):
    algo = f"lcpcomp(coder=ascii,threshold=3,dec={dec})"
    with pytest.raises(AssertionError, match="undecodable"):
        jax_decompress(CYCLE, id_string=algo, raw=True)
    monkeypatch.setenv("TDC_DEVICE_LCPCOMP", on_device)
    with pytest.raises(ValueError, match="undecodable"):
        decompress(CYCLE, device="cpu", id_string=algo, raw=True)


def test_gates(monkeypatch):
    cuda, big = torch.device("cuda", 0), 1 << 30
    gates = (tdev.use_lcpcomp_device, tdev.use_lcpcomp_decode_device)
    monkeypatch.delenv("TDC_DEVICE_LCPCOMP", raising=False)
    assert not any(g(big, CPU) for g in gates)
    assert all(g(big, cuda) for g in gates)
    assert not tdev.use_lcpcomp_device(tdev.LCPCOMP_MIN_N - 1, cuda)
    assert not tdev.use_lcpcomp_decode_device(tdev.LCPCOMP_DEC_MIN_N - 1, cuda)
    monkeypatch.setenv("TDC_DEVICE_LCPCOMP", "1")
    assert all(g(1, CPU) for g in gates)
    monkeypatch.setenv("TDC_DEVICE_LCPCOMP", "0")
    assert not any(g(big, cuda) for g in gates)


@pytest.mark.parametrize("sa_on_device", ["0", "1"])
@pytest.mark.parametrize(
    "algo", ["lcpcomp(coder=huff,comp=plcppeaks)", "lcpcomp(coder=ascii,comp=plcppeaks,threshold=2,dec=compact)"]
)
def test_forced_device_stages_through_the_driver(algo, sa_on_device, monkeypatch):
    """TDC_DEVICE_LCPCOMP=1 on the CPU: the plcppeaks factorization (from
    TextDS's device arrays where the device SA ran, else from its host
    arrays) and the chain-resolving decode write the JAX package's bytes."""
    data = english(1 << 15) + b"tobeornottobe " * 300
    want = jax_compress(algo, data)
    monkeypatch.setenv("TDC_DEVICE_SA", sa_on_device)
    monkeypatch.setenv("TDC_DEVICE_LCPCOMP", "1")
    got = compress(algo, data, device="cpu")
    assert got == want
    assert decompress(want, device="cpu") == data


def test_device_arrays_of_textds(monkeypatch):
    text = np.frombuffer(english(5000) + b"\0", np.uint8)
    monkeypatch.setenv("TDC_DEVICE_SA", "1")
    ds = TextDS(text, device=CPU)
    sa, isa, plcp = ds.device_arrays()
    assert all(t.dtype == torch.int32 for t in (sa, isa, plcp))
    host = TextDS(text)
    monkeypatch.setenv("TDC_DEVICE_SA", "0")
    assert host.device_arrays() is None
    for t, want in zip((sa, isa, plcp), (host.require_sa(), host.require_isa(), host.require_plcp())):
        np.testing.assert_array_equal(t.numpy(), want)
    monkeypatch.setenv("TDC_DEVICE_SA", "1")
    assert TextDS(text, device=CPU, isa_provider="sparse_isa").device_arrays() is None


def test_the_port_selects_293_of_the_matrix():
    reg = TorchRegistry("cpu")
    ids = compressor_matrix()
    selected = []
    for algo in ids:
        try:
            reg.parse_algorithm_id(algo)
        except Exception:
            continue
        selected.append(algo)
    assert len(ids) == 293
    assert len(selected) == 293
    assert sum(a.startswith("lcpcomp(") for a in selected) == 74
    assert "encode(coder=sle)" in selected
