"""The port's suffix stack on the CPU against the JAX package and the C++ host code.

suffix_array_device (SA and ISA), plcp_device and lcp_device of the port run
on CPU tensors and must equal the JAX functions of the same names on the
same arrays, the SA-IS, PLCP and LCP of the port's C++ host helpers, and the
numpy fallbacks beside them. Texts: the corner cases and randoms of
tests/test_textds.py, repetitive texts and a^n. Everything is integer:
tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tudocomp_tpu.ds.suffix_array import suffix_array_device as jax_sa_device
from tudocomp_tpu.ops import plcp_jax
from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.ds import flags
from tudocomp_tpu_torch.ds import suffix_array as sa_mod
from tudocomp_tpu_torch.ds.textds import TextDS
from tudocomp_tpu_torch.ops import plcp_torch


def _texts():
    """name -> text ending in its unique 0 sentinel."""
    rng = np.random.default_rng(3)
    raw = {
        "one": b"",
        "two": b"a",
        "banana": b"banana",
        "mississippi": b"mississippi",
        "abracadabra": b"abracadabra" * 7,
        "a^n": b"a" * 700,
        "ab^n": b"ab" * 300,
        "abcabd^n": b"abcabd" * 1500,
        "bytes": bytes(range(1, 256)) * 3,
        "random4": bytes(rng.integers(97, 101, 20000).astype(np.uint8)),
        "random2": bytes(rng.integers(1, 3, 3000).astype(np.uint8)),
        "random255": bytes(rng.integers(1, 256, 5000).astype(np.uint8)),
        "tiled": bytes(np.tile(rng.integers(1, 5, 500).astype(np.uint8), 12)),
    }
    return {k: np.frombuffer(v + b"\0", np.uint8).copy() for k, v in raw.items()}


TEXTS = _texts()


def _host(text):
    """(sa, isa, plcp, lcp) from the port's C++ helpers."""
    lib = native.get_lib()
    assert lib is not None
    n = len(text)
    sa = np.empty(n, np.int32)
    assert lib.tdc_sais(text, n, sa) == 0
    isa = sa_mod.inverse_permutation(sa)
    plcp = np.empty(n, np.int32)
    lib.tdc_plcp_from_phi(text, n, sa_mod.phi_from_sa(sa), plcp)
    return sa, isa, plcp, sa_mod.lcp_from_plcp(plcp, sa)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_suffix_array_device_matches(name):
    text = TEXTS[name]
    sa, isa = sa_mod.suffix_array_device(torch.from_numpy(text), return_isa=True)
    assert sa.dtype == torch.int32 and isa.dtype == torch.int32
    want_sa, want_isa, _, _ = _host(text)
    np.testing.assert_array_equal(sa.numpy(), want_sa)
    np.testing.assert_array_equal(isa.numpy(), want_isa)
    np.testing.assert_array_equal(sa_mod.suffix_array_device(torch.from_numpy(text)).numpy(), want_sa)
    jsa, jisa = jax_sa_device(jnp.asarray(text), return_isa=True)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(isa.numpy(), np.asarray(jisa))


@pytest.mark.parametrize("text", [b"", b"x", b"aa", b"ba", b"aaaaaaaa", b"\0\0\0", b"abab\0abab"])
def test_suffix_array_device_without_a_sentinel(text):
    """Any text has one SA (a shorter suffix sorts first): no sentinel needed."""
    arr = np.frombuffer(text, np.uint8).copy()
    sa, isa = sa_mod.suffix_array_device(torch.from_numpy(arr), return_isa=True)
    want = sorted(range(len(text)), key=lambda i: text[i:])
    assert sa.tolist() == want
    assert isa[sa.to(torch.int64)].tolist() == list(range(len(text)))
    assert sa_mod.suffix_array_numpy(arr).tolist() == want


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_host_fallbacks_match_cpp(name, monkeypatch):
    text = TEXTS[name]
    sa, isa, plcp, lcp = _host(text)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    np.testing.assert_array_equal(sa_mod.suffix_array_numpy(text), sa)
    np.testing.assert_array_equal(sa_mod.inverse_permutation(sa), isa)
    phi = sa_mod.phi_from_sa(sa)
    np.testing.assert_array_equal(phi[sa[1:]], sa[:-1])
    np.testing.assert_array_equal(sa_mod.plcp_from_phi_numpy(text, phi), plcp)
    np.testing.assert_array_equal(sa_mod.lcp_from_plcp(plcp, sa), lcp)


@pytest.mark.parametrize("seg", [64, 4096])
@pytest.mark.parametrize("name", ["one", "two", "banana", "abracadabra", "a^n", "bytes", "random2", "tiled"])
def test_plcp_device_matches(name, seg):
    text = TEXTS[name]
    sa, _, plcp, lcp = _host(text)
    t, s = torch.from_numpy(text), torch.from_numpy(sa)
    got = plcp_torch.plcp_device_plain(t, s, seg=seg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), plcp)
    np.testing.assert_array_equal(plcp_torch.plcp_device(t, s).numpy(), plcp)
    np.testing.assert_array_equal(plcp_torch.lcp_device(t, s).numpy(), lcp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(plcp_jax.plcp_device(jnp.asarray(text), jnp.asarray(sa), seg=seg)))
    np.testing.assert_array_equal(lcp, np.asarray(plcp_jax.lcp_device(jnp.asarray(text), jnp.asarray(sa), seg=seg)))


@pytest.mark.parametrize("device_sa", ["0", "1"])
def test_textds_device_hook(device_sa, monkeypatch):
    """TextDS gives the same arrays whether its SA comes from the device
    function (whose ranks then serve as the ISA, and whose device copy then
    feeds the device PLCP and LCP) or from the host."""
    text = TEXTS["random4"]
    sa, isa, plcp, lcp = _host(text)
    monkeypatch.setenv("TDC_DEVICE_SA", device_sa)
    ds = TextDS(text, device="cpu")
    ds.require(flags.SA | flags.ISA | flags.LCP)
    assert (ds._isa_device is None) and (ds._isa is not None)
    # on the device only the LCP comes back until the PLCP is asked for
    assert (ds._plcp is None) == (device_sa == "1") == (ds._plcp_d is not None)
    ds.require(flags.PLCP)
    np.testing.assert_array_equal(ds.sa(), sa)
    np.testing.assert_array_equal(ds.isa(), isa)
    np.testing.assert_array_equal(ds.plcp(), plcp)
    np.testing.assert_array_equal(ds.lcp(), lcp)
    assert ds.sa().dtype == np.int32 and ds.isa().dtype == np.int32
