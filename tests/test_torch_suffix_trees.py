"""The port's suffix trees and the lfs rule computations on the CPU.

Twins of tests/test_lz78u_lfs.py's structural tests (the array suffix tree
against brute force, the binary (Ukkonen) tree's structure, NaivST's leaf
set, rules without overlap), each run on the port's module and held to the
JAX package's module on the same seeded input: the same node arrays, the
same rules. The array tree is also built from the int32 SA and LCP that
TextDS hands over when the device path built them (TDC_DEVICE_SA=1: prefix
doubling and kernel H's plain version on the CPU) and from SA-IS's.
Tolerance: exact equality.
"""

import numpy as np
import pytest

from tudocomp_tpu.compressors import lfs as jax_lfs
from tudocomp_tpu.compressors import lfs2 as jax_lfs2
from tudocomp_tpu.ds.binary_suffix_tree import BinarySuffixTree as JaxBST
from tudocomp_tpu.ds.naiv_st import NaivST as JaxNaivST
from tudocomp_tpu.ds.suffix_array import naive_lcp, naive_suffix_array
from tudocomp_tpu.ds.suffix_tree import SuffixTree as JaxSuffixTree
from tudocomp_tpu_torch.compressors import lfs, lfs2
from tudocomp_tpu_torch.ds.binary_suffix_tree import BinarySuffixTree
from tudocomp_tpu_torch.ds.naiv_st import NaivST
from tudocomp_tpu_torch.ds.suffix_tree import SuffixTree
from tudocomp_tpu_torch.ds.textds import TextDS

from .torch_cases import english


def _st_cases():
    rng = np.random.default_rng(0)
    cases = [b"banana\0", b"aaaa\0", b"abcabc\0", b"\0", b"a\0", b"mississippi\0"]
    for n in (10, 50, 200):
        for sigma in (2, 4, 26):
            cases.append(rng.integers(1, 1 + sigma, n).astype(np.uint8).tobytes() + b"\0")
    return cases


def _same_tree(a, b):
    np.testing.assert_array_equal(a.parent, b.parent)
    np.testing.assert_array_equal(a.sdepth, b.sdepth)
    np.testing.assert_array_equal(a.leaf_parent, b.leaf_parent)
    assert a.num_internal == b.num_internal


def test_structure_vs_bruteforce():
    for text in _st_cases():
        sa = naive_suffix_array(text)
        lcp = naive_lcp(text, sa)
        st = SuffixTree(sa, lcp)
        ref = JaxSuffixTree(sa, lcp)
        n = len(text)
        for r in range(n):
            p = int(st.leaf_parent[r])
            want = 0
            if r > 0:
                want = max(want, int(lcp[r]))
            if r + 1 < n:
                want = max(want, int(lcp[r + 1]))
            assert st.sdepth[p] == want
            ds = [int(st.sdepth[v]) for v in st.leaf_path(r)]
            assert ds[0] == 0 and all(a < b for a, b in zip(ds, ds[1:]))
            assert st.leaf_path(r) == ref.leaf_path(r)
        _same_tree(st, ref)


@pytest.mark.parametrize("gate", ["1", "0"])
def test_tree_from_the_arrays_textds_hands_over(gate, monkeypatch):
    """The int32 SA and LCP of the device path (gate 1) and of SA-IS (gate
    0) give the tree of the brute-force int64 arrays."""
    text = english(3000, seed=2) + b"\0"
    sa = naive_suffix_array(text)
    want = JaxSuffixTree(sa, naive_lcp(text, sa))
    monkeypatch.setenv("TDC_DEVICE_SA", gate)
    ds = TextDS(np.frombuffer(text, np.uint8).copy(), device="cpu")
    got_sa, got_lcp = ds.require_sa(), ds.require_lcp()
    assert got_sa.dtype == got_lcp.dtype == np.int32
    assert (ds._sa_d is not None) == (gate == "1")
    _same_tree(SuffixTree(got_sa, got_lcp), want)


def _bst_leaves(st):
    seen = []

    def walk(v):
        c = st.get_first_child(v)
        if c == 0 and v != 0:
            seen.append(st.get_suffix(v))
            return
        while c:
            walk(c)
            c = st.get_next_sibling(c)

    walk(0)
    return seen


@pytest.mark.parametrize("text", [b"banana\0", b"mississippi\0", b"abcabc abcabc xyxy\0", b"a\0"])
def test_binary_suffix_tree_structure(text):
    t = np.frombuffer(text, np.uint8)
    st = BinarySuffixTree(t)
    # every suffix reachable as a leaf exactly once
    assert sorted(_bst_leaves(st)) == list(range(len(t)))
    ref = JaxBST(t)
    assert st.get_tree_size() == ref.get_tree_size()
    for name in ("first_child", "next_sibling", "start", "end", "suffix_link", "suffix"):
        np.testing.assert_array_equal(getattr(st, name), getattr(ref, name))
    assert _bst_leaves(st) == _bst_leaves(ref)


@pytest.mark.parametrize("text", [b"banana\0", b"mississippi\0", b"aaaa\0", b"ab\0"])
def test_naiv_st_matches_binary_st_leaf_set(text):
    """NaivST (per-suffix insertion) and the Ukkonen BST agree on the
    suffix set; string depths of leaves are suffix lengths; the node arrays
    are the JAX package's."""
    t = np.frombuffer(text, np.uint8)
    st = NaivST(t)
    leaves = []

    def walk(v):
        ch = st.child_list(v)
        if not ch and v != 0:
            leaves.append(st.get_suffix(v))
            return
        for c in ch:
            walk(c)

    walk(0)
    assert sorted(leaves) == list(range(len(t))) == sorted(_bst_leaves(BinarySuffixTree(t)))
    for v in range(1, st.get_tree_size()):
        if not st.children[v]:
            assert st.string_depth(v) == len(t) - st.get_suffix(v)
    ref = JaxNaivST(t)
    assert (st.start, st.end, st.children, st.suffix, st.sdepth) == (
        ref.start, ref.end, ref.children, ref.suffix, ref.sdepth
    )


def _random_texts(seed: int, count: int = 10):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        n = int(rng.integers(10, 300))
        yield np.concatenate([rng.integers(97, 101, n).astype(np.uint8), [0]]).astype(np.uint8)


@pytest.mark.parametrize(
    "fn_name", ["esa_compute_rules", "st_compute_rules", "bst_compute_rules", "simst_compute_rules"]
)
def test_rules_nonoverlap(fn_name):
    compute = getattr(lfs, fn_name)
    for text in _random_texts(1):
        ds = TextDS(text, device="cpu")
        dictionary, nts = compute(text, ds.require_sa(), ds.require_lcp())
        # substituted regions must not overlap and must match their rule
        covered = np.zeros(len(text), bool)
        for pos, sym, length in nts:
            assert not covered[pos : pos + length].any()
            covered[pos : pos + length] = True
            off, ln = dictionary[sym]
            assert ln == length
            assert (text[pos : pos + length] == text[off : off + ln]).all()
        assert (dictionary, nts) == getattr(jax_lfs, fn_name)(text, ds.require_sa(), ds.require_lcp())


@pytest.mark.parametrize("exact", [False, True])
def test_lfs2_layers_match(exact):
    """lfs2's two-layer computation (the array tree) and lfs2bst's (the
    Ukkonen tree) give the JAX package's rules and layer arrays."""
    for text in _random_texts(2, count=6):
        ds = TextDS(text, device="cpu")
        sa, lcp = ds.require_sa(), ds.require_lcp()
        got = lfs2.lfs2_compute(text, sa, lcp, 3, exact)
        want = jax_lfs2.lfs2_compute(text, sa, lcp, 3, exact)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
        got = lfs2.lfs2bst_compute(text, 3)
        want = jax_lfs2.lfs2bst_compute(text, 3)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)
