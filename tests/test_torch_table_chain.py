"""A CPU model of kernels C's and G's schedule (csrc/tables.cu), against the plain versions and the JAX package.

The model follows the kernels step by step: phase 1 as moffat_chain runs
it on one thread (two picks a step decided at once from two heads of each
queue in registers, the pairs that may come next loaded before the picks,
the node just formed put into the heads by min(), INF for a queue slot
with no entry, only the internal weights recorded), kernel C's rank as
eight binary searches over its warps' sorted runs, phase 2 as each node's
parent found from its weight by a binary search over the leaves and
pointer jumping over the parents, ceil(log2(m - 1)) rounds, and
kernel C's canonical stage as its warps compute it (phase 3's leaf counts
and num_shorter as prefix sums, firstcode in closed form from a suffix
sum, the (length, symbol) order from per-warp counts and the lanes below
of equal length). It is held to moffat_phase12_plain and
huffman_tables_plain on every row of tests/torch_cases.table_rows, and on
the rows whose weights fit the JAX package's int32 to its XLA loop
(huffman_jax._phase12_xla) and its Pallas kernel in interpret mode.
Tolerance: exact equality, since every stage is integer arithmetic.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tudocomp_tpu.ops import huffman_jax as H
from tudocomp_tpu.ops.pallas_kernels import moffat_phase12 as pallas_moffat_phase12
from tudocomp_tpu_torch.ops import huffman_torch as T
from tudocomp_tpu_torch.ops.table_kernels import huffman_tables_plain, moffat_phase12_plain

from tests import torch_cases as tc

INF = (1 << 63) - 1  # Lim<int64_t>::INF; every weight is below it
SLOTS = 256 + 8
MAX_LEN = 32
ROWS = tc.table_rows()
JAX_ROWS = [n for n in ROWS if ROWS[n].sum() < 1 << 31]  # whose weights fit the JAX package's int32


def moffat_chain(lw, m):
    """Phase 1 as one thread of the kernel runs it: lw the sorted leaf
    weights, INF from m on. Returns the internal nodes' weights. A step
    loads the pairs that may become heads, (root + 2, root + 3) and (leaf +
    2, leaf + 3), before it picks; decides both picks from the heads R0,
    R1, L0, L1 at once (first: the internal node if R0 < L0; second: R1
    against L0 after an internal pick, R0 against L1 after a leaf); puts
    node t into the heads by min() (a formed node weighs at most w, an
    unformed one is INF); and stores the pairs (t - 1, t) and (t, INF)."""
    lq = [(lw[j], lw[j + 1]) for j in range(SLOTS - 1)] + [(INF, INF)]
    iq = [(INF, INF)] * SLOTS
    prev = lw[0] + lw[1]
    R, L = [prev, INF], list(lw[2:4])  # internal nodes root, root + 1; leaves leaf, leaf + 1
    root = 0  # leaf = 2 t - root
    for t in range(1, m - 1):
        x, y = iq[root + 2], lq[2 * t - root + 2]  # loaded before the picks
        a, b, c = R[0] < L[0], R[1] < L[0], R[0] < L[1]  # ties prefer the leaf
        nr = (1 + b) if a else int(c)  # internal nodes taken
        w = R[0] + R[1] if nr == 2 else L[0] + L[1] if nr == 0 else R[0] + L[0]
        r0, r1 = (R + list(x))[nr : nr + 2]
        L = (L + list(y))[2 - nr : 4 - nr]
        R = [min(r0, w), INF if r0 == INF else min(r1, w)]  # forwarding
        root += nr
        iq[t - 1], iq[t], prev = (prev, w), (w, INF), w
    assert root == m - 2
    return [q[0] for q in iq]


def internal_depth(iw, lw, m):
    """Phase 2 as the CTA runs it: node s's parent is the step that takes
    it, (s + #{leaves <= its weight}) // 2, the count by halving over the
    256 slots (INF from m on); then every thread s jumps to its ancestor,
    double-buffered rounds while the span is below m - 1."""
    p, d = list(range(256)), [0] * 256
    for s in range(m - 2):
        lo = 0
        for half in (128, 64, 32, 16, 8, 4, 2, 1):
            lo += half if lw[lo + half - 1] <= iw[s] else 0
        p[s], d[s] = (s + lo + (lw[lo] <= iw[s])) >> 1, 1
    span = 1
    while span < m - 1:
        d, p = [d[s] + d[p[s]] for s in range(256)], [p[p[s]] for s in range(256)]
        span <<= 1
    return d


def phase12_model(weights, m):
    """Kernel G's row: depths in slots 0..m-2, the weights elsewhere."""
    out = [int(x) for x in weights]
    if m >= 2:
        lw = out[:m] + [INF] * (SLOTS - m)
        d = internal_depth(moffat_chain(lw, m), lw, m)
        out[: m - 1] = d[: m - 1]
    return out


def rank_model(hist):
    """Kernel C's ranks: each warp's 32 keys sorted, then per thread the
    keys below its own in each run, by halving (16, 8, 4, 2, 1) and a last
    compare."""
    keys = [(int(h) << 9) | s if h > 0 else (1 << 62) | s for s, h in enumerate(hist)]
    runs = [sorted(keys[32 * w : 32 * w + 32]) for w in range(8)]
    ranks = []
    for k in keys:
        r = 0
        for run in runs:
            lo = 0
            for half in (16, 8, 4, 2, 1):
                lo += half if run[lo + half - 1] < k else 0
            r += lo + (run[lo] < k)
        ranks.append(r)
    return ranks


def tables_model(hist):
    """Kernel C's row (either instance, on counts its key takes) -> the six
    fields of HuffmanTables as lists, the true longest code and firstcode."""
    weights, sigma, rank = (x[0].tolist() for x in T._sort_hist(torch.tensor(hist)[None]))
    assert rank_model(hist) == rank
    m = int(sigma)
    A = phase12_model(weights, m)
    idepth = [min(A[s], MAX_LEN + 1) if s < m - 1 else MAX_LEN + 1 for s in range(256)]
    deepest = max(A[: m - 1]) + 1 if m >= 2 else 0
    nd = [idepth.count(d) for d in range(MAX_LEN + 1)]
    cum = [0] + list(np.cumsum([2 * nd[e - 1] - nd[e] for e in range(1, MAX_LEN + 1)]))  # warp 0's scan
    depth = [sum(c <= m - 1 - s for c in cum) if s < m else 0 for s in range(256)]
    length = [depth[rank[s]] if m >= 2 else 0 for s in range(256)]
    sigma_c = sum(x > 0 for x in length)
    longest = max(length)
    numl = [sum(x == l for x in length) for l in range(1, MAX_LEN + 1)]
    num_shorter = [0] + list(np.cumsum(numl))
    L = min(longest, MAX_LEN)  # warp 1's closed form of the firstcode recurrence
    u = [numl[j] << (L - 1 - j) if j < L else 0 for j in range(32)]
    firstcode = [sum(u[k + 1 :]) >> (L - 1 - k) if k < L - 1 else 0 for k in range(32)]
    wcnt = [[0] * (MAX_LEN + 2) for _ in range(8)]  # each warp's symbols of each length
    for s in range(256):
        if length[s]:
            wcnt[s >> 5][min(length[s], MAX_LEN + 1)] += 1
    cw, osym = [0] * 256, [0] * 256
    for s in range(256):
        if length[s]:
            slot = min(length[s] - 1, MAX_LEN)
            lane0 = s & ~31
            before = sum(length[j] == length[s] for j in range(lane0, s))  # lanes below, same length
            before += sum(wcnt[w][slot + 1] for w in range(s >> 5))
            osym[num_shorter[slot] + before] = s
            cw[s] = (firstcode[slot] if slot < MAX_LEN else 0) + before
    ordered = [osym[s] if s < sigma_c else 0 for s in range(256)]
    return (length, cw, numl, ordered, sigma_c, longest), deepest, firstcode


def _serial_firstcode(numl, longest):
    """The recurrence as the reference writes it (HuffmanCoder.hpp:192-218)."""
    fc, out = 0, [0] * 32
    for i in range(MAX_LEN - 1, 0, -1):
        fc = (fc + numl[i]) >> 1 if i < longest else 0
        out[i - 1] = fc
    return out


@functools.lru_cache(maxsize=1)
def _jax_phase12():
    """The XLA loop and the Pallas kernel (interpret mode) on JAX_ROWS, one call each."""
    w, s, _ = T._sort_hist(torch.from_numpy(np.stack([ROWS[n] for n in JAX_ROWS])))
    keys, sig = jnp.asarray(w.numpy().astype(np.int32)), jnp.asarray(s.numpy())
    xla = np.asarray(jax.vmap(H._phase12_xla)(keys, sig))
    pallas = np.asarray(pallas_moffat_phase12(keys, sig, interpret=True))
    return {n: (xla[i], pallas[i]) for i, n in enumerate(JAX_ROWS)}


@pytest.mark.parametrize("name", list(ROWS))
def test_chain_model_matches_plain_and_jax(name):
    hist = ROWS[name]
    w, s, _ = T._sort_hist(torch.from_numpy(hist[None]))
    m = int(s[0])
    got = np.array(phase12_model(w[0].tolist(), m), np.int64)
    np.testing.assert_array_equal(got, moffat_phase12_plain(w, s)[0].numpy())
    if name in JAX_ROWS:
        xla, pallas = _jax_phase12()[name]
        np.testing.assert_array_equal(got, pallas)
        internal = np.arange(256) < m - 1  # the XLA loop also rewrites slot 0 where m <= 1
        np.testing.assert_array_equal(got[internal], xla[internal])


@pytest.mark.parametrize("name", list(ROWS))
def test_table_model_matches_plain(name):
    hist = ROWS[name]
    (length, cw, numl, ordered, sigma, longest), deepest, firstcode = tables_model(hist)
    assert firstcode == _serial_firstcode(numl, longest)
    if deepest > MAX_LEN:  # the int64 instance sets the flag; the plain chain raises
        with pytest.raises(ValueError, match=f"{deepest}-bit codes"):
            huffman_tables_plain(torch.from_numpy(hist[None]))
        return
    want = huffman_tables_plain(torch.from_numpy(hist[None]))
    got = (length, np.array(cw, np.int64).astype(np.uint32).view(np.int32), numl, ordered, [sigma], [longest])
    for field, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), w[0].numpy() if w.dim() == 2 else w.numpy(), err_msg=field)


def test_rows_cover_the_cases():
    sigmas = {int((h > 0).sum()) for h in ROWS.values()}
    assert {0, 1, 2, 3, 255, 256} <= sigmas
    longest = {n: tables_model(ROWS[n])[1] for n in ROWS if n.startswith("fibonacci")}
    assert longest == {"fibonacci 30-bit": 30, "fibonacci 31-bit": 31, "fibonacci 32-bit": 32, "fibonacci 33-bit": 33}
    assert max(ROWS["past 2^31"]) >= 1 << 31
