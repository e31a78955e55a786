"""The probe kernels' plain versions against the Pallas bodies they replace.

Each plain version in tudocomp_tpu_torch/probes.py is held to the Pallas
kernel body of etc/probe3.py, probe6.py, probe7.py or probe8.py, run in
interpret mode on the CPU. Importing those scripts would run them, so the
test takes the kernel functions out of their sources (ast) and rebuilds the
pallas_call with the scripts' specs and interpret=True. The two rotations of
probe6.py are lambdas in the script and are restated here. Inputs come from
numpy seeds. Everything is integer: tolerance 0.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tudocomp_tpu_torch import probes
from tudocomp_tpu_torch.ops.bitpack import pack_tokens

from tests import torch_cases as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _functions(script, names, **consts):
    """The named top-level functions of etc/<script>, compiled in a namespace
    that holds jax, jnp, pl, pltpu and the given constants."""
    path = os.path.join(ROOT, "etc", script)
    tree = ast.parse(open(path).read(), path)
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in keep} == set(names)
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "np": np, **consts}
    exec(compile(ast.Module(keep, []), path, "exec"), ns)
    return [ns[n] for n in names]


def _u32(a):
    return np.asarray(a).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- probe3 ----------------------------------------------------------------------------------

P3_B, P3_BS = 3, 2048
P3_NT = 393 + P3_BS
P3_NW = (9 * P3_BS + 4096 + 31) // 32


def _probe3_functions():
    return _functions(
        "probe3.py", ["hillis_cumsum", "hillis_xor", "hist2", "gather_kernel"],
        B=P3_B, NT=P3_NT, n_words=P3_NW, LOG=max(1, (P3_NT - 1).bit_length()),
        NHI=(P3_NW + 1 + 255) // 256,
    )


def _probe3_inputs():
    rng = np.random.default_rng(3)
    nb = rng.integers(1, 13, (P3_B, P3_NT)).astype(np.int32)
    vals = rng.integers(0, 4096, (P3_B, P3_NT)).astype(np.int32)
    return vals, nb


def test_probe3_scans_and_histogram():
    hillis_cumsum, hillis_xor, hist2, _ = _probe3_functions()
    vals, nb = _probe3_inputs()
    np.testing.assert_array_equal(probes.hillis_cumsum(_t(nb)).numpy(), np.asarray(hillis_cumsum(jnp.asarray(nb))))
    np.testing.assert_array_equal(probes.hillis_cumsum(_t(nb)).numpy(), np.cumsum(nb, axis=1))
    np.testing.assert_array_equal(
        probes.hillis_xor(_t(vals)).numpy(), np.asarray(hillis_xor(jnp.asarray(vals).astype(jnp.uint32))).astype(np.int32)
    )
    np.testing.assert_array_equal(probes.hist2(_t(nb), P3_NW).numpy(), np.asarray(hist2(jnp.asarray(nb))))


def test_probe3_gather():
    _, hillis_xor, hist2, gather_kernel = _probe3_functions()
    vals, nb = _probe3_inputs()
    S = np.asarray(hillis_xor(jnp.asarray(vals).astype(jnp.uint32)))
    idx = np.clip(np.asarray(hist2(jnp.asarray(nb))), 0, P3_NT - 1).astype(np.int32)
    want = pl.pallas_call(
        gather_kernel,
        grid=(P3_B,),
        in_specs=[
            pl.BlockSpec((1, S.shape[1]), lambda b: (b, 0)),
            pl.BlockSpec((1, idx.shape[1]), lambda b: (b, 0)),
        ],
        out_specs=pl.BlockSpec((1, idx.shape[1]), lambda b: (b, 0)),
        out_shape=jax.ShapeDtypeStruct((P3_B, idx.shape[1]), jnp.uint32),
        interpret=True,
    )(jnp.asarray(S), jnp.asarray(idx))
    got = probes.gather(_t(S.astype(np.int32)), _t(idx))
    np.testing.assert_array_equal(_u32(got.numpy()), np.asarray(want))
    np.testing.assert_array_equal(_u32(got.numpy()), np.take_along_axis(S, idx.astype(np.int64), axis=1))
    with pytest.raises((IndexError, RuntimeError)):
        probes.gather(_t(S.astype(np.int32)), _t(idx + P3_NT))


# the arm each case's tiles take (staged, direct, out of range), by gather_kernel's rule
GATHER_ARMS = {
    "sorted": [15, 0, 0],
    "random": [0, 10, 0],
    "one entry": [1, 0, 0],
    "odd rows": [35, 0, 0],
    "ends": [9, 0, 0],
    "ns below a tile": [12, 0, 0],
}


@pytest.mark.parametrize("case", list(GATHER_ARMS))
def test_probe3_gather_edge_shapes(case):
    S, idx = probes.gather_cases("cpu")[case]
    arms = torch.zeros(3, dtype=torch.int32)
    got = probes.gather(S, idx, arms)
    np.testing.assert_array_equal(got.numpy(), np.take_along_axis(S.numpy(), idx.numpy().astype(np.int64), axis=1))
    assert arms.tolist() == GATHER_ARMS[case]


@pytest.mark.parametrize("shift", [-1, "ns"])
def test_probe3_gather_out_of_range_raises(shift):
    S, idx = probes.gather_cases("cpu")["odd rows"]
    idx = idx.clone()
    idx[3, 4000] = -1 if shift == -1 else S.shape[1]
    assert probes.gather_arms(S, idx).tolist() == [34, 0, 1]
    with pytest.raises(IndexError):
        probes.gather(S, idx)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GATHER_ARMS))
def test_probe3_gather_kernel_edge_shapes(cuda_dev, case):
    S, idx = probes.gather_cases(cuda_dev)[case]
    arms = torch.zeros(3, dtype=torch.int32, device=cuda_dev)
    got = probes.gather(S, idx, arms)
    assert torch.equal(got.cpu(), probes.gather_plain(S, idx).cpu())
    assert arms.tolist() == GATHER_ARMS[case]


@pytest.mark.cuda
def test_probe3_gather_kernel_raises_then_recovers(cuda_dev):
    S, idx = probes.gather_cases(cuda_dev)["odd rows"]
    bad = idx.clone()
    bad[3, 4000] = S.shape[1]
    with pytest.raises(IndexError):
        probes.gather(S, bad)
    assert torch.equal(probes.gather(S, idx).cpu(), probes.gather_plain(S, idx).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", ["arange", "signed"])
def test_probe6_roll_lane_kernel(cuda_dev, tile):
    x = _t(_tiles()[tile]).to(cuda_dev)
    assert torch.equal(probes.roll_lane(x).cpu(), probes.roll_lane_plain(x).cpu())
    assert torch.equal(probes.roll_lane(x[:, :].t().contiguous().t()).cpu(), probes.roll_lane_plain(x).cpu())


# ---- probe6 ----------------------------------------------------------------------------------


def _tiles():
    rng = np.random.default_rng(6)
    return {
        "arange": np.arange(8 * 128, dtype=np.int32).reshape(8, 128),
        "random": rng.integers(0, 1 << 31, (8, 128)).astype(np.int32),
        "signed": rng.integers(-(1 << 31), 1 << 31, (8, 128)).astype(np.int32),
    }


def _probe6_bodies():
    k_extract, k_bid, k_dot3, k_shift = _functions("probe6.py", ["k_extract", "k_bid", "k_dot3", "k_shift"])

    def roll_lane(i, o):
        o[...] = pltpu.roll(i[...], 1, axis=1)

    def roll_sublane(i, o):
        o[...] = pltpu.roll(i[...], 1, axis=0)

    return {
        "roll_lane": (roll_lane, probes.roll_lane),
        "roll_sublane": (roll_sublane, probes.roll_sublane),
        "scalar_extract": (k_extract, probes.scalar_extract),
        "broadcast_last_lane": (k_bid, probes.broadcast_last_lane),
        "onehot_count": (k_dot3, probes.onehot_count),
        "var_shift": (k_shift, probes.var_shift),
    }


@pytest.mark.parametrize("tile", ["arange", "random", "signed"])
@pytest.mark.parametrize(
    "name", ["roll_lane", "roll_sublane", "scalar_extract", "broadcast_last_lane", "onehot_count", "var_shift"]
)
def test_probe6_tile_primitives(name, tile):
    body, port = _probe6_bodies()[name]
    x = _tiles()[tile]
    want = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32), interpret=True)(jnp.asarray(x))
    np.testing.assert_array_equal(port(_t(x)).numpy(), np.asarray(want))


def _k_rmw(i):
    """The Pallas body of k_rmw in interpret mode on i ([1, 1] int32): u32 [1, 1, 1152]."""
    (k_rmw,) = _functions("probe6.py", ["k_rmw"])
    return np.asarray(pl.pallas_call(
        k_rmw,
        out_shape=jax.ShapeDtypeStruct((1, 1, 1152), jnp.uint32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(i, jnp.int32)))


@pytest.mark.parametrize("i", [0, 127, 300, 767, 895])
def test_probe6_window_rmw(i):
    """895 opens the last window that fits 1152 words (a = 768)."""
    got = probes.window_rmw(torch.tensor([[i]], dtype=torch.int32))
    np.testing.assert_array_equal(_u32(got.numpy()), _k_rmw([[i]]))
    with pytest.raises(IndexError):
        probes.window_rmw(torch.tensor([[1152]], dtype=torch.int32))


@pytest.mark.parametrize("i, n_words", tc.P6_RMW_BAD)
def test_probe6_window_rmw_outside_the_row_raises(i, n_words):
    """A window before the row, past its end or at int32's ends, and a row
    of 383 words, raise IndexError in the wrapper and the plain version."""
    t = torch.tensor([[i]], dtype=torch.int32)
    for fn in (probes.window_rmw, probes.window_rmw_plain):
        with pytest.raises(IndexError, match="window outside the row"):
            fn(t, n_words)


@pytest.mark.parametrize("n_words", [384, 385, 1155])
@pytest.mark.parametrize("i", [0, 1, 127])
def test_probe6_window_rmw_plain_first_window(i, n_words):
    """i in [0, 127] opens the window at word 0: 384 sevens, zeros past them."""
    want = np.zeros((1, 1, n_words), np.int32)
    want[..., : probes.WIN] = 7
    t = torch.tensor([[i]], dtype=torch.int32)
    for fn in (probes.window_rmw, probes.window_rmw_plain):
        np.testing.assert_array_equal(fn(t, n_words).numpy(), want)


@pytest.mark.parametrize("case", list(tc.p6_cases()))
def test_probe6_cases_match_the_bodies(case):
    """The card's cases (tc.p6_cases) on the CPU: var_shift,
    broadcast_last_lane, onehot_count and scalar_extract against k_shift,
    k_bid, k_dot3 and k_extract in interpret mode; window_rmw against k_rmw
    at its 1152 words, and at other lengths against the window written out
    in numpy."""
    name, args = tc.p6_cases()[case]
    got = getattr(probes, name)(*args)
    if name != "window_rmw":
        body = _probe6_bodies()[name][0]
        want = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.int32),
                              interpret=True)(jnp.asarray(args[0].contiguous().numpy()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    i, n_words = args
    first = int(i.reshape(-1)[0])
    if n_words == probes.P6_RMW_WORDS:
        want = _k_rmw([[first]])
    else:
        want = np.zeros((1, 1, n_words), np.uint32)
        a = (first >> 7) * 128
        want[..., a : a + probes.WIN] = 7
    np.testing.assert_array_equal(_u32(got.numpy()), want)


_TILE_OPS = ["roll_lane", "roll_sublane", "scalar_extract", "broadcast_last_lane", "onehot_count", "var_shift"]
_BAD_TILES = {
    "int64 [4]": torch.arange(4, dtype=torch.int64),
    "int64 tile": torch.arange(1024, dtype=torch.int64).reshape(8, 128),
    "float32 tile": torch.zeros((8, 128), dtype=torch.float32),
    "int32 [16, 128]": torch.zeros((16, 128), dtype=torch.int32),
    "int32 [128, 8]": torch.zeros((128, 8), dtype=torch.int32),
    "int32 [1024]": torch.arange(1024, dtype=torch.int32),
}
P6_BAD_INPUTS = {
    **{f"{fn}, {bad}": (fn, (x,), ValueError) for fn in _TILE_OPS for bad, x in _BAD_TILES.items()},
    "window_rmw, float i": ("window_rmw", (torch.tensor([[300.7]]),), TypeError),
    "window_rmw, int64 i": ("window_rmw", (torch.tensor([[300]]),), TypeError),
    "window_rmw, empty i": ("window_rmw", (torch.zeros((0,), dtype=torch.int32),), IndexError),
    "window_rmw, empty [1, 0] i": ("window_rmw", (torch.zeros((1, 0), dtype=torch.int32),), IndexError),
    "window_rmw, n_words 383": ("window_rmw", (torch.tensor([[0]], dtype=torch.int32), 383), IndexError),
    "window_rmw, n_words 0": ("window_rmw", (torch.tensor([[0]], dtype=torch.int32), 0), IndexError),
}


@pytest.mark.parametrize("case", list(P6_BAD_INPUTS))
def test_probe6_wrappers_check_before_the_route(case):
    """On the CPU each of the seven probe6 wrappers raises on the inputs
    that its card route refuses, with the same exception: a tile that is
    not int32 [8, 128] ValueError; window_rmw a non-int32 i TypeError, an
    empty i or a row under 384 words IndexError (tests/test_torch_launch.py
    holds the card route to the same, with no launch)."""
    name, args, exc = P6_BAD_INPUTS[case]
    with pytest.raises(exc):
        getattr(probes, name)(*args)


# ---- probe7 ----------------------------------------------------------------------------------

P7 = dict(WIN=384, B=2, NT=3072, T=3, n_words=1100, NWp=probes.P7_NWP)


def _probe7_tokens(seed, thin=False):
    """The script's tokens (its seed is 0): widths in [0, 32]. With `thin`
    a fifth of the widths is zeroed, so that the bits end before word 1408:
    on its own tokens (48513 and 48970 bits) the script's last rows open
    their 384-word window at word 1408 of an arena of 1664, past its end,
    and what level 5 then writes is not defined."""
    rng = np.random.default_rng(seed)
    nbits = rng.integers(0, 33, (2, 3072)).astype(np.int32)
    vals = rng.integers(0, 1 << 31, (2, 3072)).astype(np.uint32)
    if thin:
        nbits[rng.random((2, 3072)) < 0.2] = 0
        assert nbits.sum(1).max() < 1408 * 32
    return vals, nbits


def _probe7_pallas(level, vals, nbits):
    (make,) = _functions("probe7.py", ["make"], **P7)
    B, T, NWp = 2, 3, probes.P7_NWP
    return pl.pallas_call(
        make(level),
        grid=(B, T),
        in_specs=[
            pl.BlockSpec((1, 1, 8, 128), lambda b, t: (b, t, 0, 0)),
            pl.BlockSpec((1, 1, 8, 128), lambda b, t: (b, t, 0, 0)),
        ],
        out_specs=(
            pl.BlockSpec((1, 1, NWp), lambda b, t: (b, 0, 0)),
            pl.BlockSpec((1, 1, 1), lambda b, t: (b, 0, 0), memory_space=pltpu.SMEM),
        ),
        out_shape=(
            jax.ShapeDtypeStruct((B, 1, NWp), jnp.uint32),
            jax.ShapeDtypeStruct((B, 1, 1), jnp.int32),
        ),
        scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        interpret=True,
    )(jnp.asarray(vals.reshape(B, T, 8, 128)), jnp.asarray(nbits.reshape(B, T, 8, 128)))


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_probe7_levels_match_pallas(level):
    vals, nbits = _probe7_tokens(0, thin=level == 5)  # the script's own seed and draw order
    want_words, want_bits = _probe7_pallas(level, vals, nbits)
    words, bits = probes.pack_levels(_t(vals.astype(np.int32)), _t(nbits), probes.P7_NWP, level)
    assert words.shape == (2, 1, probes.P7_NWP) and bits.shape == (2, 1, 1)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(bits.numpy().ravel(), nbits.sum(1))
    np.testing.assert_array_equal(_u32(words.numpy()), np.asarray(want_words))
    assert bool(words.any()) == (level == 5)


def test_probe7_level5_is_pack_tokens():
    vals, nbits = _probe7_tokens(5)
    words, bits = probes.pack_levels(_t(vals.astype(np.int32)), _t(nbits), probes.P7_NWP, 5)
    for b in range(2):
        w, total = pack_tokens(_t(vals[b].astype(np.int32)), _t(nbits[b]), probes.P7_NWP)
        np.testing.assert_array_equal(words[b, 0].numpy(), w.numpy())
        assert int(bits[b, 0, 0]) == int(total)


def test_probe7_intermediates_add_up():
    """What levels 2-4 expose is consistent with level 5's arena: the word
    parts of level 2 and 3 and the windows of level 4 each rebuild it."""
    vals, nbits = _probe7_tokens(7)
    v, nb = _t(vals.astype(np.int32)), _t(nbits)
    n_wp = probes.P7_NWP
    want = _u32(probes.pack_levels(v, nb, n_wp, 5)[0].numpy())[:, 0]
    off = np.cumsum(nbits, axis=1) - nbits
    w0 = off >> 5
    for level in (2, 3):
        mid = _u32(probes.pack_levels(v, nb, n_wp, level, want_mid=True)[2].numpy())
        got = np.zeros((2, n_wp + 2), np.uint32)
        for b in range(2):
            np.bitwise_xor.at(got[b], w0[b], mid[b, :, 0])
            np.bitwise_xor.at(got[b], w0[b] + 1, mid[b, :, 1])
        np.testing.assert_array_equal(got[:, :n_wp], want)
    win = _u32(probes.pack_levels(v, nb, n_wp, 4, want_mid=True)[2].numpy())
    assert win.shape == (2, 3, probes.TILE_WIN)
    got = np.zeros((2, n_wp + probes.TILE_WIN), np.uint32)
    for b in range(2):
        for t in range(3):
            abase = ((off[b, t * 1024] >> 5) >> 7) << 7
            got[b, abase : abase + probes.TILE_WIN] ^= win[b, t]
    np.testing.assert_array_equal(got[:, :n_wp], want)
    assert probes.pack_levels(v, nb, n_wp, 1, want_mid=True)[2] is None


def test_probe7_rejects_bad_tokens():
    vals, nbits = _probe7_tokens(1)
    bad = nbits.copy()
    bad[0, 5] = 33
    with pytest.raises(ValueError):
        probes.pack_levels(_t(vals.astype(np.int32)), _t(bad), probes.P7_NWP, 5)
    with pytest.raises(ValueError):
        probes.pack_levels(_t(vals[:, :100].astype(np.int32)), _t(nbits[:, :100].copy()), probes.P7_NWP, 5)


@pytest.mark.parametrize("tiles", [probes.P7_MAX_TILES, probes.P7_MAX_TILES + 1])
def test_probe7_tile_cap(tiles):
    """pack_levels takes rows of up to P7_MAX_TILES tiles (the kernel's
    re-sum of earlier widths grows with the square of the tiles) and
    raises past them, before it packs anything."""
    nt = tiles * probes.TILE
    nbits = np.full((1, nt), 32, np.int32)
    vals = np.arange(nt, dtype=np.int32)[None]
    n_wp = nt + 128
    if tiles > probes.P7_MAX_TILES:
        with pytest.raises(ValueError, match="tiles a row"):
            probes.pack_levels(_t(vals), _t(nbits), n_wp, 5)
        return
    words, bits = probes.pack_levels(_t(vals), _t(nbits), n_wp, 5)
    assert int(bits) == 32 * nt
    np.testing.assert_array_equal(words.numpy()[0, 0, :nt], vals[0])
    assert not words.numpy()[0, 0, nt:].any()


# Kernel P7's schedule (csrc/probes.cu:p7_pack_kernel), emulated CTA by CTA:
# one CTA a (row, tile), the tiles taken last first so that none can lean on
# another; each sums the widths before its tile itself; nothing zeroes the
# arena first (it starts as garbage): levels 1-4 write zeros, each CTA its
# share; at level 5 a word that a tile boundary cuts belongs to the last
# tile starting inside it, which ORs in the bits of the tokens before it
# (walked back 32 at a time), and the last tile zeroes the words past the
# row's bits. The emulation checks that every word is stored exactly once.


def _parts(v, nb, off):
    """(hi, lo) of tokens of width nb at bit offset off, as uint64 arrays."""
    vm = v.astype(np.uint64) & ((np.uint64(1) << nb.astype(np.uint64)) - np.uint64(1))
    sh_end = (off & 31) + nb
    hi = np.where(sh_end <= 32, vm << np.clip(32 - sh_end, 0, 63).astype(np.uint64),
                  vm >> np.clip(sh_end - 32, 0, 63).astype(np.uint64))
    lo = np.where(sh_end > 32, vm << np.clip(64 - sh_end, 0, 63).astype(np.uint64), 0)
    return np.where(nb > 0, hi & 0xFFFFFFFF, 0).astype(np.uint64), np.where(nb > 0, lo & 0xFFFFFFFF, 0).astype(np.uint64)


def emulate_p7(vals, nbits, n_wp, level):
    """(words [B, n_wp] uint32, bits [B], mid, boundary) by the kernel's
    schedule; boundary: the words whose owner gathered earlier tiles' bits."""
    B, NT = nbits.shape
    T, TW = NT // 1024, probes.TILE_WIN
    nbw = np.where((nbits < 0) | (nbits > 32), 0, nbits).astype(np.int64)
    words = np.random.default_rng(1).integers(0, 1 << 32, (B, n_wp), dtype=np.uint64).astype(np.uint32)
    stores = np.zeros((B, n_wp), np.int64)
    bits = np.zeros(B, np.int64)
    mid = {2: np.zeros((B, NT, 2), np.uint32), 3: np.zeros((B, NT, 2), np.uint32),
           4: np.zeros((B, T, TW), np.uint32)}.get(level)
    boundary = 0

    def store(b, w, x):
        words[b, w] = np.uint32(x)
        stores[b, w] += 1

    for b in range(B):
        for t in reversed(range(T)):
            sl = slice(t * 1024, (t + 1) * 1024)
            if level < 5:
                for w in range(n_wp * t // T, n_wp * (t + 1) // T):
                    store(b, w, 0)
            c0 = int(nbw[b, : t * 1024].reshape(-1, 4).sum())  # the re-sum, four widths a load
            nb = nbw[b, sl]
            incl = np.cumsum(nb)
            off, tile_bits = c0 + incl - nb, int(incl[-1])
            if t == T - 1:
                bits[b] = c0 + tile_bits
            if level == 1:
                continue
            hi, lo = _parts(vals[b, sl], nb, off)
            w0 = off >> 5
            if level == 2:
                mid[b, sl] = np.stack([hi, lo], 1)
                continue
            lane = np.arange(1024) % 32
            last = np.ones(1024, bool)
            last[:-1] = (w0[1:] != w0[:-1]) | (lane[1:] == 0)
            hi_c, acc = np.zeros(1024, np.uint64), np.uint64(0)
            for k in range(1024):  # the segmented XOR scan, runs within a warp
                acc = hi[k] if lane[k] == 0 or w0[k] != w0[k - 1] else acc ^ hi[k]
                hi_c[k] = acc if last[k] else 0
            lo_c = np.where(last, lo, 0).astype(np.uint64)
            if level == 3:
                mid[b, sl] = np.stack([hi_c, lo_c], 1)
                continue
            abase = ((c0 >> 5) >> 7) << 7
            win = np.zeros(TW, np.uint64)
            np.bitwise_xor.at(win, w0 - abase, hi_c)
            np.bitwise_xor.at(win, w0 + 1 - abase, lo_c)
            if level == 4:
                mid[b, t] = win
                continue
            end, w_first = c0 + tile_bits, c0 >> 5
            w_last = ((end + 31) >> 5) - 1 if t == T - 1 else (end >> 5) - 1
            earlier = 0
            if c0 & 31 and w_first <= w_last:  # warp 0 walks back, 32 tokens at a time
                boundary += 1
                k, after = t * 1024, 0
                while True:
                    cnb = nbw[b, k - 32 : k]
                    suffix = np.cumsum(cnb[::-1])[::-1]
                    tok_end = c0 - after - (suffix - cnb)
                    phi, plo = _parts(vals[b, k - 32 : k], cnb, tok_end - cnb)
                    tw = (tok_end - cnb) >> 5
                    reach = (cnb > 0) & (tok_end > 32 * w_first)
                    for j in np.nonzero(reach)[0]:
                        earlier |= int(phi[j]) if tw[j] == w_first else 0
                        earlier |= int(plo[j]) if tw[j] + 1 == w_first else 0
                    after += int(suffix[0])
                    k -= 32
                    if after >= (c0 & 31) or k == 0:
                        break
            for w in range(w_first, min(w_last, n_wp - 1) + 1):
                store(b, w, int(win[w - abase]) | (earlier if w == w_first else 0))
            if t == T - 1:
                for w in range((end + 31) >> 5, n_wp):
                    store(b, w, 0)
    assert (stores == 1).all(), np.argwhere(stores != 1)[:5]
    return words, bits, mid, boundary


@pytest.mark.parametrize("widths", tc.P7_WIDTHS)
@pytest.mark.parametrize("nt", [1024, 3072, 5120])
def test_probe7_tile_schedule(nt, widths):
    """The emulated schedule against pack_levels_plain at every level, mid
    included, and at level 5 also on an arena that drops bits; the mixed
    widths share a boundary word between every two tiles of row 0, the
    sparse ones put several tiles inside one word."""
    vals, nbits = tc.p7_tokens(nt, widths, seed=nt)
    v, nb = _t(vals.view(np.int32)), _t(nbits)
    for n_wp in (nt + 32, nt // 3):
        for level in (1, 2, 3, 4, 5) if n_wp > nt else (5,):
            words, bits, mid, boundary = emulate_p7(vals, nbits, n_wp, level)
            want = probes.pack_levels_plain(v, nb, n_wp, level, want_mid=True)
            np.testing.assert_array_equal(words, _u32(want[0].numpy())[:, 0], err_msg=f"level {level}")
            np.testing.assert_array_equal(bits, want[1].numpy().ravel())
            if want[2] is not None:
                np.testing.assert_array_equal(mid, _u32(want[2].numpy()), err_msg=f"level {level}")
            if level == 5 and n_wp > nt:
                tiles = nt // 1024
                assert boundary >= {"mix": tiles - 1, "sparse": min(1, tiles - 1)}.get(widths, 0)


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_probe7_tile_schedule_matches_pallas(level):
    """The emulated schedule against etc/probe7.py's levels on the script's
    tokens (thinned at level 5, ROADMAP's trap); at level 5 also the full
    tokens against pack_tokens."""
    vals, nbits = _probe7_tokens(0, thin=level == 5)
    want_words, want_bits = _probe7_pallas(level, vals, nbits)
    words, bits, _, _ = emulate_p7(vals, nbits, probes.P7_NWP, level)
    np.testing.assert_array_equal(words, np.asarray(want_words)[:, 0])
    np.testing.assert_array_equal(bits, np.asarray(want_bits).ravel())
    if level == 5:
        vals, nbits = _probe7_tokens(0)
        words, bits, _, _ = emulate_p7(vals, nbits, probes.P7_NWP, 5)
        for b in range(2):
            w, total = pack_tokens(_t(vals[b].astype(np.int32)), _t(nbits[b]), probes.P7_NWP)
            np.testing.assert_array_equal(words[b], _u32(w.numpy()))
            assert bits[b] == int(total)


# ---- probe8 ----------------------------------------------------------------------------------


def _probe8_pallas(kernel, v):
    B, T, NWp = v.shape[0], v.shape[1], probes.P8_NWP
    return pl.pallas_call(
        kernel,
        grid=(B, T),
        in_specs=[pl.BlockSpec((1, 1, 8, 128), lambda b, t: (b, t, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, NWp), lambda b, t: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, 1, NWp), jnp.uint32),
        scratch_shapes=[pltpu.SMEM((1,), jnp.int32)],
        interpret=True,
    )(jnp.asarray(v))


def _probe8_inputs():
    rng = np.random.default_rng(8)
    return {
        "ones": np.ones((2, 3, 8, 128), np.int32),
        "random": rng.integers(0, 33, (2, 3, 8, 128)).astype(np.int32),
        "extremes": rng.choice(tc.P8_EXTREMES, (2, 3, 8, 128)),
    }


@pytest.mark.parametrize("data", ["ones", "random", "extremes"])
@pytest.mark.parametrize("name", ["k_a", "k_b", "k_c", "k_d"])
def test_probe8_steps_match_pallas(name, data):
    (kernel,) = _functions("probe8.py", [name])
    port = {"k_a": probes.carry_revisit, "k_b": probes.carry_scans,
            "k_c": probes.carry_into_vector, "k_d": probes.rmw_loop8}[name]
    v = _probe8_inputs()[data]
    words, carry = port(_t(v))
    assert words.shape == (2, 1, probes.P8_NWP)
    np.testing.assert_array_equal(_u32(words.numpy()), np.asarray(_probe8_pallas(kernel, v)))
    want_carry = {  # the scripts' int32 carry: sums wrap
        "k_a": v[:, :, 0, 0].sum(1), "k_b": v.sum((1, 2, 3)),
        "k_c": v[:, :, 7, :].sum((1, 2)), "k_d": np.zeros(2),
    }[name].astype(np.int64).astype(np.int32)
    np.testing.assert_array_equal(carry.numpy(), want_carry)


P8_PORT = {"k_a": (probes.carry_revisit, probes.carry_revisit_plain),
           "k_b": (probes.carry_scans, probes.carry_scans_plain),
           "k_c": (probes.carry_into_vector, probes.carry_into_vector_plain),
           "k_d": (probes.rmw_loop8, probes.rmw_loop8_plain)}


@pytest.mark.parametrize("shape", [(0, 3), (2, 0), (0, 0)], ids=["B = 0", "T = 0", "B = T = 0"])
@pytest.mark.parametrize("name", ["k_a", "k_b", "k_c", "k_d"])
def test_probe8_empty_inputs(name, shape):
    """One answer on empty inputs for all four, wrapper and plain version:
    rows of no tile (T = 0) give a zeroed arena and carry 0, no rows (B =
    0) empty tensors. The Pallas body gives no answer there: its block of
    one tile exceeds the empty operand, and interpret mode raises."""
    (kernel,) = _functions("probe8.py", [name])
    v = np.zeros((*shape, 8, 128), np.int32)
    for fn in P8_PORT[name]:
        words, carry = fn(_t(v))
        assert words.shape == (shape[0], 1, probes.P8_NWP) and carry.shape == (shape[0],)
        assert words.dtype == carry.dtype == torch.int32
        assert not words.any() and not carry.any()
    with pytest.raises(TypeError, match="slice_sizes"):
        _probe8_pallas(kernel, v)


@pytest.mark.parametrize("shape", [(0, 3), (2, 0)], ids=["B = 0", "T = 0"])
def test_probe8_rmw_loop8_short_row_raises_on_empty_inputs(shape):
    """k_d's window check comes first: a row of 383 words raises on empty
    inputs too, in the wrapper and the plain version alike."""
    v = _t(np.zeros((*shape, 8, 128), np.int32))
    for fn in P8_PORT["k_d"]:
        with pytest.raises(IndexError, match="window outside the row"):
            fn(v, probes.WIN - 1)


@pytest.mark.parametrize("n_wp", [383, 384, 1667])
def test_probe8_rmw_loop8_needs_a_whole_window(n_wp):
    """Every window starts at word 0 ((v * 3) mod 8 >> 7 is 0), so the row
    needs 384 words: 383 raises, 384 and more hold the windows' XOR."""
    v = _probe8_inputs()["extremes"]
    if n_wp < probes.WIN:
        with pytest.raises(IndexError, match="window outside the row"):
            probes.rmw_loop8(_t(v), n_wp)
        return
    words, carry = probes.rmw_loop8(_t(v), n_wp)
    want = np.zeros((2, 1, n_wp), np.uint32)
    # each tile XORs 1 ^ 2 ^ ... ^ 8 = 8 into the window; 3 tiles leave 8
    want[:, :, : probes.WIN] = np.bitwise_xor.reduce(np.arange(1, 9, dtype=np.uint32)) if v.shape[1] % 2 else 0
    np.testing.assert_array_equal(_u32(words.numpy()), want)
    np.testing.assert_array_equal(carry.numpy(), np.zeros(2, np.int32))


def test_probes_entry_point_runs_on_the_cpu(capsys):
    assert probes.main(["6", "7", "8", "--device", "cpu"]) == 0
    probes.run_probe3(torch.device("cpu"), B=2, bs=4096)  # the entry point runs it at 64 x 2^18
    out = capsys.readouterr().out
    for line in ("gather", "roll_lane", "dyn_ds_rmw", "level 5", "rmw_loop8", "done"):
        assert line in out


def test_probes_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this case checks the machine without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes.main(["6"])
