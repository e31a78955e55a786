"""The port's ESP rounds on the CPU, against the JAX package and the host rounds.

- Rounds: the port's host round (C++ and Python) and its device round on
  the CPU (ops/esp_torch.py, kernel I's plain version) against the JAX
  package's esp_round, on random strings at the alphabets where iter_log changes, and on
  mississippi; one small round against the JAX package's own device round.
- Grammar: esp_grammar_device(..., device="cpu") against the JAX package's
  generate_grammar on 256 KiB of English-like text and on runs.
- The naming invariant: no adjusted block of a round spans one symbol (so
  nb <= size // 2), on strings built of short runs and short non-run
  segments; a round whose blocks would not fit raises.
- Queue machine: the adjust pass (spans and kernel I's plain version) against
  the host _adjust_blocks on random block lists, with spans wider than the
  JAX package's 128-block cap; kernel I's edge spans; a lane-by-lane model
  of kernel I's warps (csrc/esp.cu: each group of 32 spans staged by a warp
  scan of their widths and a binary search over it, the spans past the
  slot or the warp's capacity walked in place) against the plain version.
- tdc_lis_indices (C++) against a Python copy of the patience-sorting loop.
Tolerance: exact equality everywhere (integer arithmetic).
"""

import os
import re
from bisect import bisect_left

import numpy as np
import pytest
import torch

from tudocomp_tpu.compressors.esp import _adjust_blocks as jax_adjust_blocks
from tudocomp_tpu.compressors.esp import esp_round as jax_esp_round
from tudocomp_tpu.compressors.esp import generate_grammar as jax_generate_grammar
from tudocomp_tpu.ops.esp_jax import esp_round_device as jax_esp_round_device
from tudocomp_tpu_torch import device as tdev
from tudocomp_tpu_torch import native
from tudocomp_tpu_torch.compressors import esp
from tudocomp_tpu_torch.compressors.esp_dcoding import SubSeqOptimal, _lis_indices
from tudocomp_tpu_torch.ops import esp_torch as et
from tudocomp_tpu_torch.ops.esp_kernels import CAP, SLOT, esp_adjust_windows, esp_adjust_windows_plain

from . import torch_cases

ALPHABETS = [2, 6, 7, 8, 9, 16, 17, 256, 257, 1000]
CPU = torch.device("cpu")


def _strings(alphabet: int, seed: int):
    """Random strings over an alphabet: uniform, with runs, and over a few
    symbols drawn from the whole alphabet."""
    rng = np.random.default_rng(seed)
    out = []
    for trial in range(24):
        L = int(rng.integers(2, 400))
        sigma = min(alphabet, int(rng.choice([2, 3, 4, 8, alphabet])))
        if trial % 3 == 0:
            s = rng.integers(0, sigma, L)
        elif trial % 3 == 1:
            s = np.repeat(rng.integers(0, sigma, L), rng.integers(1, 5, L))[:L]
        else:
            s = rng.choice(np.unique(rng.integers(0, alphabet, sigma)), L)
        if len(s) >= 2:
            out.append(s.astype(np.uint32))
    return out


def _assert_round_eq(want, got):
    for w, g, name in zip(want, got, ("nxt", "rl", "rr")):
        assert np.array_equal(w, g), name


@pytest.mark.parametrize("alphabet", ALPHABETS)
def test_rounds_match_the_jax_package(alphabet):
    for s in _strings(alphabet, alphabet):
        want = jax_esp_round(s, alphabet)
        _assert_round_eq(want, esp.esp_round(s, alphabet))
        _assert_round_eq(want, esp.esp_round_python(s, alphabet))
        _assert_round_eq(want, et.esp_round_device(s, alphabet, CPU))


@pytest.mark.parametrize("reps", [1, 30])
def test_rounds_mississippi(reps):
    s = np.frombuffer(b"mississippi" * reps, np.uint8).astype(np.uint32)
    want = jax_esp_round(s, 256)
    _assert_round_eq(want, esp.esp_round(s, 256))
    _assert_round_eq(want, et.esp_round_device(s, 256, CPU))


def test_one_round_matches_the_jax_device_round():
    s = np.repeat(np.random.default_rng(4).integers(0, 9, 90), [1, 2, 1, 3, 1, 1] * 15).astype(np.uint32)
    want = jax_esp_round_device(s, 9)
    assert want is not None
    _assert_round_eq(want, et.esp_round_device(s, 9, CPU))


def _english_like(n: int) -> bytes:
    """synth_english's words (etc/datasets.py), seed 7: uniform words, 10%
    sentence breaks."""
    words = (
        "the quick brown fox jumps over lazy dog compression suffix array grammar factorization "
        "entropy huffman lempel ziv welch text data structure algorithm framework parallel device kernel"
    ).split()
    rng = np.random.default_rng(7)
    ids = rng.integers(0, len(words), n // 4)
    dots = rng.random(n // 4) <= 0.1
    return "".join(words[i] + (". " if d else " ") for i, d in zip(ids, dots)).encode()[:n]


def _runs(n: int) -> bytes:
    rng = np.random.default_rng(5)
    return np.repeat(rng.integers(97, 103, n // 3), rng.integers(1, 7, n // 3)).astype(np.uint8)[:n].tobytes()


@pytest.mark.parametrize("text", ["english", "runs"])
def test_grammar_matches_the_jax_package(text):
    data = np.frombuffer(_english_like(1 << 18) if text == "english" else _runs(1 << 18), np.uint8)
    assert len(data) == 1 << 18
    want = jax_generate_grammar(data)
    got = et.esp_grammar_device(data, threshold=1 << 10, device=CPU)
    assert np.array_equal(want[0], got[0])
    assert want[1:] == got[1:]


def _segments(rng, n: int, sigma: int) -> np.ndarray:
    """A string of short runs (2-4 symbols) and short non-run segments (1-5
    symbols) over sigma symbols: many length-1 blocks, type-3 prefixes and
    runs side by side."""
    out, last = [], -1
    while len(out) < n:
        if rng.random() < 0.5:
            c = int(rng.integers(0, sigma))
            out += [c] * int(rng.integers(2, 5))
        else:
            for _ in range(int(rng.integers(1, 6))):
                c = int(rng.integers(0, sigma))
                if out and c == out[-1]:
                    c = (c + 1) % sigma
                out.append(c)
    return np.array(out[:n], np.uint32)


@pytest.mark.parametrize("sigma", [2, 3, 7, 9, 17, 300])
def test_adjusted_blocks_fit_half_the_round(sigma):
    """The invariant behind the overflow flag (ops/esp_torch.py's
    docstring): before the adjust pass no type-2 block lies just before a
    type-3 one, and after it no block spans one symbol, so nb <= m // 2, in
    every round down to one symbol."""
    rng = np.random.default_rng(sigma)
    for trial in range(6):
        s = _segments(rng, int(rng.integers(2, 700)), sigma)
        size = 1 << max(3, (len(s) - 1).bit_length())
        src, m, alphabet = et.padded(s, size, CPU), torch.tensor(len(s), dtype=torch.int32), torch.tensor(sigma)
        alphabet = alphabet.to(torch.int32)
        while int(m) > 1:
            lens, typs, nb = et.stage_blocks(src, m, alphabet)
            t = typs[: int(nb)]
            assert not ((t[:-1] == 2) & (t[1:] == 3)).any()
            lens, typs, nb = et.adjust_pass(lens, typs, nb)
            assert int(lens[: int(nb)].min()) >= 2 and 2 * int(nb) <= int(m)
            src, m, _rl, _rr, alphabet, overflow = et.round_body(src, m, alphabet)
            assert not bool(overflow)
            src = torch.cat([src, torch.zeros_like(src)])  # keep the padded size: round_body halves it


def test_a_round_whose_blocks_do_not_fit_raises(monkeypatch):
    """A planted adjust pass that leaves every symbol its own block: the
    round sets its overflow flag, and both entries raise (nothing reruns on
    the host)."""
    def one_symbol_blocks(lens, typs, nb):
        size = lens.shape[0]
        m = int(lens.sum())
        i = torch.arange(size)
        return (i < m).to(torch.int32), torch.where(i < m, 2, 0).to(torch.int32), torch.tensor(m, dtype=torch.int32)

    monkeypatch.setattr(et, "adjust_pass", one_symbol_blocks)
    data = np.frombuffer(_english_like(4096), np.uint8)
    with pytest.raises(RuntimeError, match="size // 2"):
        et.esp_round_device(data[:16].astype(np.uint32), 256, CPU)
    with pytest.raises(RuntimeError, match="size // 2"):
        et.esp_grammar_device(data, threshold=256, device=CPU)


def test_grammar_small_inputs_take_the_host_rounds():
    for data in (b"", b"a", b"ab", b"aaa", b"abc" * 700):
        arr = np.frombuffer(data, np.uint8)
        want = jax_generate_grammar(arr)
        got = et.esp_grammar_device(arr, threshold=1 << 10, device=CPU)
        assert np.array_equal(want[0], got[0]) and want[1:] == got[1:]


def _random_blocks(rng, n: int, p_one: float):
    lens = rng.choice([1, 2, 3], n, p=[p_one, (1 - p_one) / 2, (1 - p_one) / 2])
    typs = rng.integers(1, 4, n)
    return [[int(a), int(b)] for a, b in zip(lens, typs)]


def _adjust_torch(blocks, pad: int = 5):
    """The port's adjust pass on a block list (padded past nb with zeros)."""
    size = len(blocks) + pad
    lens = torch.zeros(size, dtype=torch.int32)
    typs = torch.zeros(size, dtype=torch.int32)
    if blocks:
        arr = torch.tensor(blocks, dtype=torch.int32)
        lens[: len(blocks)], typs[: len(blocks)] = arr[:, 0], arr[:, 1]
    nb = torch.tensor(len(blocks), dtype=torch.int32)
    ws, we, ns = et.adjust_spans(lens, nb)
    out_l, out_t, out_nb = et.adjust_pass(lens, typs, nb)
    k = int(out_nb)
    assert not out_l[k:].any()
    return [[int(a), int(b)] for a, b in zip(out_l[:k], out_t[:k])], (we - ws)[: int(ns)]


@pytest.mark.parametrize("p_one", [0.05, 0.3, 0.7, 1.0])
def test_queue_machine_matches_the_host(p_one):
    rng = np.random.default_rng(int(p_one * 100))
    widest = 0
    for trial in range(12):
        blocks = _random_blocks(rng, int(rng.integers(1, 600)), p_one)
        got, widths = _adjust_torch(blocks)
        want = esp._adjust_blocks([list(b) for b in blocks])
        assert got == want
        assert got == jax_adjust_blocks([list(b) for b in blocks])
        widest = max(widest, int(widths.max()) if len(widths) else 0)
    if p_one >= 0.3:
        assert widest > 128  # past the JAX package's widest lane, which would fall back


EDGE_SPANS = torch_cases.esp_edge_spans()


@pytest.mark.parametrize("case", sorted(EDGE_SPANS))
def test_kernel_i_edge_spans(case):
    lens, typs, ws, we, ns = EDGE_SPANS[case]
    got_l, got_t = lens.clone(), typs.clone()
    esp_adjust_windows(got_l, got_t, ws, we, ns)  # in place; the plain version on the CPU
    want_l, want_t = lens.clone(), typs.clone()
    esp_adjust_windows_plain(want_l, want_t, ws, we, ns)
    assert torch.equal(got_l, want_l) and torch.equal(got_t, want_t)
    # each span's blocks are the host queue's over the span's slice
    for a, b in zip(ws[: int(ns)].tolist(), we[: int(ns)].tolist()):
        want = esp._adjust_blocks([[int(x), int(y)] for x, y in zip(lens[a:b], typs[a:b])])
        got = [[int(x), int(y)] for x, y in zip(got_l[a:b], got_t[a:b]) if x > 0]
        assert got == want
        assert not got_l[a + len(want):b].any()
    outside = torch.ones(len(lens), dtype=torch.bool)
    for a, b in zip(ws[: int(ns)].tolist(), we[: int(ns)].tolist()):
        outside[a:b] = False
    assert torch.equal(got_l[outside], lens[outside]) and torch.equal(got_t[outside], typs[outside])


def _queue(L: list, T: list, a: int, n: int) -> None:
    """csrc/esp.cu:adjust_span over L[a:a + n], T[a:a + n], in place: the
    first three fills, then a merge or a pop and at most one fill a pass."""
    qn = ip = min(n, 3)
    q = [[L[a + j], T[a + j]] for j in range(qn)] + [[0, 0]] * (3 - qn)
    (l0, t0), (l1, t1), (l2, t2) = q
    op = 0
    while qn > 0:
        merged = False
        if l0 == 1 or (qn > 1 and l1 == 1) or (qn > 2 and l2 == 1):
            if qn == 3 and (l1 == 1 or l2 == 1) and t1 == 2 and t2 == 2:
                if l1 + l2 <= 3:
                    l1, t1, qn = l1 + l2, 2, 2
                else:
                    l1 = l2 = t1 = t2 = 2
                merged = True
            elif qn >= 2 and (l0 == 1 or l1 == 1):
                mt = 2 if (t0 == 2 and t1 == 2) else 3 if t0 == 3 else 1 if (t0 == 1 or t1 == 1) else 0
                if mt:
                    if l0 + l1 <= 3:
                        l0, t0, l1, t1, qn = l0 + l1, mt, l2, t2, qn - 1
                    else:
                        l0, l1, t0, t1 = 2, 2, mt, mt
                    merged = True
        if not merged:
            L[a + op], T[a + op] = l0, t0
            op += 1
            l0, t0, l1, t1, qn = l1, t1, l2, t2, qn - 1
        if qn < 3 and ip < n:
            bl, bt = L[a + ip], T[a + ip]
            if qn == 0:
                l0, t0 = bl, bt
            elif qn == 1:
                l1, t1 = bl, bt
            else:
                l2, t2 = bl, bt
            qn, ip = qn + 1, ip + 1
    for j in range(op, n):
        L[a + j] = 0


def _kernel_i_warps(lens, typs, ws, we, ns):
    """Kernel I's warps (csrc/esp.cu: esp_adjust_staged_kernel), lane by
    lane: each group of 32 spans staged into a buffer through the warp's
    inclusive scan of the widths up to SLOT and a binary search over it,
    the lanes' machines run there (the others' in place), written back the
    same way. Returns the adjusted (lens, typs) as lists."""
    L, T = lens.tolist(), typs.tolist()
    live = min(int(ns[0]), len(ws))
    for g in range(0, live, 32):
        a = [int(ws[s]) if s < live else 0 for s in range(g, g + 32)]
        width = [int(we[s]) - a[k] if g + k < live else 0 for k, s in enumerate(range(g, g + 32))]
        narrow = [w if w <= SLOT else 0 for w in width]
        incl = np.cumsum(narrow).tolist()
        staged = [narrow[k] > 0 and incl[k] <= CAP for k in range(32)]
        total = max([incl[k] for k in range(32) if staged[k]], default=0)
        at = []
        for f in range(total):
            k = 0
            for step in (16, 8, 4, 2, 1):
                if incl[k + step - 1] <= f:
                    k += step
            assert staged[k]
            at.append(a[k] + f - (incl[k] - narrow[k]))
        bl, bt = [L[x] for x in at], [T[x] for x in at]
        for k in range(32):
            if staged[k]:
                _queue(bl, bt, incl[k] - narrow[k], width[k])
            elif width[k] > 0:
                _queue(L, T, a[k], width[k])
        for f, x in enumerate(at):
            L[x], T[x] = bl[f], bt[f]
    return L, T


@pytest.mark.parametrize("case", sorted(EDGE_SPANS))
def test_kernel_i_warp_model(case):
    lens, typs, ws, we, ns = EDGE_SPANS[case]
    want_l, want_t = lens.clone(), typs.clone()
    esp_adjust_windows_plain(want_l, want_t, ws, we, ns)
    got_l, got_t = _kernel_i_warps(lens, typs, ws, we, ns)
    assert got_l == want_l.tolist() and got_t == want_t.tolist()


def test_kernel_i_warp_model_on_a_round():
    """The model on the spans of the first device round of 64 KiB of a
    4-letter text (1728 spans)."""
    data = np.random.default_rng(1).integers(0, 4, 1 << 16).astype(np.uint8)
    size = 1 << 16
    src = et.padded(data, size, CPU)
    lens, typs, nb = et.stage_blocks(src, torch.tensor(len(data), dtype=torch.int32), torch.tensor(256, dtype=torch.int32))
    ws, we, ns = et.adjust_spans(lens, nb)
    assert int(ns[0]) > 64
    want_l, want_t = lens.clone(), typs.clone()
    esp_adjust_windows_plain(want_l, want_t, ws, we, ns)
    got_l, got_t = _kernel_i_warps(lens, typs, ws, we, ns)
    assert got_l == want_l.tolist() and got_t == want_t.tolist()


def test_kernel_i_staging_limits_match_esp_cu():
    src = open(os.path.join(os.path.dirname(et.__file__), "..", "csrc", "esp.cu")).read()
    assert re.search(rf"constexpr int SLOT = {SLOT};", src) and re.search(rf"constexpr int CAP = {CAP};", src)
    assert SLOT * 32 > CAP  # a warp of wide spans overflows: the model's cases reach past CAP


def test_kernel_i_wrapper_checks_its_inputs():
    lens, typs, ws, we, ns = EDGE_SPANS["width 8"]
    with pytest.raises(ValueError):
        esp_adjust_windows(lens.long(), typs, ws, we, ns)
    with pytest.raises(ValueError):
        esp_adjust_windows(lens, typs, ws, we[:-1], ns)
    with pytest.raises(ValueError):  # adjusted in place: a strided view is refused
        esp_adjust_windows(lens.repeat(2)[::2], typs, ws, we, ns)


def _lis_python(y) -> list:
    """The JAX package's _lis_indices loop (compressors/esp_dcoding.py:296),
    copied: patience sorting with predecessor links."""
    n = len(y)
    if n == 0:
        return []
    tails, tails_idx, prev = [], [], [-1] * n
    for i, val in enumerate(np.asarray(y).tolist()):
        j = bisect_left(tails, val)
        if j == len(tails):
            tails.append(val)
            tails_idx.append(i)
        else:
            tails[j] = val
            tails_idx[j] = i
        prev[i] = tails_idx[j - 1] if j > 0 else -1
    chain, k = [], tails_idx[-1]
    while k != -1:
        chain.append(k)
        k = prev[k]
    return chain[::-1]


def _lis_inputs():
    rng = np.random.default_rng(21)
    perms = [rng.permutation(n) for n in (2, 3, 10, 100, 1000, 5000)]
    return {
        "empty": np.zeros(0, np.int64),
        "one": np.array([5], np.int64),
        "increasing": np.arange(300),
        "decreasing": np.arange(300)[::-1].copy(),
        **{f"permutation {len(p)}": p for p in perms},
        **{f"negated permutation {len(p)}": -p for p in perms},
        "sparse values": rng.choice(1 << 40, 2000, replace=False),
    }


LIS_INPUTS = _lis_inputs()


@pytest.mark.parametrize("name", sorted(LIS_INPUTS))
def test_lis_indices_cpp_matches_the_loop(name):
    y = np.asarray(LIS_INPUTS[name], np.int64)
    assert native.get_lib() is not None
    want = _lis_python(y)
    assert _lis_indices(y) == want


def test_lis_indices_python_path_matches(monkeypatch):
    y = LIS_INPUTS["permutation 1000"]
    want = _lis_indices(y)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert _lis_indices(y) == want


def test_optimal_subseq_takes_the_same_chains():
    """SubSeqOptimal's rounds of increasing/decreasing extraction give the
    same decomposition with the C++ LIS as with the loop."""
    sis = np.random.default_rng(8).permutation(3000)
    dpi, b = SubSeqOptimal(None).create_dpi_and_b(sis)
    # the loop: the same rounds with the Python copy
    alive, want_dpi, want_b = np.arange(len(sis)), np.zeros(len(sis), np.int64), []
    while len(alive):
        inc, dec = _lis_python(sis[alive]), _lis_python(-sis[alive])
        chosen, bit = (inc, 0) if len(inc) >= len(dec) else (dec, 1)
        want_dpi[alive[chosen]] = len(want_b)
        want_b.append(bit)
        alive = np.delete(alive, chosen)
    assert np.array_equal(dpi, want_dpi) and b.tolist() == want_b


@pytest.mark.parametrize(
    "env,device,n,want",
    [
        (None, "cpu", 1 << 30, False),
        (None, "cuda", tdev.ESP_MIN_N, True),
        (None, "cuda", tdev.ESP_MIN_N - 1, False),
        ("1", "cpu", 10, True),
        ("0", "cpu", 1 << 30, False),
    ],
)
def test_esp_gate(env, device, n, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("TDC_DEVICE_ESP", raising=False)
    else:
        monkeypatch.setenv("TDC_DEVICE_ESP", env)
    assert tdev.use_esp_device(n, torch.device(device)) is want


def test_forced_device_rounds_through_the_driver(monkeypatch):
    """TDC_DEVICE_ESP=1 on the CPU sends esp's grammar to the device rounds
    (plain versions); the container is the host path's."""
    from tudocomp_tpu_torch.driver import compress, decompress

    data = _english_like(1 << 17)
    monkeypatch.setenv("TDC_DEVICE_ESP", "0")
    want = compress("esp(slp_coder=sorted(d_coding=arith))", data, device="cpu")
    monkeypatch.setenv("TDC_DEVICE_ESP", "1")
    calls = []
    real = et.esp_grammar_device
    monkeypatch.setattr(esp, "esp_grammar_device", lambda *a, **k: calls.append(1) or real(*a, **k))
    assert compress("esp(slp_coder=sorted(d_coding=arith))", data, device="cpu") == want
    assert calls
    assert decompress(want, device="cpu") == data


@pytest.mark.parametrize("case", ["empty", "zero", "63", "64", "mixed", "small", "large"])
def test_write_unaries_matches_the_jax_package(case):
    """The port's vectorized unary write (64-bit zero tokens past 63) writes
    the JAX package's bits, which read back."""
    from tudocomp_tpu.io.bitio import BitWriter as JaxBitWriter
    from tudocomp_tpu_torch.io.bitio import BitReader, BitWriter

    rng = np.random.default_rng(3)
    values = {"empty": [], "zero": [0], "63": [63], "64": [64], "mixed": [127, 128, 0, 1000, 5],
              "small": rng.integers(0, 64, 3000), "large": rng.integers(0, 700, 3000)}[case]
    want, got = JaxBitWriter(), BitWriter()
    for w in (want, got):
        w.write_int(5, 3)
        w.write_unaries(values)
        w.write_int(1, 1)
    assert got.getvalue() == want.getvalue()
    r = BitReader(got.getvalue())
    assert r.read_int(3) == 5
    assert r.read_unaries(len(values)).tolist() == list(np.asarray(values, np.int64))
