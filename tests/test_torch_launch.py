"""The port's launch path (tudocomp_tpu_torch/kernels.py) without a card.

Two kinds of checks, each case its own test:
  - static: every `extern "C"` function named tdc_* in
    tudocomp_tpu_torch/csrc/*.cu is declared in kernels.py with as many
    argument types as it has parameters. A launcher returns int, takes the
    stream last and sits in kernels.KERNELS; a host helper sits in
    kernels.HELPERS. Every entry of either has its function in a source;
  - kernels.launch and kernels.launch_flagged against a fake library put in
    place of the built one: the stream goes last, a launch counts once, a
    nonzero return raises RuntimeError and is not counted, the library is
    loaded once and no lock is taken after that, and the flag word is
    zeroed before the launch and read after one wait on the stream, with
    two threads on one device each reading their own launch's word;
  - the device a launch runs on, with torch's device accessors replaced by
    stand-ins and tensors that say they lie on card 1 while card 0 is
    current: the stream of card 1 is passed, card 1 is current for the
    call and card 0 again after it (also after an error), card 1's flag
    word is used and waited for, and tensors on two cards raise;
  - probes.rmw_loop8 against the fake: a row shorter than its 384-word
    window raises IndexError before any launch, a whole one launches
    once through kernels.launch, with no flag word and no stream wait;
  - probes.window_rmw and probes.var_shift against the fake: an empty i
    or a row of 383 words raises IndexError before any launch, a good i
    launches once through kernels.launch_flagged; a tile launches once
    through kernels.launch;
  - probes.onehot_count and probes.broadcast_last_lane against the fake:
    a tile launches once through kernels.launch with a 16-byte-aligned
    contiguous tile of its values (the wrapper's copy where the tile is off
    a bound or transposed); a [16, 128] tile launches nothing;
  - the four probe8 wrappers on empty inputs: no rows (B = 0) give empty
    tensors and launch nothing, rows of no tile (T = 0) launch once.
The `cuda` tests at the end need a card and skip here:

    python -m pytest tests/test_torch_launch.py -q             # here
    python -m pytest tests/test_torch_launch.py -m cuda -q     # on the card
"""

import ctypes
import glob
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from tudocomp_tpu_torch import kernels

CSRC = os.path.join(os.path.dirname(os.path.abspath(kernels.__file__)), "csrc")
_DECL = re.compile(r'extern "C"\s+([\w\s\*]+?)\s*\b(tdc_\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _declared():
    """name -> (result type, parameter names) of every tdc_* function of csrc/*.cu."""
    out = {}
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        for ret, name, params in _DECL.findall(open(path).read()):
            names = [p.split()[-1].lstrip("*") for p in params.split(",") if p.strip()]
            out[name] = (ret.strip(), names)
    return out


DECLARED = _declared()


@pytest.mark.parametrize("name", sorted(DECLARED))
def test_every_source_function_is_declared(name):
    ret, params = DECLARED[name]
    if ret == "int" and name in kernels.KERNELS:
        assert params[-1] == "stream", params
        assert len(kernels.KERNELS[name][1]) == len(params), (name, params)
    else:
        assert name in kernels.HELPERS, f"{name} ({ret}) is neither a launcher nor a helper"
        assert len(kernels.HELPERS[name][1]) == len(params), (name, params)


@pytest.mark.parametrize("name", sorted({**kernels.KERNELS, **kernels.HELPERS}))
def test_every_declared_function_has_a_source(name):
    assert name in DECLARED


class _FakeFn:
    def __init__(self, rc=0, effect=None):
        self.rc, self.effect, self.calls = rc, effect, []

    def __call__(self, *args):
        self.calls.append(args)
        if self.effect:
            self.effect(*args)
        return self.rc


class _FakeLib:
    def __init__(self):
        self.word = ctypes.c_int32(7)  # not zero: the path must zero it
        self.fns = {name: _FakeFn() for name in {**kernels.KERNELS, **kernels.HELPERS}}
        self.fns["tdc_mapped_word"] = _FakeFn(effect=self._map)
        self.fns["tdc_mapped_word"].rc = ctypes.addressof(self.word)

    def _map(self, device, dptr):
        dptr._obj.value = 0xD000 + device  # dptr is ctypes.byref(c_void_p)

    def __getattr__(self, name):
        return self.__dict__["fns"][name]


class _CountingLock:
    def __init__(self):
        self.taken = 0

    def __enter__(self):
        self.taken += 1

    def __exit__(self, *exc):
        return False


STREAMS = {0: 0xABC, 1: 0xDEF}  # each card's current stream


class _Cards:
    """Stand-ins for torch._C's device accessors: card 0 current at first."""

    def __init__(self):
        self.current, self.switches = 0, []

    def get(self):
        return self.current

    def stream(self, device):
        return STREAMS[device]

    def exchange(self, device):
        prev, self.current = self.current, device
        self.switches.append(device)
        return prev


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on CUDA card `card`."""

    card = 1

    @property
    def device(self):
        return torch.device("cuda", self.card)

    def get_device(self):
        return self.card


def _on_card(t, card):
    t = t.as_subclass(_OnCard)
    t.card = card
    return t


def _card1(t):
    return _on_card(t, 1)


@pytest.fixture
def fake(monkeypatch):
    """A fake library behind kernels.launch; card 0 is current, its stream 0xABC."""
    lib = _FakeLib()
    loads = []
    lock = _CountingLock()
    cards = _Cards()
    monkeypatch.setattr(kernels, "build", lambda: "fake.so")
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: loads.append(path) or lib)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", cards.get, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", cards.stream, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_exchangeDevice", cards.exchange, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_maybeExchangeDevice", cards.exchange, raising=False)
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "_fns", {})
    monkeypatch.setattr(kernels, "_flags", {})
    monkeypatch.setattr(kernels, "_lock", lock)
    kernels.reset_counts()  # the launch counters live in the port's counter registry
    lib.loads, lib.lock, lib.cards = loads, lock, cards
    return lib


def _case_stream_last(lib):
    x, o = torch.zeros(8, 128, dtype=torch.int32), torch.zeros(8, 128, dtype=torch.int32)
    kernels.launch("tdc_probe6_roll_lane", x, o)
    assert lib.tdc_probe6_roll_lane.calls == [(x.data_ptr(), o.data_ptr(), 0xABC)]
    kernels.launch("tdc_probe3_gather", x, x, o, 8, 128, 128, None, 5)
    assert lib.tdc_probe3_gather.calls[0][-3:] == (None, 5, 0xABC)
    assert lib.cards.switches == []  # tensors off the card: the current device, no switch


def _case_counts_once(lib):
    kernels.launch("tdc_probe6_roll_lane", 1, 2)
    assert kernels.counts()["probe6_roll_lane"] == 1
    assert sum(kernels.counts().values()) == 1
    kernels.reset_counts()
    assert sum(kernels.counts().values()) == 0


def _case_error_not_counted(lib):
    lib.tdc_probe6_roll_lane.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernels.launch("tdc_probe6_roll_lane", 1, 2)
    assert kernels.counts()["probe6_roll_lane"] == 0


def _case_loaded_once(lib):
    for _ in range(100):
        kernels.launch("tdc_probe6_roll_sublane", 1, 2)
        kernels.launch("tdc_plcp_segments", 1, 2, 3, 4, 5)
    assert lib.loads == ["fake.so"]
    assert lib.lock.taken == 1  # the load; no launch takes the lock after it
    assert kernels.counts()["probe6_roll_sublane"] == 100
    assert lib.tdc_probe6_roll_sublane.argtypes == kernels.KERNELS["tdc_probe6_roll_sublane"][1]


def _case_flag_read_after_wait(lib):
    order, report = [], [1]

    def kernel(*args):
        assert lib.word.value == 0  # zeroed on the host before the launch
        assert args[-2] == 0xD000  # the flag's device address, before the stream
        order.append("launch")
        lib.word.value = report[0]

    lib.fns["tdc_probe6_rmw"] = _FakeFn(effect=kernel)
    lib.fns["tdc_stream_wait"] = _FakeFn(effect=lambda s: order.append(("wait", s)))
    assert kernels.launch_flagged("tdc_probe6_rmw", 1, 2, 3) == 1
    assert order == ["launch", ("wait", 0xABC)]
    report[0] = 0
    assert kernels.launch_flagged("tdc_probe6_rmw", 1, 2, 3) == 0  # a later call starts clean
    assert len(lib.tdc_mapped_word.calls) == 1  # one word per device
    assert kernels.counts()["probe6_rmw"] == 2


def _case_flagged_error_raises(lib):
    lib.fns["tdc_stream_wait"].rc = 719
    with pytest.raises(RuntimeError, match="CUDA error 719"):
        kernels.launch_flagged("tdc_probe6_rmw", 1, 2, 3)


def _case_flag_two_threads(lib):
    # thread t's kernel reports t; the wait yields, so without the per-device
    # lock the other thread zeroes or sets the word between a launch and its read
    def kernel(*args):
        lib.word.value = args[0]

    lib.fns["tdc_probe6_rmw"] = _FakeFn(effect=kernel)
    lib.fns["tdc_stream_wait"] = _FakeFn(effect=lambda s: time.sleep(0.0002))
    kernels.launch_flagged("tdc_probe6_rmw", 0, 2, 3)  # the word, mapped before the threads start
    got = {0: [], 1: []}
    start = threading.Barrier(2)

    def run(t):
        start.wait()
        for _ in range(50):
            got[t].append(kernels.launch_flagged("tdc_probe6_rmw", t, 2, 3))

    threads = [threading.Thread(target=run, args=(t,)) for t in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert got == {0: [0] * 50, 1: [1] * 50}
    assert len(lib.tdc_mapped_word.calls) == 1


CASES = {
    "stream last": _case_stream_last,
    "counts once": _case_counts_once,
    "error not counted": _case_error_not_counted,
    "loaded once, no lock after": _case_loaded_once,
    "flag zeroed, read after the wait": _case_flag_read_after_wait,
    "flagged wait error raises": _case_flagged_error_raises,
    "flag word, two threads": _case_flag_two_threads,
}


@pytest.mark.parametrize("case", list(CASES))
def test_launch_against_a_fake_library(fake, case):
    CASES[case](fake)


def _case_stream_of_card1(lib):
    seen = []
    lib.fns["tdc_probe6_roll_lane"] = _FakeFn(effect=lambda *a: seen.append(lib.cards.current))
    x, o = _card1(torch.zeros(8, 128, dtype=torch.int32)), _card1(torch.zeros(8, 128, dtype=torch.int32))
    kernels.launch("tdc_probe6_roll_lane", x, o, 3)
    assert lib.tdc_probe6_roll_lane.calls == [(x.data_ptr(), o.data_ptr(), 3, STREAMS[1])]
    assert seen == [1]  # card 1 current during the call
    assert lib.cards.current == 0 and lib.cards.switches == [1, 0]
    assert kernels.counts()["probe6_roll_lane"] == 1


def _case_restored_after_an_error(lib):
    lib.tdc_probe6_roll_lane.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kernels.launch("tdc_probe6_roll_lane", _card1(torch.zeros(4)), 2)
    assert lib.cards.current == 0 and lib.cards.switches == [1, 0]
    assert kernels.counts()["probe6_roll_lane"] == 0


def _case_flag_of_card1(lib):
    order = []

    def kernel(*args):
        assert args[-2] == 0xD001  # card 1's flag word
        order.append(("launch", lib.cards.current))
        lib.word.value = 1

    lib.fns["tdc_probe6_rmw"] = _FakeFn(effect=kernel)
    lib.fns["tdc_stream_wait"] = _FakeFn(effect=lambda s: order.append(("wait", s, lib.cards.current)))
    assert kernels.launch_flagged("tdc_probe6_rmw", _card1(torch.zeros(1, dtype=torch.int32)), 2, 3) == 1
    assert [c[0] for c in lib.tdc_mapped_word.calls] == [1]
    assert order == [("launch", 1), ("wait", STREAMS[1], 1)]
    assert lib.cards.current == 0


def _case_two_cards_raise(lib):
    with pytest.raises(ValueError, match="CUDA devices 1 and 0"):
        kernels.launch("tdc_probe6_roll_lane", _card1(torch.zeros(4)), _on_card(torch.zeros(4), 0))
    with pytest.raises(ValueError, match="CUDA devices 0 and 1"):
        kernels.launch_flagged("tdc_probe6_rmw", _on_card(torch.zeros(4), 0), _card1(torch.zeros(4)), 3)
    assert lib.tdc_probe6_roll_lane.calls == [] and lib.tdc_probe6_rmw.calls == []
    assert lib.cards.switches == [] and sum(kernels.counts().values()) == 0


DEVICE_CASES = {
    "card 1's stream, card 1 current for the call": _case_stream_of_card1,
    "card 0 restored after an error": _case_restored_after_an_error,
    "card 1's flag word and stream wait": _case_flag_of_card1,
    "tensors on two cards raise": _case_two_cards_raise,
}


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_launch_on_the_tensors_device(fake, case):
    DEVICE_CASES[case](fake)


def _calls(lib):
    """Every call the fake library took, by function name."""
    return [name for name, fn in lib.fns.items() for _ in fn.calls]


@pytest.mark.parametrize("n_wp", [383, 384])
def test_rmw_loop8_launch_against_a_fake_library(fake, monkeypatch, n_wp):
    """probes.rmw_loop8 on a card tensor: a row shorter than the window
    raises IndexError before any launch; a whole one launches
    tdc_probe8_d once through kernels.launch, with no flag word and no
    stream wait."""
    from tudocomp_tpu_torch import probes

    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None, device=None: _on_card(
        real_empty(shape, dtype=dtype), device.index))
    v = _on_card(torch.ones((2, 3, 8, 128), dtype=torch.int32), 0)
    if n_wp < probes.WIN:
        with pytest.raises(IndexError, match="window outside the row"):
            probes.rmw_loop8(v, n_wp)
        assert _calls(fake) == [] and kernels.counts()["probe8_d"] == 0
        return
    words, carry = probes.rmw_loop8(v, n_wp)
    assert words.shape == (2, 1, n_wp) and carry.shape == (2,)
    assert fake.tdc_probe8_d.calls == [(v.data_ptr(), 2, 3, n_wp, words.data_ptr(), carry.data_ptr(), 0xABC)]
    assert fake.tdc_mapped_word.calls == [] and fake.tdc_stream_wait.calls == []
    assert kernels.counts()["probe8_d"] == 1


@pytest.mark.parametrize("case", ["empty i", "n_words 383", "i 300"])
def test_window_rmw_launch_against_a_fake_library(fake, monkeypatch, case):
    """probes.window_rmw on a card tensor: an empty i, or a row of 383
    words that no window fits, raises IndexError before any launch (no
    call, no count); a good i launches tdc_probe6_rmw once through
    kernels.launch_flagged (the card's flag word, one stream wait)."""
    from tudocomp_tpu_torch import probes

    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None, device=None: _on_card(
        real_empty(shape, dtype=dtype), device.index))
    i = _card1(torch.zeros(0, dtype=torch.int32) if case == "empty i" else torch.tensor([[300]], dtype=torch.int32))
    n_words = 383 if case == "n_words 383" else 1152
    if case != "i 300":
        with pytest.raises(IndexError):
            probes.window_rmw(i, n_words)
        assert _calls(fake) == [] and kernels.counts()["probe6_rmw"] == 0
        return
    out = probes.window_rmw(i, n_words)
    assert out.shape == (1, 1, 1152) and out.get_device() == 1
    assert fake.tdc_probe6_rmw.calls == [(i.data_ptr(), out.data_ptr(), 1152, 0xD001, STREAMS[1])]
    assert [c[0] for c in fake.tdc_mapped_word.calls] == [1]
    assert fake.tdc_stream_wait.calls == [(STREAMS[1],)]
    assert kernels.counts()["probe6_rmw"] == 1


def test_var_shift_launch_against_a_fake_library(fake, monkeypatch):
    """probes.var_shift on a card tile launches tdc_probe6_shift once
    through kernels.launch: no flag word, no stream wait."""
    from tudocomp_tpu_torch import probes

    real_empty_like = torch.empty_like
    monkeypatch.setattr(torch, "empty_like", lambda x: _on_card(real_empty_like(x), x.get_device()))
    x = _card1(torch.arange(1024, dtype=torch.int32).reshape(8, 128))
    out = probes.var_shift(x)
    assert out.shape == (8, 128) and out.get_device() == 1
    assert fake.tdc_probe6_shift.calls == [(x.data_ptr(), out.data_ptr(), STREAMS[1])]
    assert fake.tdc_mapped_word.calls == [] and fake.tdc_stream_wait.calls == []
    assert kernels.counts()["probe6_shift"] == 1


TILE_WRAPPERS = {"tdc_probe6_dot3": "onehot_count", "tdc_probe6_bid": "broadcast_last_lane",
                 "tdc_probe6_extract": "scalar_extract"}


@pytest.mark.parametrize("layout", ["contiguous", "one word off a bound", "transposed", "[16, 128]"])
@pytest.mark.parametrize("fn", sorted(TILE_WRAPPERS))
def test_tile_launch_against_a_fake_library(fake, monkeypatch, fn, layout):
    """probes.onehot_count, probes.broadcast_last_lane and
    probes.scalar_extract on a card tile launch their kernel once through kernels.launch (no flag word, no
    stream wait) with a 16-byte-aligned contiguous tile of the same values:
    the tile itself, or the wrapper's copy of a tile off a bound or
    transposed. A [16, 128] tile raises ValueError and launches nothing."""
    from tudocomp_tpu_torch import probes

    real_empty_like = torch.empty_like
    monkeypatch.setattr(torch, "empty_like", lambda x: _on_card(real_empty_like(x), x.get_device()))
    values = torch.arange(1024, dtype=torch.int32).reshape(8, 128) * 7919 - 3000
    if layout == "[16, 128]":
        with pytest.raises(ValueError):
            getattr(probes, TILE_WRAPPERS[fn])(_card1(torch.zeros((16, 128), dtype=torch.int32)))
        assert _calls(fake) == [] and kernels.counts()[kernels.KERNELS[fn][0]] == 0
        return
    if layout == "one word off a bound":
        x = torch.empty(1025, dtype=torch.int32)[1:].view(8, 128).copy_(values)
        assert x.data_ptr() % 16
    elif layout == "transposed":
        x = values.t().contiguous().t()
    else:
        x = values
    x = _card1(x)
    seen = []
    getattr(fake, fn).effect = lambda xp, op, stream: seen.append(
        np.ctypeslib.as_array((ctypes.c_int32 * 1024).from_address(xp)).copy())
    out = getattr(probes, TILE_WRAPPERS[fn])(x)
    assert out.shape == (8, 128) and out.get_device() == 1
    ((xp, op, stream),) = getattr(fake, fn).calls
    assert op == out.data_ptr() and stream == STREAMS[1]
    assert xp % 16 == 0 and op % 16 == 0 and (xp == x.data_ptr()) == (layout == "contiguous")
    np.testing.assert_array_equal(seen[0], values.reshape(-1).numpy())  # the tile's values, row-major
    assert fake.tdc_mapped_word.calls == [] and fake.tdc_stream_wait.calls == []
    assert kernels.counts()[kernels.KERNELS[fn][0]] == 1


P8_WRAPPERS = {"tdc_probe8_a": "carry_revisit", "tdc_probe8_b": "carry_scans",
               "tdc_probe8_c": "carry_into_vector", "tdc_probe8_d": "rmw_loop8"}


@pytest.mark.parametrize("shape", [(0, 3), (2, 0)], ids=["B = 0", "T = 0"])
@pytest.mark.parametrize("fn", sorted(P8_WRAPPERS))
def test_probe8_empty_inputs_against_a_fake_library(fake, monkeypatch, fn, shape):
    """A probe8 wrapper on a card tensor with no rows returns empty tensors
    and launches nothing (no call, no count); with rows of no tile it
    launches its kernel once, which zeroes the arena."""
    from tudocomp_tpu_torch import probes

    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None, device=None: _on_card(
        real_empty(shape, dtype=dtype), device.index))
    v = _on_card(torch.zeros((*shape, 8, 128), dtype=torch.int32), 0)
    B = shape[0]
    words, carry = getattr(probes, P8_WRAPPERS[fn])(v, 1664)
    assert words.shape == (B, 1, 1664) and carry.shape == (B,)
    name = kernels.KERNELS[fn][0]
    if B == 0:
        assert _calls(fake) == [] and kernels.counts()[name] == 0
        return
    assert getattr(fake, fn).calls == [(v.data_ptr(), B, 0, 1664, words.data_ptr(), carry.data_ptr(), 0xABC)]
    assert kernels.counts()[name] == 1


# ---- on the card ------------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_stream_handle_follows_the_current_stream(dev):
    from tudocomp_tpu_torch import probes

    assert kernels._stream(0) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (8, 128)).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        assert kernels._stream(0) == side.cuda_stream
        got = probes.roll_lane(x)
        S, idx = probes.gather_cases(dev)["odd rows"]
        g = probes.gather(S, idx)  # waits on the side stream
    side.synchronize()
    assert torch.equal(got.cpu(), probes.roll_lane_plain(x).cpu())
    assert torch.equal(g.cpu(), probes.gather_plain(S, idx).cpu())
    assert kernels._stream(0) == torch.cuda.current_stream().cuda_stream
