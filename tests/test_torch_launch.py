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
    word is used and waited for, and tensors on two cards raise.
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
    monkeypatch.setattr(kernels, "_counts", {name: 0 for name, _ in kernels.KERNELS.values()})
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
