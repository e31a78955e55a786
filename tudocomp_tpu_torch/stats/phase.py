"""StatPhase: nested RAII-style phases with wall time + memory stats.

The port's copy of tudocomp_tpu/stats/phase.py (mirror of
include/tudocomp_stat/StatPhase.hpp:44-322 and PhaseData.hpp): a tree of
phases, each measuring wall-clock ms and heap deltas, with custom key/value
stats and JSON export in the schema consumed by tudocomp's Charter web app
(www/charter/): `to_dict` / `to_json` give a phase's PhaseData, and the
command line's --stats wraps the root's in the {meta, data} document.

Host memory (src/tudocomp_stat/malloc.cpp:24-84 gives the reference
per-phase heap off/current/peak via a malloc override): read from the
LD_PRELOAD malloc interposer (csrc/host/tdc_memhook.c) where it is preloaded
(the command line re-execs itself with it under TDC_MALLOC_HOOK=1), else
from tracemalloc, which sees Python's allocations and numpy's buffers only.
The command line turns it on for every --stats run; library use opts in
with TDC_TRACK_MEM=1 (tracemalloc taxes every allocation). Nested phases
propagate their absolute peak to ancestors so a parent's memPeak covers its
children even though either backend has a single global peak counter.

Device memory: with `StatPhase.track_device` set to a CUDA device (the
command line sets it to the card its run uses when --stats is given),
every phase adds the stats keys devMemOff, devMemPeak and devMemFinal:
the bytes of that card's tensors (torch.cuda.memory_allocated) when the
phase opens and when it closes (the JAX package's two keys, read from its
device), and the most the phase held above devMemOff
(torch.cuda.max_memory_allocated, its peak reset as the phase opens and
handed up to the parent). On the CPU the keys are absent: no phase claims
a number that was not taken.

Counters (stats/counters.py): a copy through device.py's funnel adds its
bytes and itself to the stats toHostBytes or toDeviceBytes, and copies, of
every phase open on its thread (`add_to_open`), so a phase that made no
such copy logs none of these keys and a phase costs nothing for them.
Fresh host memory, only where someone reads it (track_memory set, as by
--stats, or torch.profiler recording, as in the benchmark's traced run):
the process's resident set (/proc/self/statm) is read at every phase's
start and end, on any thread, and each growth between two readings while
a phase is open is added to the registry's `host.fresh_bytes` once,
however phases nest; a phase with a reading at both ends logs the growth
summed over its own stretch (hostFreshBytes). Otherwise a phase reads
nothing. The resident set, and
not the kernel's count of minor faults: some kernels (gVisor's) count
none, and under transparent huge pages one fault maps 2 MiB.

The device trace: while torch.profiler records, every phase also opens a
`record_function("tdc:" + title)` range and closes it with the phase, so
the exported trace holds the phases as `user_annotation` events on the
clock of the kernels and copies. With the profiler off no range is opened.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import tracemalloc
from typing import Any, Optional

from torch.autograd import profiler as _profiler

from . import counters

_LOG = logging.getLogger("tudocomp_tpu_torch.stats")

# the open-phase cursor is thread-local: phases opened on other threads
# form detached trees that are not aggregated into the main --stats output
_tls = threading.local()


def _get_current() -> Optional["StatPhase"]:
    return getattr(_tls, "current", None)


def _set_current(phase: Optional["StatPhase"]) -> None:
    _tls.current = phase


def _now_ms() -> float:
    return time.monotonic() * 1000.0


RANGE_PREFIX = "tdc:"  # the phases' ranges in a torch.profiler trace

_PAGE = os.sysconf("SC_PAGE_SIZE")
_statm = None  # fd of /proc/self/statm, -1 where there is none

# phases open in the process, on every thread; the resident set at the last
# phase boundary (-1 where that boundary took no reading); the growth summed
# over the stretches with a phase open and a reading at both ends
_fresh_lock = threading.Lock()
_open = 0
_resident_last = -1
_fresh_total = 0


def _resident() -> int:
    """The process's resident bytes, 0 where /proc/self/statm is missing.
    Called under _fresh_lock."""
    global _statm
    if _statm is None:
        try:
            _statm = os.open("/proc/self/statm", os.O_RDONLY)
        except OSError:
            _statm = -1
    if _statm < 0:
        return 0
    return int(os.pread(_statm, 128, 0).split()[1]) * _PAGE


def _forget_statm() -> None:
    global _statm
    _statm = None  # a forked child reopens: the fd names its parent


os.register_at_fork(after_in_child=_forget_statm)


def _boundary(opens: int) -> Optional[int]:
    """A phase opens (+1) or closes (-1). The resident set is read only
    where it is consumed, with --stats (track_memory) or under
    torch.profiler: then count its growth since the last boundary, if that
    one read it too and a phase was open, and return the running total of
    that growth; else return None."""
    global _open, _resident_last, _fresh_total
    read = StatPhase.track_memory or _profiler._is_profiler_enabled
    with _fresh_lock:
        now = _resident() if read else -1
        if _open > 0 and now > _resident_last >= 0:
            _fresh_total += now - _resident_last
            counters.add("host.fresh_bytes", now - _resident_last)
        _resident_last = now
        _open += opens
        return _fresh_total if read else None


def _ensure_tracing() -> bool:
    """Activate a heap-accounting backend: the preloaded interposer, else
    tracemalloc. Returns whether one is active."""
    if _memhook() is not None or tracemalloc.is_tracing():
        return True
    try:
        tracemalloc.start()
        return True
    except Exception:
        return False


_memhook_cache = None


def _memhook():
    global _memhook_cache
    if _memhook_cache is None:
        from .. import native

        _memhook_cache = native.memhook_counters() or False
    return _memhook_cache or None


def _mem_read():
    """(current_bytes, peak_bytes) from the active backend."""
    h = _memhook()
    if h is not None:
        return int(h[0]()), int(h[1]())
    return tracemalloc.get_traced_memory()


def _mem_reset_peak():
    h = _memhook()
    if h is not None:
        h[2]()
    else:
        tracemalloc.reset_peak()


def _mem_active() -> bool:
    return _memhook() is not None or tracemalloc.is_tracing()


def _dev_read(dev):
    """(bytes allocated, peak since the last reset) on the card `dev`."""
    import torch

    return torch.cuda.memory_allocated(dev), torch.cuda.max_memory_allocated(dev)


def _dev_reset_peak(dev) -> None:
    import torch

    torch.cuda.reset_peak_memory_stats(dev)


class StatPhase:
    """Nested timing phase, used as a context manager."""

    # host-heap tracking: on for the command line's --stats runs; force
    # with TDC_TRACK_MEM=1, forbid with =0
    track_memory = os.environ.get("TDC_TRACK_MEM", "0") == "1"
    # the CUDA device whose memory the phases read, or None
    track_device = None

    def __init__(self, title: str):
        self.title = title
        self.children: list[StatPhase] = []
        self.stats: dict[str, Any] = {}
        self.time_start = 0.0
        self.time_end = 0.0
        self.mem_off = 0
        self.mem_current = 0
        self.mem_peak = 0
        self._parent: Optional[StatPhase] = None
        self._abs_peak = 0
        self._tracing = False
        self._dev = None
        self._dev_off = 0
        self._dev_abs_peak = 0
        self._fresh = None
        self._range = None

    # -- lifecycle ------------------------------------------------------------

    def __enter__(self) -> "StatPhase":
        self._parent = _get_current()
        if self._parent is not None:
            self._parent.children.append(self)
        _set_current(self)
        if StatPhase.track_memory and _ensure_tracing():
            self._tracing = True
            cur, peak = _mem_read()
            # the open peak window belongs to the parent; hand it over
            # before resetting for this phase
            if self._parent is not None and self._parent._tracing:
                self._parent._abs_peak = max(self._parent._abs_peak, peak)
            _mem_reset_peak()
            self.mem_off = cur
            self._abs_peak = cur
        if StatPhase.track_device is not None:
            self._dev = StatPhase.track_device
            cur, peak = _dev_read(self._dev)
            if self._parent is not None and self._parent._dev is not None:
                self._parent._dev_abs_peak = max(self._parent._dev_abs_peak, peak)
            _dev_reset_peak(self._dev)
            self._dev_off = self._dev_abs_peak = cur
            self.stats["devMemOff"] = cur
        self._fresh = _boundary(1)
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(RANGE_PREFIX + self.title)
            self._range.__enter__()
        self.time_start = _now_ms()
        return self

    def __exit__(self, *exc) -> bool:
        self.time_end = _now_ms()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        fresh = _boundary(-1)
        if fresh is not None and self._fresh is not None and fresh > self._fresh:
            self.stats["hostFreshBytes"] = fresh - self._fresh
        if self._tracing and _mem_active():
            cur, peak = _mem_read()
            self._abs_peak = max(self._abs_peak, peak, cur)
            self.mem_current = cur - self.mem_off
            self.mem_peak = max(0, self._abs_peak - self.mem_off)
            if self._parent is not None and self._parent._tracing:
                self._parent._abs_peak = max(self._parent._abs_peak, self._abs_peak)
            # fresh window for whatever the parent does next
            _mem_reset_peak()
        if self._dev is not None:
            cur, peak = _dev_read(self._dev)
            self._dev_abs_peak = max(self._dev_abs_peak, peak, cur)
            self.stats["devMemPeak"] = max(0, self._dev_abs_peak - self._dev_off)
            self.stats["devMemFinal"] = cur
            if self._parent is not None and self._parent._dev is not None:
                self._parent._dev_abs_peak = max(self._parent._dev_abs_peak, self._dev_abs_peak)
            _dev_reset_peak(self._dev)
        _set_current(self._parent)
        # DVLOG analogue: per-phase timing at DEBUG (wired to --logverbosity)
        _LOG.debug("phase %r: %.3f ms", self.title, self.time_end - self.time_start)
        return False

    @staticmethod
    def current() -> Optional["StatPhase"]:
        return _get_current()

    @staticmethod
    def add_to_open(key: str, n: int) -> None:
        """Add n to stat `key` of the phase open on this thread and of
        every phase around it."""
        p = _get_current()
        while p is not None:
            p.stats[key] = p.stats.get(key, 0) + n
            p = p._parent

    def split(self, title: str) -> "StatPhase":
        """End-and-begin a sibling phase (StatPhase.hpp 'split')."""
        self.__exit__()
        nxt = StatPhase(title)
        nxt.__enter__()
        return nxt

    # -- custom stats ----------------------------------------------------------

    def log(self, key: str, value: Any) -> None:
        self.stats[str(key)[:64]] = value

    # -- export -----------------------------------------------------------------

    def to_dict(self) -> dict:
        """PhaseData JSON schema (PhaseData.hpp:66-111), Charter-compatible."""
        return {
            "title": self.title,
            "timeStart": self.time_start,
            "timeEnd": self.time_end,
            "memOff": self.mem_off,
            "memPeak": self.mem_peak,
            "memFinal": self.mem_current,
            "stats": [{"key": k, "value": str(v)} for k, v in self.stats.items()],
            "sub": [c.to_dict() for c in self.children],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
