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
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import tracemalloc
from typing import Any, Optional

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
    """Nested timing phase. Use as context manager or via StatPhase.wrap."""

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
        self.time_start = _now_ms()
        return self

    def __exit__(self, *exc) -> bool:
        self.time_end = _now_ms()
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
    def wrap(title: str, fn, *args, **kwargs):
        with StatPhase(title):
            return fn(*args, **kwargs)

    @staticmethod
    def current() -> Optional["StatPhase"]:
        return _get_current()

    def split(self, title: str) -> "StatPhase":
        """End-and-begin a sibling phase (StatPhase.hpp 'split')."""
        self.__exit__()
        nxt = StatPhase(title)
        nxt.__enter__()
        return nxt

    # -- custom stats ----------------------------------------------------------

    def log(self, key: str, value: Any) -> None:
        self.stats[str(key)[:64]] = value

    @staticmethod
    def log_current(key: str, value: Any) -> None:
        cur = _get_current()
        if cur is not None:
            cur.log(key, value)

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
