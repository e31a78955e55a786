"""StatPhase: nested RAII-style phases with wall time and key/value stats.

The port's copy of tudocomp_tpu/stats/phase.py (mirror of
include/tudocomp_stat/StatPhase.hpp:44-322), trimmed to what the port's
compressors use: a tree of phases, each timing itself and holding the
stats its code logs, with the time logged at DEBUG. The JAX package's heap
and device-memory accounting and its JSON export are not carried over: the
port has no --stats output yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Optional

_LOG = logging.getLogger("tudocomp_tpu_torch.stats")

# the open-phase cursor is thread-local: phases opened on other threads
# form detached trees
_tls = threading.local()


class StatPhase:
    """Nested timing phase; use as a context manager."""

    def __init__(self, title: str):
        self.title = title
        self.children: list[StatPhase] = []
        self.stats: dict[str, Any] = {}
        self.time_start = 0.0
        self.time_end = 0.0
        self._parent: Optional[StatPhase] = None

    def __enter__(self) -> "StatPhase":
        self._parent = getattr(_tls, "current", None)
        if self._parent is not None:
            self._parent.children.append(self)
        _tls.current = self
        self.time_start = time.monotonic() * 1000.0
        return self

    def __exit__(self, *exc) -> bool:
        self.time_end = time.monotonic() * 1000.0
        _tls.current = self._parent
        _LOG.debug("phase %r: %.3f ms", self.title, self.time_end - self.time_start)
        return False

    def log(self, key: str, value: Any) -> None:
        self.stats[str(key)[:64]] = value
