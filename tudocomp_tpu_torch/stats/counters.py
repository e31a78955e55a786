"""Named integer counters of the port, behind one lock.

One registry for every count the port keeps: the kernel launches
(`kernels.launch` adds under `launch.<kernel>`; `kernels.counts()` gives
them back under the kernel's name), the copies between a CUDA device and
the host on the paths that copy through `device.to_host` /
`device.to_device` (`copy.to_host_bytes`, `copy.to_device_bytes`,
`copy.count`), the growth of the host's resident set while a StatPhase is
open, where readings are on (`host.fresh_bytes`, stats/phase.py) and the suffix
array's rounds and sorted keys (`sa.rounds`, `sa.keys`,
ds/suffix_array.suffix_array_device). Every count is a host integer the
code already holds: nothing here reads the device.

`reset()` zeroes every counter (`kernels.reset_counts()` calls it), so a
caller that resets before a stretch of work and reads `snapshot()` after
it sees that stretch alone.
"""

from __future__ import annotations

import threading

__all__ = ["add", "get", "reset", "snapshot"]

_lock = threading.Lock()
_values: dict[str, int] = {}


def add(name: str, n: int = 1) -> None:
    """Add n to counter `name` (created at 0)."""
    with _lock:
        _values[name] = _values.get(name, 0) + n


def get(name: str) -> int:
    """Counter `name`, 0 where nothing was added since the last reset."""
    return _values.get(name, 0)


def snapshot() -> dict[str, int]:
    """Every counter that was added to since the last reset, by name."""
    with _lock:
        return dict(_values)


def reset() -> None:
    """Zero every counter."""
    with _lock:
        _values.clear()
