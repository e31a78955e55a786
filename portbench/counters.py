"""The program's counter registry, read by the `program_counter` metrics.

The registry is `tudocomp_tpu_torch.stats.counters`: named integers that
the program adds to as it works (copies between the card and the host;
the host's resident-set growth while a StatPhase is open, read only while
torch.profiler records, so in a traced run; the suffix array's rounds and
keys). A reader under metrics/ takes it as the harness
takes the launch counters (`kernels:counts`): by the name `SNAPSHOT`,
imported when the reader runs, after the window, and calls it. The
harness's `reset_counts` after the warm-up, which now zeroes the whole
registry and not the launches alone, scopes every counter to the window:
a snapshot after it holds the window's calls and nothing of the warm-up
(the reference's check imports nothing of the program, so it adds
nothing). A program without the registry gives nothing to read: None,
and the metric is left out of the line.
"""

from __future__ import annotations

import importlib

SNAPSHOT = "tudocomp_tpu_torch.stats.counters:snapshot"


def snapshot():
    """The registry's counters by name, or None where the program has none."""
    mod, fn = SNAPSHOT.split(":")
    try:
        return getattr(importlib.import_module(mod), fn)()
    except (ImportError, AttributeError):
        return None


def per_input(run, op: str, names):
    """The sum of counters `names` over the op's input bytes; None where the
    counters are absent or zero."""
    snap = snapshot()
    calls = run.of(op)
    if not snap or not calls:
        return None
    total = sum(snap.get(n, 0) for n in names)
    if total <= 0:
        return None
    return total / sum(c.bytes_in for c in calls)
