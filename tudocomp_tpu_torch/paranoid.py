"""Paranoid invariant checks (mirror of the reference's -DPARANOID mode,
def.hpp:42-50 IF_PARANOID), gated behind TDC_PARANOID=1. The port's copy of
tudocomp_tpu/paranoid.py, trimmed to the check its text data structures use.
"""

from __future__ import annotations

import os

import numpy as np

ENABLED = os.environ.get("TDC_PARANOID", "0") == "1"


def check_permutation(arr, n: int, name: str) -> None:
    """assert_permutation (the reference uses it on SA, ISA, LF)."""
    if not ENABLED:
        return
    a = np.asarray(arr)
    seen = np.zeros(n, dtype=bool)
    seen[a] = True
    if not seen.all():
        raise AssertionError(f"PARANOID: {name} is not a permutation of [0,{n})")
