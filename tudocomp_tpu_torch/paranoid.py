"""Paranoid invariant checks (mirror of the reference's -DPARANOID mode,
def.hpp:42-50 IF_PARANOID), gated behind TDC_PARANOID=1. The port's copy of
tudocomp_tpu/paranoid.py. The reference guards e.g. the Huffman Kraft
equality (HuffmanCoder.hpp:143-166) and the BWT LF permutation
(ds/bwt.hpp:55-65); the checks here cover the same invariants.

Enable:  TDC_PARANOID=1 python -m tudocomp_tpu_torch ...
"""

from __future__ import annotations

import os

import numpy as np

ENABLED = os.environ.get("TDC_PARANOID", "0") == "1"


def check(cond, msg: str) -> None:
    if ENABLED and not cond:
        raise AssertionError(f"PARANOID: {msg}")


def check_permutation(arr, n: int, name: str) -> None:
    """assert_permutation (the reference uses it on SA, ISA, LF)."""
    if not ENABLED:
        return
    a = np.asarray(arr)
    seen = np.zeros(n, dtype=bool)
    seen[a] = True
    if not seen.all():
        raise AssertionError(f"PARANOID: {name} is not a permutation of [0,{n})")


def check_kraft(lengths) -> None:
    """Kraft equality for a complete prefix code (HuffmanCoder.hpp:143-166)."""
    if not ENABLED:
        return
    ls = np.asarray(lengths, dtype=np.int64)
    ls = ls[ls > 0]
    if len(ls) < 2:
        return
    total = np.sum(2.0 ** (-ls.astype(np.float64)))
    if not np.isclose(total, 1.0, atol=1e-9):
        raise AssertionError(f"PARANOID: Kraft sum {total} != 1 for code lengths")


def check_sorted(arr, name: str) -> None:
    if not ENABLED:
        return
    a = np.asarray(arr)
    if len(a) > 1 and not (a[1:] >= a[:-1]).all():
        raise AssertionError(f"PARANOID: {name} not sorted")
