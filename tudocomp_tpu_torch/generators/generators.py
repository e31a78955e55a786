"""String generators (type "generator").

The port's copy of tudocomp_tpu/generators/generators.py, host only.
Mirrors the reference generator set (include/tudocomp/generators/):
  - fib         FibonacciGenerator.hpp:8-43       n-th Fibonacci word
  - thue_morse  ThueMorseGenerator.hpp            n-th Thue-Morse word
  - random      RandomUniformGenerator.hpp        seeded uniform characters
  - run_rich    RunRichGenerator.hpp              Matsubara et al. run-rich

Used by the command line's `-g` option.
"""

from __future__ import annotations

import numpy as np

from ..base import Generator
from ..meta import Meta


def fibonacci_word(n: int) -> bytes:
    """n-th Fibonacci word (FibonacciGenerator.hpp:17-36)."""
    if n == 1:
        return b"b"
    if n == 2:
        return b"a"
    vold, old = b"b", b"a"
    for _ in range(2, n):
        vold, old = old, old + vold
    return old


def thue_morse_word(n: int) -> bytes:
    """n-th Thue-Morse word over '0'/'1' (ThueMorseGenerator.hpp:22-37)."""
    if n >= 64:
        raise ValueError("too long!")
    if n == 0:
        return b"0"
    a = np.zeros(1, dtype=np.uint8)
    for _ in range(1, n):
        a = np.concatenate([a, 1 - a])
    return (a + ord("0")).tobytes()


def random_uniform(length: int, seed: int = 0, lo: int = ord("0"), hi: int = ord("9")) -> bytes:
    """Seeded uniform random string (RandomUniformGenerator.hpp:29-44).

    Deterministic for a given seed (exact RNG differs from libstdc++'s
    implementation-defined engine; only determinism and the [lo,hi] range are
    contract).
    """
    if lo > hi:
        lo, hi = hi, lo
    if not seed:
        import time

        seed = time.time_ns()
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi + 1, size=length, dtype=np.int64).astype(np.uint8).tobytes()


def run_rich(n: int) -> bytes:
    """Run-rich string series (RunRichGenerator.hpp:18-37)."""
    t0 = b"0110101101001011010"
    t1 = b"0110101101001"
    t2 = b"01101011010010110101101"
    t3 = t2 + t1
    if n == 0:
        return t0
    if n == 1:
        return t1
    if n == 2:
        return t2
    for i in range(4, n):
        tmp = (t3 + t2) if i % 3 == 0 else (t3 + t0)
        t0, t1, t2, t3 = t1, t2, t3, tmp
    return t3


class FibonacciGenerator(Generator):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("generator", "fib", "Generates the n-th Fibonacci word.")
        m.option("n").dynamic()
        return m

    def generate(self) -> bytes:
        return fibonacci_word(self.env.option("n").as_integer())


class ThueMorseGenerator(Generator):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("generator", "thue_morse", "Generates the n-th Thue Morse word.")
        m.option("n").dynamic()
        return m

    def generate(self) -> bytes:
        return thue_morse_word(self.env.option("n").as_integer())


class RandomUniformGenerator(Generator):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("generator", "random", "Generates random strings.")
        m.option("length").dynamic()
        m.option("seed").dynamic(0)
        m.option("min").dynamic(ord("0"))
        m.option("max").dynamic(ord("9"))
        return m

    def generate(self) -> bytes:
        return random_uniform(
            self.env.option("length").as_integer(),
            self.env.option("seed").as_integer(),
            self.env.option("min").as_integer(),
            self.env.option("max").as_integer(),
        )


class RunRichGenerator(Generator):
    @classmethod
    def meta(cls) -> Meta:
        m = Meta("generator", "run_rich", "Generates run-rich strings.")
        m.option("n").dynamic()
        return m

    def generate(self) -> bytes:
        return run_rich(self.env.option("n").as_integer())


def register(registry):
    for cls in (
        FibonacciGenerator,
        ThueMorseGenerator,
        RandomUniformGenerator,
        RunRichGenerator,
    ):
        registry.register(cls)
