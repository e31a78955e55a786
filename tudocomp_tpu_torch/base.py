"""Compressor / Generator base interfaces.

The port's copy of tudocomp_tpu/base.py: the two-method contract of
include/tudocomp/Compressor.hpp:36-42 and include/tudocomp/Generator.hpp:13.
"""

from __future__ import annotations

from .io.inout import Input, Output
from .meta import Algorithm


class Compressor(Algorithm):
    def compress(self, inp: Input, out: Output) -> None:  # pragma: no cover
        raise NotImplementedError

    def decompress(self, inp: Input, out: Output) -> None:  # pragma: no cover
        raise NotImplementedError


class Generator(Algorithm):
    def generate(self) -> bytes:  # pragma: no cover
        raise NotImplementedError
