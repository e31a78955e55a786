"""Input/Output abstractions.

Mirror of include/tudocomp/io/Input.hpp:37-251 and Output.hpp:23-167: an
Input is a cheap handle over bytes (memory / file / slice), an Output
collects bytes. Restriction wrapping (escaping + sentinel) mirrors
Input.hpp:248 / Output unrestrict and is applied with
io.restrict.escape/unescape by the driver, exactly as tudocomp's driver does
(src/tudocomp_driver/tudocomp_driver.cpp:268-270, 336-338). The port's copy
of tudocomp_tpu/io/inout.py.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from .restrict import InputRestrictions, escape, unescape


class Input:
    """Source abstraction. Cheap to copy/slice."""

    def __init__(
        self,
        data: Union[bytes, bytearray, np.ndarray, "Input"],
        start: int = 0,
        end: Optional[int] = None,
        restrictions: Optional[InputRestrictions] = None,
    ):
        alloc = None
        if isinstance(data, Input):
            base = data._array
            restrictions = restrictions or data._restrictions
            if not start and end is None:
                alloc = data._alloc
        elif isinstance(data, np.ndarray):
            base = data.astype(np.uint8, copy=False)
        else:
            base = np.frombuffer(bytes(data), dtype=np.uint8)
        self._array = base[start:end] if (start or end is not None) else base
        self._restrictions = restrictions or InputRestrictions()
        # InputAlloc-style chunk cache (io/InputAlloc.hpp:23-111): escaped
        # materializations are shared across every Input derived from the
        # same (unsliced) source, so repeated restricted views of one
        # input — e.g. a compressor calling as_array() in several stages —
        # escape only once. Keyed by the restriction set.
        self._alloc: dict = alloc if alloc is not None else {}

    def with_restrictions(self, rest: InputRestrictions) -> "Input":
        return Input(self, restrictions=self._restrictions | rest)

    def size(self) -> int:
        return len(self._array)

    def as_array(self) -> np.ndarray:
        """The input bytes with restrictions (escaping/sentinel) applied.

        Analogue of Input::as_view() over a restricted input, which
        materializes the escaped, 0-terminated buffer (io/RestrictedBuffer.hpp).
        """
        if not self._restrictions.has_restrictions:
            return self._array
        key = (self._restrictions.escape_bytes, self._restrictions.null_terminate)
        cached = self._alloc.get(key)
        if cached is None:
            cached = escape(self._array, self._restrictions)
            self._alloc[key] = cached
        return cached

    def as_bytes(self) -> bytes:
        return self.as_array().tobytes()

    def raw_array(self) -> np.ndarray:
        """Unrestricted raw bytes (used when slicing headers off)."""
        return self._array


class Output:
    """Sink abstraction collecting bytes; optionally unescapes on finalize."""

    def __init__(self, restrictions: Optional[InputRestrictions] = None):
        self._chunks: list[bytes] = []
        self._restrictions = restrictions or InputRestrictions()

    @classmethod
    def unrestricted(cls) -> "Output":
        return cls()

    def with_restrictions(self, rest: InputRestrictions) -> "Output":
        out = Output(self._restrictions | rest)
        out._chunks = self._chunks  # share the buffer
        return out

    def write(self, data: Union[bytes, bytearray, np.ndarray]) -> None:
        if isinstance(data, np.ndarray):
            data = data.astype(np.uint8, copy=False).tobytes()
        self._chunks.append(bytes(data))

    def getvalue(self) -> bytes:
        """All written bytes, with restriction unwrapping applied.

        On the decompression side, a restricted Output un-escapes and strips
        the sentinel on the way out (tudocomp_driver.cpp:336-338).
        """
        raw = b"".join(self._chunks)
        if self._restrictions.has_restrictions:
            arr = np.frombuffer(raw, dtype=np.uint8)
            return unescape(arr, self._restrictions).tobytes()
        return raw

    def raw_value(self) -> bytes:
        return b"".join(self._chunks)
