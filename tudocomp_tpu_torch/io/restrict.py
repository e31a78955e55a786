"""Input restrictions and escaping, mirroring tudocomp's semantics.

The port's copy of tudocomp_tpu/io/restrict.py.

Reference: include/tudocomp/io/InputRestrictions.hpp:10-97 (restriction sets,
merge via |), include/tudocomp/io/EscapeMap.hpp:10-181 (replacement byte pool
drawn from UTF-8-illegal bytes), include/tudocomp/io/RestrictedBuffer.hpp
(escape = flagged byte c -> [escape_byte, replacement(c)]; a single 0 byte is
appended after escaping when null termination is requested; unescape strips
the trailing 0 and folds [escape_byte, r] -> original byte).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# EscapeMap.hpp:10-24 — bytes illegal in UTF-8, usable as replacements.
ESCAPE_BYTE_POOL = [255, 254, 192, 193, 245, 246, 247, 248, 249, 250, 251, 252, 253]


@dataclass(frozen=True)
class InputRestrictions:
    """A set of bytes that must not appear + null-termination flag."""

    escape_bytes: tuple[int, ...] = ()
    null_terminate: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "escape_bytes", tuple(sorted(set(int(b) for b in self.escape_bytes)))
        )

    def __or__(self, other: "InputRestrictions") -> "InputRestrictions":
        return InputRestrictions(
            self.escape_bytes + other.escape_bytes,
            self.null_terminate or other.null_terminate,
        )

    @property
    def has_restrictions(self) -> bool:
        return bool(self.escape_bytes) or self.null_terminate

    @property
    def has_escape_restrictions(self) -> bool:
        return bool(self.escape_bytes)


@dataclass
class EscapeMap:
    """Derived escape/replacement mapping (EscapeMap.hpp:26-91)."""

    replacement_bytes: list[int] = field(default_factory=list)
    escape_bytes: list[int] = field(default_factory=list)
    null_terminate: bool = False

    def __init__(self, rest: InputRestrictions):
        self.escape_bytes = list(rest.escape_bytes)
        self.null_terminate = rest.null_terminate
        self.replacement_bytes = []
        if self.escape_bytes:
            needed = len(self.escape_bytes) + 1
            for byte in ESCAPE_BYTE_POOL:
                if byte not in rest.escape_bytes and len(self.replacement_bytes) < needed:
                    self.replacement_bytes.append(byte)
            # replacement_bytes[0] is the escape byte itself -> must be escaped too
            self.escape_bytes.insert(0, self.replacement_bytes[0])
            assert len(self.replacement_bytes) == len(self.escape_bytes)

    @property
    def has_escape_bytes(self) -> bool:
        return bool(self.escape_bytes)

    @property
    def escape_byte(self) -> int:
        return self.replacement_bytes[0] if self.has_escape_bytes else -1


def escape(data: np.ndarray, rest: InputRestrictions) -> np.ndarray:
    """Escape restricted bytes and append the 0 sentinel if requested.

    Vectorized equivalent of RestrictedBuffer::escape_with_iters
    (io/RestrictedBuffer.hpp:43-107).
    """
    data = np.asarray(data, dtype=np.uint8)
    out = data
    if rest.has_escape_restrictions:
        em = EscapeMap(rest)
        repl = np.arange(256, dtype=np.uint8)
        flag = np.zeros(256, dtype=bool)
        for eb, rb in zip(em.escape_bytes, em.replacement_bytes):
            repl[eb] = rb
            flag[eb] = True
        flagged = flag[data]
        n_extra = int(flagged.sum())
        if n_extra:
            out = np.empty(len(data) + n_extra, dtype=np.uint8)
            # output position of each input byte = i + (#flagged before i)
            shift = np.cumsum(flagged) - flagged  # exclusive count
            pos = np.arange(len(data), dtype=np.int64) + shift + flagged
            out[pos] = repl[data]
            out[pos[flagged] - 1] = em.escape_byte
        else:
            out = data.copy() if rest.null_terminate else data
    if rest.null_terminate:
        out = np.concatenate([out, np.zeros(1, dtype=np.uint8)])
    return out


def unescape(data: np.ndarray, rest: InputRestrictions) -> np.ndarray:
    """Reverse of escape(): strip trailing 0 sentinel, fold escape pairs."""
    data = np.asarray(data, dtype=np.uint8)
    if rest.null_terminate:
        if len(data) and data[-1] == 0:
            data = data[:-1]
    if not rest.has_escape_restrictions:
        return data
    em = EscapeMap(rest)
    unrepl = np.arange(256, dtype=np.uint8)
    for eb, rb in zip(em.escape_bytes, em.replacement_bytes):
        unrepl[rb] = eb
    esc = em.escape_byte
    is_esc = data == esc
    if not is_esc.any():
        return data
    # Escaped data consists of literal bytes and [esc, payload] pairs. An
    # original esc byte escapes to [esc, esc], so inside a maximal run of
    # consecutive esc bytes the markers sit at even offsets from the run
    # start; an odd-length run's final esc is a marker whose payload is the
    # following non-esc byte.
    n = len(data)
    pos = np.arange(n, dtype=np.int64)
    run_start_flag = is_esc & np.concatenate([[True], ~is_esc[:-1]])
    run_start = np.maximum.accumulate(np.where(run_start_flag, pos, -1))
    offset = pos - run_start
    marker = is_esc & (offset % 2 == 0)
    payload = np.zeros(n, dtype=bool)
    mk = np.flatnonzero(marker)
    payload[np.minimum(mk + 1, n - 1)] = True
    keep = ~marker
    out = data[keep].copy()
    payload_out = payload[keep]
    out[payload_out] = unrepl[out[payload_out]]
    return out
