"""Seeded stand-in for Pizza&Chili `english`: uniform words, 10% sentence breaks.

The distribution of `etc/datasets.py:synth_english` (26 words drawn
uniformly, each followed by ". " with probability 0.1, else " "), drawn
in bulk: every token is a word and its separator, and the bytes are one
gather from a padded table of the 52 tokens. The same (seed, index, size)
gives the same bytes on every machine (numpy's PCG64 through
`default_rng([seed, index])`); every file of a run has the same size.
"""

from __future__ import annotations

import numpy as np

WORDS = (
    "the quick brown fox jumps over lazy dog compression suffix array "
    "grammar factorization entropy huffman lempel ziv welch text data "
    "structure algorithm framework parallel device kernel"
).split()
SEPARATORS = (b" ", b". ")
BREAK_P = 0.1


def _tokens():
    toks = [w.encode() + s for w in WORDS for s in SEPARATORS]  # id = 2 * word + is_break
    width = max(len(t) for t in toks)
    table = np.zeros((len(toks), width), np.uint8)
    for i, t in enumerate(toks):
        table[i, : len(t)] = np.frombuffer(t, np.uint8)
    return table, np.array([len(t) for t in toks], np.int64)


def generate(seed: int, index: int, size: int) -> bytes:
    """`size` bytes of the stand-in, the `index`-th file of seed `seed`."""
    rng = np.random.default_rng([int(seed), int(index)])
    table, lens = _tokens()
    mean = float(lens.mean())
    out = np.empty(size, np.uint8)
    filled = 0
    while filled < size:
        count = int((size - filled) / mean * 1.01) + 64
        ids = 2 * rng.integers(0, len(WORDS), count) + (rng.random(count) < BREAK_P)
        tl = lens[ids]
        ends = np.cumsum(tl)
        take = min(count, int(np.searchsorted(ends, size - filled)) + 1)
        ids, tl, ends = ids[:take], tl[:take], ends[:take]
        # byte j of the chunk is byte j - start of its token: flat index
        # token * width - start + j into the table
        base = (ids * table.shape[1] - (ends - tl)).astype(np.int32)
        flat = np.repeat(base, tl)
        flat += np.arange(len(flat), dtype=np.int32)
        chunk = table.reshape(-1)[flat]
        n = min(len(chunk), size - filled)
        out[filled : filled + n] = chunk[:n]
        filled += n
    return out.tobytes()
