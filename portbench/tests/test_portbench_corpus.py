"""The corpus generator: the same bytes for the same seed, file and size."""

import numpy as np
import pytest

from portbench.corpora import synth_english

SEEDS = [0, 7, 2**31 - 1, 2**31 + 12345, 2**33 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_bytes(seed):
    a = synth_english.generate(seed, 0, 100_003)
    assert a == synth_english.generate(seed, 0, 100_003)
    assert len(a) == 100_003


@pytest.mark.parametrize("seed", SEEDS)
def test_files_and_seeds_differ(seed):
    a = synth_english.generate(seed, 0, 4096)
    assert a != synth_english.generate(seed, 1, 4096)
    assert a != synth_english.generate(seed + 1, 0, 4096)


def test_words_and_breaks():
    text = synth_english.generate(3, 0, 400_000)
    alphabet = set(b"".join(w.encode() for w in synth_english.WORDS)) | {ord(" "), ord(".")}
    assert set(text) <= alphabet
    words = text.replace(b".", b"").split()[:-1]
    assert set(w.decode() for w in words) <= set(synth_english.WORDS)
    share = text.count(b". ") / len(words)
    assert 0.08 < share < 0.12
    counts = np.array([words.count(w.encode()) for w in synth_english.WORDS])
    assert counts.min() > 0.8 * counts.mean()


def test_empty_and_tiny():
    assert synth_english.generate(5, 0, 0) == b""
    assert len(synth_english.generate(5, 0, 1)) == 1
