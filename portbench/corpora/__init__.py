"""Corpus generators, one file each: generate(seed, index, size) -> bytes."""
