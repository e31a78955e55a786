"""Hash-strategy registry axes (types "hash_function", "hash_prober",
"hash_manager", "hash_roll").

The port's copy of tudocomp_tpu/compressors/hash_axes.py. Mirror of
util/Hash.hpp:13-354 and etc/registry_config.py:88-120: the
reference parameterizes its hash-trie family over hasher x prober x
size-manager (x rolling hash). As in the reference, the axes never affect
the bitstream, only the table's probe behaviour, so here they select an id
and nothing more: every choice takes the one hash-trie parse of the host
helpers (csrc/host/tdc_host.cpp).
"""

from __future__ import annotations

from ..meta import Algorithm, Meta


def _axis(algo_type, ident, doc):
    class A(Algorithm):
        @classmethod
        def meta(cls) -> Meta:
            return Meta(algo_type, ident, doc)

    A.__name__ = f"{algo_type}_{ident}"
    return A


AXES = [
    # hashers (util/Hash.hpp:13-78)
    _axis("hash_function", "mixer", "splitmix64-style bit mixer"),
    _axis("hash_function", "vigna", "Vigna multiplier hash"),
    _axis("hash_function", "knuth", "Knuth multiplicative hash"),
    _axis("hash_function", "noop", "identity hash"),
    # probers (util/Hash.hpp:229-305)
    _axis("hash_prober", "linear", "linear probing"),
    _axis("hash_prober", "quadratic", "quadratic probing"),
    _axis("hash_prober", "gauss", "gaussian probing"),
    _axis("hash_prober", "double", "double hashing"),
    # size managers (util/Hash.hpp:80-228)
    _axis("hash_manager", "pow2", "power-of-two table sizes"),
    _axis("hash_manager", "direct", "direct table sizes"),
    _axis("hash_manager", "prime", "prime table sizes"),
    # rolling hashes (util/Hash.hpp:307-354, util/hash/)
    _axis("hash_roll", "zbackup", "ZBackup rolling hash"),
    _axis("hash_roll", "wordpack", "word-packing rolling hash"),
    _axis("hash_roll", "karprabin", "Karp-Rabin rolling hash"),
]


def register(registry):
    for a in AXES:
        registry.register(a)
