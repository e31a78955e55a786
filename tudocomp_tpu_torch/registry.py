"""The port's algorithm registry.

`Registry` is the port's copy of tudocomp_tpu/registry.py's class (mirror
of include/tudocomp/Registry.hpp:11-238), trimmed to registration, lookup
and selection: it maps (type, name) to algorithm classes and selects and
instantiates them from id strings. `TorchRegistry` holds the algorithms of
the ported slices (`blockwise`, `lz78`, `lzw`, `lzss_lcp`, `encode`, the
Huffman and universal coders `huff`, `ascii`, `bit`, `gamma`, `delta`,
`ternary`, `vbyte`, the `lz78trie` axis and the hash axes of its hash
tries, the `textds` axis and its providers) and is bound to the one
torch.device its device stages run on.
"""

from __future__ import annotations

from typing import Type

import torch

from .coders.huffman import HuffmanCoder
from .coders.universal import (
    ASCIICoder,
    BitCoder,
    EliasDeltaCoder,
    EliasGammaCoder,
    TernaryCoder,
    VbyteCoder,
)
from .compressors import hash_axes, lz78_tries
from .compressors.blockwise import BlockwiseCompressor
from .compressors.lz78 import LZ78Compressor
from .compressors.lzss_lcp import LZSSLCPCompressor
from .compressors.lzw import LZWCompressor
from .compressors.simple import LiteralEncoder
from .device import resolve
from .ds import textds_algo
from .dsl import evaluate, parse
from .meta import Algorithm, AlgorithmValue, Env

__all__ = ["Registry", "TorchRegistry"]


class Registry:
    def __init__(self):
        # (type, name) -> class
        self._algos: dict[tuple[str, str], Type[Algorithm]] = {}

    def register(self, cls: Type[Algorithm]) -> Type[Algorithm]:
        meta = cls.meta()
        self._algos[(meta.type, meta.name)] = cls
        return cls

    def get_class(self, algo_type: str, name: str) -> Type[Algorithm]:
        key = (algo_type, name)
        if key not in self._algos:
            raise KeyError(f"no {algo_type} algorithm named {name!r} registered")
        return self._algos[key]

    def find_class(self, name: str) -> Type[Algorithm]:
        """Find a class by id name across all types (unique names assumed)."""
        for (_, n), cls in self._algos.items():
            if n == name:
                return cls
        raise KeyError(f"no algorithm named {name!r} registered")

    def names(self, algo_type: str) -> list[str]:
        return sorted(n for (t, n) in self._algos if t == algo_type)

    def parse_algorithm_id(self, id_string: str, algo_type: str = "compressor") -> AlgorithmValue:
        return evaluate(parse(id_string), algo_type, self)

    def select(self, id_string: str, algo_type: str = "compressor") -> Algorithm:
        """Parse an id string and instantiate the algorithm (Registry.hpp:204-238)."""
        return self.select_algorithm(self.parse_algorithm_id(id_string, algo_type), algo_type)

    def select_algorithm(self, av: AlgorithmValue, algo_type: str = "compressor") -> Algorithm:
        cls = self.get_class(algo_type, av.name)
        return cls(Env(self, av))


class TorchRegistry(Registry):
    def __init__(self, device="cuda"):
        super().__init__()
        self.device: torch.device = resolve(device)
        for cls in (
            BlockwiseCompressor,
            LZ78Compressor,
            LZWCompressor,
            LZSSLCPCompressor,
            LiteralEncoder,
            HuffmanCoder,
            ASCIICoder,
            BitCoder,
            EliasGammaCoder,
            EliasDeltaCoder,
            TernaryCoder,
            VbyteCoder,
        ):
            self.register(cls)
        lz78_tries.register(self)
        hash_axes.register(self)
        textds_algo.register(self)
