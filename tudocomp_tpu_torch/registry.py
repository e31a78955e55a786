"""The port's algorithm registry.

A `Registry` (tudocomp_tpu/registry.py, reused as it is) holding the
algorithms of the ported slices: the port's `blockwise`, `lz78` and `lzw`;
tudocomp_tpu's `encode` (LiteralEncoder), its Huffman and universal coders
(`huff`, `ascii`, `bit`, `gamma`, `delta`, `ternary`, `vbyte`) and its
`lz78trie` axis. It is bound to the one torch.device its device stages run
on, and shares nothing with the JAX package's global REGISTRY.
"""

from __future__ import annotations

import torch

from tudocomp_tpu.coders.huffman import HuffmanCoder
from tudocomp_tpu.coders.universal import (
    ASCIICoder,
    BitCoder,
    EliasDeltaCoder,
    EliasGammaCoder,
    TernaryCoder,
    VbyteCoder,
)
from tudocomp_tpu.compressors import lz78_tries
from tudocomp_tpu.compressors.simple import LiteralEncoder
from tudocomp_tpu.registry import Registry

from .compressors.blockwise import BlockwiseCompressor
from .compressors.lz78 import LZ78Compressor
from .compressors.lzw import LZWCompressor
from .device import resolve

__all__ = ["TorchRegistry"]


class TorchRegistry(Registry):
    def __init__(self, device="cuda"):
        super().__init__()
        self.device: torch.device = resolve(device)
        for cls in (
            BlockwiseCompressor,
            LZ78Compressor,
            LZWCompressor,
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
