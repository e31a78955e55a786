"""The port's algorithm registry.

`Registry` is the port's copy of tudocomp_tpu/registry.py's class (mirror
of include/tudocomp/Registry.hpp:11-238), trimmed to registration, lookup
and selection: it maps (type, name) to algorithm classes and selects and
instantiates them from id strings. `TorchRegistry` holds the algorithms of
the ported slices (`blockwise`, `lz78`, `lzw`, `lzss_lcp`, `esp`,
`lcpcomp`, `encode`, the transforms `noop`, `rle`, `mtf` and `bwt`,
`chain`, the host-only `lzss` and `repair`, `lz78u` and its
`lz78u_strategy` axis, `lfs_comp` and its `lfs_comp` and `lfs_comp_enc`
axes, `lfs2` and `lfs2bst`, the Huffman, arithmetic, sle and universal coders
`huff`, `arithmetic`, `sle`, `ascii`, `bit`, `gamma`, `delta`, `ternary`,
`vbyte`, the `lz78trie` axis and the hash axes of its hash tries, the
`textds` axis and its providers, esp's `slp_coder`, `d_coding`, `subseq`
and `ipd` axes, and lcpcomp's `lcpcomp_comp` and `lcpcomp_dec` axes), with the
string generators of the command line's -g (`fib`, `thue_morse`,
`random`, `run_rich`), and is bound to the one torch.device its device
stages run on: all 293 ids of the JAX package's compressor matrix select.
`types` and `generate_doc_string` give the command line's -l listing.
`create_algo` instantiates one algorithm from a class or an id string
(mirror of include/tudocomp/CreateAlgorithm.hpp).
"""

from __future__ import annotations

from typing import Optional, Type

import torch

from .coders.arithmetic import ArithmeticCoder
from .coders.huffman import HuffmanCoder
from .coders.sle import SLECoder
from .coders.universal import (
    ASCIICoder,
    BitCoder,
    EliasDeltaCoder,
    EliasGammaCoder,
    TernaryCoder,
    VbyteCoder,
)
from .compressors import esp_dcoding as dc
from .compressors import hash_axes, lfs, lfs2, lz78_tries, lz78u
from .compressors.blockwise import BlockwiseCompressor
from .compressors.bwt import BWTCompressor
from .compressors.chain import ChainCompressor
from .compressors.esp import IPDS, EspCompressor, PlainSLPCoder, SortedSLPCoder
from .compressors.lcpcomp import COMP_STRATEGIES, DEC_STRATEGIES, LCPCompressor
from .compressors.lz78 import LZ78Compressor
from .compressors.lzss import LZSSSlidingWindowCompressor
from .compressors.lzss_lcp import LZSSLCPCompressor
from .compressors.lzw import LZWCompressor
from .compressors.repair import RePairCompressor
from .compressors.simple import LiteralEncoder, MTFCompressor, NoopCompressor, RunLengthEncoder
from .device import resolve
from .ds import textds_algo
from .dsl import evaluate, parse
from .generators import generators
from .meta import Algorithm, AlgorithmValue, Env, Meta

__all__ = ["Registry", "TorchRegistry", "create_algo"]


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

    def types(self) -> list[str]:
        return sorted({t for (t, _) in self._algos})

    def parse_algorithm_id(self, id_string: str, algo_type: str = "compressor") -> AlgorithmValue:
        return evaluate(parse(id_string), algo_type, self)

    def select(self, id_string: str, algo_type: str = "compressor") -> Algorithm:
        """Parse an id string and instantiate the algorithm (Registry.hpp:204-238)."""
        return self.select_algorithm(self.parse_algorithm_id(id_string, algo_type), algo_type)

    def select_algorithm(self, av: AlgorithmValue, algo_type: str = "compressor") -> Algorithm:
        cls = self.get_class(algo_type, av.name)
        return cls(Env(self, av))

    def generate_doc_string(self, algo_type: str = "compressor") -> str:
        """The -l listing of one algorithm type (the JAX package's format)."""
        lines = [f"[{algo_type}]"]
        for name in self.names(algo_type):
            meta = self.get_class(algo_type, name).meta()
            sig_parts = []
            for d in meta.options.values():
                if d.kind == "templated":
                    dflt = f" = {d.default}" if d.default else ""
                    sig_parts.append(f"{d.name}: {d.algo_type}{dflt}")
                elif d.kind == "dynamic_compressor":
                    sig_parts.append(f"{d.name}: compressor (dynamic)")
                else:
                    dflt = f" = {d.default}" if d.default is not None else ""
                    sig_parts.append(f"{d.name}: string{dflt}")
            sig = f"({', '.join(sig_parts)})" if sig_parts else ""
            doc = meta.doc.splitlines()[0] if meta.doc else ""
            lines.append(f"  {name}{sig}")
            if doc:
                lines.append(f"      {doc}")
        return "\n".join(lines)


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
            NoopCompressor,
            RunLengthEncoder,
            MTFCompressor,
            ChainCompressor,
            BWTCompressor,
            LZSSSlidingWindowCompressor,
            RePairCompressor,
            HuffmanCoder,
            ASCIICoder,
            BitCoder,
            EliasGammaCoder,
            EliasDeltaCoder,
            TernaryCoder,
            VbyteCoder,
            ArithmeticCoder,
            EspCompressor,
            PlainSLPCoder,
            SortedSLPCoder,
            dc.DPlain,
            dc.DDiff,
            dc.DWaveletTree,
            dc.DHuffman,
            dc.DMonotonSubseq,
            dc.DRangeFit,
            dc.DArith,
            dc.SubSeqOptimal,
            dc.SubSeqGreedy,
            *IPDS,
            LCPCompressor,
            *COMP_STRATEGIES,
            *DEC_STRATEGIES,
            SLECoder,
        ):
            self.register(cls)
        for module in (lz78_tries, hash_axes, textds_algo, lz78u, lfs, lfs2, generators):
            module.register(self)


def create_algo(cls_or_id, options: str = "", registry: Optional[Registry] = None, device="cuda"):
    """Instantiate an algorithm directly with an options string.

    Mirror of create_algo<T>(options) (include/tudocomp/CreateAlgorithm.hpp:118),
    the JAX package's registry.create_algo: an id string selects through
    the registry under its algorithm's type (a compressor where the name
    is unknown), a class is instantiated with `options`. The registry is
    the one given, else a TorchRegistry bound to `device`."""
    reg = registry or TorchRegistry(device)
    if isinstance(cls_or_id, str):
        meta_type = "compressor"
        try:
            meta_type = reg.find_class(parse(cls_or_id).name).meta().type
        except KeyError:
            pass
        return reg.select(cls_or_id, meta_type)
    meta: Meta = cls_or_id.meta()
    id_string = f"{meta.name}({options})" if options else meta.name
    return cls_or_id(Env(reg, evaluate(parse(id_string), meta.type, reg)))
