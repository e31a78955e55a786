"""LZ78 compressor of the port (id "lz78").

tudocomp_tpu's LZ78Compressor as it is (host parse, factor coding, decode),
with its blockwise batch hook moved onto the port's device: the blocks are
parsed on the registry's device by kernel E (ops/lz78_cuda.py), or by its
plain version on the CPU, and each block's factors are coded by the
inherited _encode_factors, so every payload equals the host path's.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu.compressors import lz78 as _ref
from tudocomp_tpu.stats.phase import StatPhase

from ..device import use_parse_device
from ..ops.lz78_cuda import lz78_parse_blocks_device


class LZ78Compressor(_ref.LZ78Compressor):
    def compress_block_batch(self, blocks: np.ndarray, n_valid: np.ndarray):
        """Per-block payloads of blocks [B, bs], parsed on the registry's
        device; None where use_parse_device routes them to the host parse
        (which also rejects a dict_size)."""
        device = self.env.registry.device
        if self.env.option("dict_size").as_integer() or not use_parse_device(blocks.shape[1], device):
            return None
        with StatPhase("device lz78 parse") as ph:
            ph.log("blocks", len(blocks))
            factors = lz78_parse_blocks_device(blocks, n_valid, device)
        with StatPhase("encode"):
            return [self._encode_factors(p, c) for p, c in factors]
