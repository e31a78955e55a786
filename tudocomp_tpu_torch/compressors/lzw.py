"""LZW compressor of the port (id "lzw").

tudocomp_tpu's LZWCompressor as it is (host parse, code coding, decode),
with its blockwise batch hook moved onto the port's device: the blocks are
parsed on the registry's device by kernel F (ops/lz78_cuda.py), or by its
plain version on the CPU, and each block's codes are coded by the
inherited _encode_codes, so every payload equals the host path's.
"""

from __future__ import annotations

import numpy as np

from tudocomp_tpu.compressors import lzw as _ref
from tudocomp_tpu.stats.phase import StatPhase

from ..device import use_parse_device
from ..ops.lz78_cuda import lzw_parse_blocks_device


class LZWCompressor(_ref.LZWCompressor):
    def compress_block_batch(self, blocks: np.ndarray, n_valid: np.ndarray):
        """Per-block payloads of blocks [B, bs], parsed on the registry's
        device; None where use_parse_device routes them to the host parse
        (which also rejects a dict_size)."""
        device = self.env.registry.device
        if self.env.option("dict_size").as_integer() or not use_parse_device(blocks.shape[1], device):
            return None
        with StatPhase("device lzw parse") as ph:
            ph.log("blocks", len(blocks))
            code_lists = lzw_parse_blocks_device(blocks, n_valid, device)
        with StatPhase("encode"):
            return [self._encode_codes(c) for c in code_lists]
