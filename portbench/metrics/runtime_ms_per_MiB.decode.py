"""The program's StatPhase 'device blockwise decode', ms per MiB of output."""

LAYER = "blockwise and runtime (compressors/blockwise.py, parallel/runtime.py, parallel/blocks.py)"
UNIT = "ms/MiB"
SOURCE = "program_span"
MOVES = "decode_MBps"


def read(run):
    return run.phase_ms_per_mib("decompress", "device blockwise decode")
