"""The program's StatPhase 'device blockwise encode', ms per MiB of input."""

LAYER = "blockwise and runtime (compressors/blockwise.py, parallel/runtime.py, parallel/blocks.py)"
UNIT = "ms/MiB"
SOURCE = "program_span"
MOVES = "encode_MBps"


def read(run):
    return run.phase_ms_per_mib("compress", "device blockwise encode")
