"""The program's StatPhase 'Factorize', ms per MiB of input."""

LAYER = "lzss_lcp and suffix ops (compressors/lzss_lcp.py, ops/lzss_torch.py)"
UNIT = "ms/MiB"
SOURCE = "program_span"
MOVES = "encode_MBps"


def read(run):
    return run.phase_ms_per_mib("compress", "Factorize")
