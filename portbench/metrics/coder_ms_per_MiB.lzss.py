"""The program's StatPhase 'Encode' of lzss_lcp (the factor stream and its Huffman literals, on the host), ms per MiB of input."""

LAYER = "host coders (compressors/lzss_common.py, coders/huffman.py, io/bitio.py)"
UNIT = "ms/MiB"
SOURCE = "program_span"
MOVES = "encode_MBps"


def read(run):
    return run.phase_ms_per_mib("compress", "Encode")
