"""The program's StatPhase 'Construct Text DS' (SA, ISA, LCP to host arrays), ms per MiB of input."""

LAYER = "text data structures (ds/textds.py, ds/suffix_array.py, ops/plcp_torch.py, kernel H)"
UNIT = "ms/MiB"
SOURCE = "program_span"
MOVES = "encode_MBps"


def read(run):
    return run.phase_ms_per_mib("compress", "Construct Text DS")
