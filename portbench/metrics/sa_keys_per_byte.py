"""Keys the device suffix array sorts over all its rounds (sa.keys) per
byte of the compress calls' input."""

from portbench.counters import per_input

LAYER = "text data structures (ds/textds.py, ds/suffix_array.py, ops/plcp_torch.py, kernel H)"
UNIT = "keys/B"
SOURCE = "program_counter"
MOVES = "encode_MBps"


def read(run):
    return per_input(run, "compress", ("sa.keys",))
