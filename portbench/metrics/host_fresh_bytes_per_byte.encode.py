"""Growth of the process's resident set while the program's StatPhases were
open (fresh host pages: host.fresh_bytes), per byte of the compress calls'
input."""

from portbench.counters import per_input

LAYER = "host memory (fresh pages of the host arrays)"
UNIT = "B/B"
SOURCE = "program_counter"
MOVES = "encode_MBps"


def read(run):
    return per_input(run, "compress", ("host.fresh_bytes",))
