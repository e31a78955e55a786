"""Share of the compress calls' wall time in which nothing (no kernel, copy or fill) ran on the card."""

LAYER = "device (one H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "encode_MBps"


def read(run):
    return run.device_idle_pct("compress")
