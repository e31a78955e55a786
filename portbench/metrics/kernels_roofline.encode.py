"""The least time for the bytes the configuration counts for an encode (roofline_bytes), at 3.35 TB/s, over the summed kernel time (no copies) of the compress calls."""

LAYER = "kernels (csrc/*.cu and the torch ops the port launches)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "encode_MBps"


def read(run):
    return run.kernels_roofline_pct("compress")
