"""The least time for the container read once and the file written once, at 3.35 TB/s, over the summed kernel time (no copies) of the decompress calls."""

LAYER = "kernels (csrc/*.cu and the torch ops the port launches)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "decode_MBps"


def read(run):
    return run.kernels_roofline_pct("decompress")
