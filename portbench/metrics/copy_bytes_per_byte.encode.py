"""Bytes copied between the card and the host (the program's copy funnel,
device.to_host / to_device) per byte of the compress calls' input."""

from portbench.counters import per_input

LAYER = "host-device copies (device.py funnel)"
UNIT = "B/B"
SOURCE = "program_counter"
MOVES = "encode_MBps"


def read(run):
    return per_input(run, "compress", ("copy.to_host_bytes", "copy.to_device_bytes"))
