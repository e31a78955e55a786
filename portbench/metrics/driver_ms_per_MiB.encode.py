"""The program's top-level StatPhases of the driver, "Select algorithm",
"Escape input" and "Join output", summed, ms per MiB of input."""

LAYER = "driver (driver.py, io/)"
UNIT = "ms/MiB"
SOURCE = "program_span"
MOVES = "encode_MBps"
TITLES = ("Select algorithm", "Escape input", "Join output")


def read(run):
    got = [v for v in (run.phase_ms_per_mib("compress", t) for t in TITLES) if v is not None]
    return sum(got) if got else None
