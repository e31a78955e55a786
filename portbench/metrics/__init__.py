"""Per-layer metrics, one file each, found by the metric's name. Each file
gives LAYER, UNIT, SOURCE and MOVES as BENCHMARK.json has them, and
read(run) -> float | None (harness.Run); None leaves the metric out."""
