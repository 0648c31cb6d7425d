"""Per-layer metric readers, one file per metric of BENCHMARK.json, each
with ``read(run) -> float | None``."""
