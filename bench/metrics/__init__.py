"""One reader per per-layer metric, ``<metric>.py``, found by the metric's
name in ``BENCHMARK.json``. Each defines ``read(trace) -> float | None``."""
