"""The benchmark harness of ``repro_torch``: finds a cell's configuration,
traffic mix and per-layer metrics by the names in ``BENCHMARK.json``,
drives the program, reads its counters and the profiler's trace, and
holds the answers against the plain reference in ``reference/``."""
