"""The benchmark harness: found by name from BENCHMARK.json (catalog)."""
