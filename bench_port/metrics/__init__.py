"""Per-layer metrics, one reader each, found by the metric's name in
BENCHMARK.json: ``read(ctx)`` returns the metric's value from a traced run, or
None where the trace holds nothing to read (never 0 for a share)."""
