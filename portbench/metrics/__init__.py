"""Per-layer metrics, one reader a file: metrics/<name>.py defines
read(trace) -> float | None over the traced run's records (trace.Trace).
A reader that finds nothing to read returns None, and the metric is left
out of the run's line."""
