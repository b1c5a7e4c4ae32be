"""Per-layer metric readers, one file a metric, found by the metric's name
(harness/spec.reader).  Each has ``LAYER`` (its layer in PERF.md's list),
``MOVES`` (the end-to-end metric it should move), ``UNIT`` and
``read(obs)``: the value from the run's record (harness/cell.Observed), or
None where the run has nothing to read."""
