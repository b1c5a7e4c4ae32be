"""Schema-drift ok twin: every key, the port's step counters included, is
exported."""

PROM_COUNTERS = ("holes_in", "slabs", "failed_steps")
PROM_GAUGES = ("elapsed_s",)
PROM_STRUCTURED = ("progress",)
