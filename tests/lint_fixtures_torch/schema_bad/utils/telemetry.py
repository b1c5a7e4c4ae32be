"""Schema-drift bad twin: PROM_COUNTERS exports the port's 'slabs' but not
'orphan_step'."""

PROM_COUNTERS = ("holes_in", "slabs")
PROM_GAUGES = ("elapsed_s",)
PROM_STRUCTURED = ("progress",)
