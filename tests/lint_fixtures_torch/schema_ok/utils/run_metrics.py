"""Schema-drift ok twin: the port's step counters, from PORT_KEYS."""

PORT_KEYS = ("slabs", "failed_steps")


class RunMetrics:
    def snapshot(self):
        snap = {}
        snap.update((k, getattr(self, k)) for k in PORT_KEYS)
        return snap
