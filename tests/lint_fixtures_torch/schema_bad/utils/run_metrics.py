"""Schema-drift bad twin: a step counter ('orphan_step') that no export
tuple documents."""

PORT_KEYS = ("slabs", "orphan_step")


class RunMetrics:
    def snapshot(self):
        snap = {}
        snap.update((k, getattr(self, k)) for k in PORT_KEYS)
        return snap
