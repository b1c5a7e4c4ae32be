"""Schema-drift ok twin: the JAX package's snapshot."""


class Metrics:
    holes_in = 0

    def snapshot(self):
        snap = {"holes_in": self.holes_in}
        if self.holes_in:
            snap["elapsed_s"] = 0.0
        return snap
