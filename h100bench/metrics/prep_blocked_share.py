"""Share of the window the driver waited on the prep plane with nothing to
dispatch (RunMetrics ``prep_blocked_s``)."""

LAYER = "prep plane"
MOVES = "subread_bases_per_s"
UNIT = "%"


def read(obs):
    if not obs.window_s:
        return None
    return 100.0 * obs.metrics.t_prep_blocked / obs.window_s
