"""Device dispatches a thousand holes written (RunMetrics
``device_dispatches`` x 1000 / ``holes_out``)."""

LAYER = "refine executor"
MOVES = "subread_bases_per_s"
UNIT = "1/khole"


def read(obs):
    if not obs.metrics.holes_out:
        return None
    return 1000.0 * obs.metrics.device_dispatches / obs.metrics.holes_out
