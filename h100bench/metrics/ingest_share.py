"""Share of the window the ingest stage took (RunMetrics ``ingest_s``)."""

LAYER = "ingest"
MOVES = "subread_bases_per_s"
UNIT = "%"


def read(obs):
    if not obs.window_s:
        return None
    return 100.0 * obs.metrics.t_ingest / obs.window_s
