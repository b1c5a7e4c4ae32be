"""Useful rows over rows sent in the packed refine slabs (RunMetrics
``dp_rows_real`` / ``dp_rows_dispatched``)."""

LAYER = "batched driver and packer"
MOVES = "subread_bases_per_s"
UNIT = "%"


def read(obs):
    sent = obs.metrics.dp_rows_dispatched
    if not sent:
        return None
    return 100.0 * obs.metrics.dp_rows_real / sent
