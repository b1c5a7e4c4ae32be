"""Share of the window the driver thread waited on the card's read-back
(its ``materialize`` spans: the device-to-host read of a step's output,
which waits for the step)."""

from h100bench.metrics import _spans

LAYER = "device"
MOVES = "subread_bases_per_s"
UNIT = "%"


def read(obs):
    spans = _spans.driver_spans(obs)
    if spans is None:
        return None
    return 100.0 * sum(r.end - r.start for r in spans
                       if r.name == "materialize") / obs.window_s
