"""Share of the window the driver thread spent stepping the holes'
generators after a refine sweep (self seconds of its ``hole_step``
spans): the vote epilogue and the next window's draft."""

from h100bench.metrics import _spans

LAYER = "hole generators"
MOVES = "subread_bases_per_s"
UNIT = "%"


def read(obs):
    spans = _spans.driver_spans(obs)
    if spans is None:
        return None
    return 100.0 * _spans.self_s(spans, "hole_step") / obs.window_s
