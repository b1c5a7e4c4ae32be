"""Host milliseconds a packed refine dispatch on the driver thread: self
seconds of its ``slab_pack``, ``refine_packed`` (the unforced launch:
staging and the graph replay's enqueue) and ``unpack`` spans, x 1000,
over the number of ``refine_packed`` spans."""

from h100bench.metrics import _spans

LAYER = "refine executor"
MOVES = "subread_bases_per_s"
UNIT = "ms"


def read(obs):
    spans = _spans.driver_spans(obs)
    if spans is None:
        return None
    n = sum(r.name == "refine_packed" for r in spans)
    if not n:
        return None
    host_s = _spans.self_s(spans, "slab_pack", "refine_packed", "unpack")
    return 1000.0 * host_s / n
