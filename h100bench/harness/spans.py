"""The card's idle gaps named by the program's own spans.

A traced window's idle gaps (harness/trace.py: where no kernel, copy or
set ran, on the host's ``perf_counter`` clock through the marker kernel)
split by the innermost span the driver thread had open at each instant,
summed by span name; time under no span is booked as ``OUTSIDE``.  The
spans are the port's in-memory capture (``ccsx_tpu_torch/utils/
capture.py``), on the same clock: no sampling interval, so no gap goes
unnamed for being short.

By hand, one traced run whose last line adds the split to the result::

    python3 -m h100bench.harness.spans --workload <cell> --seed <n> \\
        --seconds 51

It runs ``cell.main`` with ``--trace 1`` and a device trace that also
holds a capture of the window and its gap list, then prints
``{"idle_spans": [[name, seconds], ...], "idle_s": ..., "outside_share":
...}``: the ten largest, the idle seconds in all, and the share of them
under no span.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Tuple

OUTSIDE = "outside any span"


def innermost(records, thread) -> List[Tuple[float, float, str]]:
    """(start, end, name) segments of ``thread``'s span records, each
    named by the innermost span open over it (spans of one thread nest);
    OUTSIDE between them."""
    events = []
    for k, r in enumerate(records):
        if r.thread == thread and r.end > r.start:
            events.append((r.start, 1, k))
            events.append((r.end, 0, k))
    events.sort()                    # at one instant, closes before opens
    out: List[Tuple[float, float, str]] = []
    stack: List[int] = []
    t = None
    for at, opens, k in events:
        if t is not None and at > t:
            out.append((t, at, records[stack[-1]].name if stack
                        else OUTSIDE))
        t = at
        if opens:
            stack.append(k)
        else:
            stack.remove(k)
    return out


def split(gaps, records, thread) -> Dict[str, float]:
    """Seconds of the idle ``gaps`` [(start, end)] by the innermost span of
    ``thread`` open at each instant, OUTSIDE where none is."""
    segs = innermost(records, thread)
    out: Dict[str, float] = {}
    j = 0
    for a, b in sorted(gaps):
        t = a
        while j < len(segs) and segs[j][1] <= t:
            j += 1
        k = j
        while t < b:
            if k < len(segs) and segs[k][0] <= t:
                s0, s1, name = segs[k]
                end = min(b, s1)
                k += 1
            else:
                name = OUTSIDE
                end = min(b, segs[k][0]) if k < len(segs) else b
            if end > t:
                out[name] = out.get(name, 0.0) + (end - t)
            t = end
    return out


def device_gaps(tracer, lo: float, hi: float):
    """The idle gaps of a stopped DeviceTrace's window [lo, hi], as its
    ``analyse`` finds them."""
    from h100bench.harness.trace import busy_and_gaps

    ops = sorted(tracer.ops, key=lambda o: o[1])
    if not ops:
        return []
    mark, at = ops[0][1], tracer._marker_host
    spans = [((s - mark) * 1e-9 + at, (s + d - mark) * 1e-9 + at)
             for _, s, d in ops[1:]]
    return busy_and_gaps(spans, lo, hi)[1]


def main(argv=None) -> int:
    from ccsx_tpu_torch.utils import capture
    from h100bench.harness import cell, trace

    seen = {}

    class SpanTrace(trace.DeviceTrace):
        """The device trace with a capture of the same window."""

        def start(self):
            super().start()
            self.cap = capture.Capture().open()
            seen["trace"] = self

        def stop(self):
            self.cap.close()
            super().stop()

        def analyse(self, lo, hi):
            seen["window"] = (lo, hi)
            return super().analyse(lo, hi)

    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    trace.DeviceTrace = SpanTrace    # cell.run_cell imports it at call
    rc = cell.main(argv)
    t = seen.get("trace")
    if rc or t is None or "window" not in seen:
        return rc or 1
    gaps = device_gaps(t, *seen["window"])
    by = split(gaps, t.cap.records, t.cap.thread)
    idle = sum(b - a for a, b in gaps)
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({"idle_spans": [list(x) for x in top], "idle_s": idle,
                      "outside_share": by.get(OUTSIDE, 0.0) / idle
                      if idle else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
