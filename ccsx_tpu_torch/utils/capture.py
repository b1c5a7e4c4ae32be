"""In-memory span capture: the installed tracer's spans (utils/trace.py)
kept in a list while a capture is open, on the host's
``time.perf_counter()`` clock.  The port's own; the JAX package has none.

``with capture.Capture() as cap:`` makes every plain span and device
span of the installed Tracer, on any thread, append one ``SpanRecord`` to
``cap.records``, whatever ``--trace`` and ``CCSX_BLACKBOX`` say.  Nothing
is serialised, flushed or forced: ``Span.force`` synchronises only under
a trace file, so a captured device span times the host's launch and a
captured run keeps its launch queue.  With no capture open a span costs
what it did: one more check before the null span.

A record holds the span's name and category, its thread
(``threading.get_ident()``), its start and end (``time.perf_counter()``
at open and close: the clock onto which torch.profiler's device
timestamps are mapped through a marker kernel of known host time), its
self seconds (its own minus its nested spans' on its thread) and, for a
plain span on a thread that opened a capture, the CPU seconds the thread
spent inside it (``time.thread_time()``; None otherwise): wall minus CPU
is time the thread was blocked, or runnable but off a CPU.  The thread
clock is a system call, 3-20 us on the card's host under load against
0.1 us for ``perf_counter``, so it is read only there.

``pipeline/run.run_pipeline`` opens one for its run while torch.profiler
is recording (``--profile``, a profiled benchmark window) and leaves it
on the run's metrics (``RunMetrics.capture``); ``Capture.thread`` is
then the thread that called it, the batched driver's.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import List, Optional

SpanRecord = collections.namedtuple(
    "SpanRecord", "name cat thread start end self_s cpu_s")

# the open captures, changed in place (a Tracer holds this list)
ACTIVE: List["Capture"] = []
_lock = threading.Lock()


class Capture:
    """The spans recorded between ``__enter__`` and ``__exit__`` (or
    ``open`` and ``close``), in close order."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.thread: Optional[int] = None    # the thread that opened it
        self.start: Optional[float] = None
        self.end: Optional[float] = None

    def open(self) -> "Capture":
        self.thread = threading.get_ident()
        self.start = time.perf_counter()
        with _lock:
            ACTIVE.append(self)
        return self

    def close(self) -> None:
        with _lock:
            if self in ACTIVE:
                ACTIVE.remove(self)
        self.end = time.perf_counter()

    def __enter__(self) -> "Capture":
        return self.open()

    def __exit__(self, *exc) -> None:
        self.close()


def cpu_start(caps) -> Optional[float]:
    """The thread clock at a plain span's open, on a thread that opened
    one of ``caps``; None elsewhere."""
    me = threading.get_ident()
    if any(c.thread == me for c in caps):
        return time.thread_time()
    return None


def keep(caps, name: str, cat: str, start: float, end: float,
         self_s: float, cpu0: Optional[float]) -> None:
    """Append one closed span to each capture in ``caps`` (those open when
    it opened); ``cpu0`` is ``cpu_start``'s reading, or None."""
    cpu_s = None if cpu0 is None else time.thread_time() - cpu0
    rec = SpanRecord(name, cat, threading.get_ident(), start, end, self_s,
                     cpu_s)
    for c in caps:
        c.records.append(rec)


def profiling() -> bool:
    """Whether torch.profiler is recording in this process.  Never
    imports torch."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    return bool(getattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False))
