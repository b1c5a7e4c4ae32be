"""Warmup capture plane: overlap the refine programs' CUDA graph captures
with ingest and prep (a copy of the JAX package's pipeline/warmup.py).

In the JAX package the first dispatch of every (group, shape) blocks the
driver thread for the whole XLA compile while the chip and the ingest pipe
both idle.  Here the counterpart of that compile is the CUDA graph capture
of the shape's refine program (pipeline/graphs.py): an eager priming run
(the torch ops' lazy module loads, the walk's shared-memory attribute,
allocator growth), then the capture itself, which issues every launch of
the step's ``iters + 1`` rounds from Python.  With canonical slab shapes
(pipeline/pack.py) a group's programs are PREDICTABLE the moment prep
yields its first RefineRequest (qmax/tmax/iters from the request, R from
the (<= ladder)-entry canonical height set), so this module captures them
on a background thread concurrently with ingest/prep, and the first real
dispatch of a warmed shape replays at steady-state speed.

Mechanism: the builder builds the program the dispatch path will claim
(the same process-wide cache entry, graphs.program) on an all-zero slab
and replays it once, blocking until the card is done.  A zero slab has an
all-False row mask, so every segment starts frozen and the replay changes
nothing; what it buys is the capture done off the dispatch path.

Attribution (utils/trace.py): each builder runs inside a
``device_span(..., warmup=True)`` carrying the SAME group and shape keys
the dispatch span will use, so the warmup books the (group, shape)'s one
capture as its compile, and the first real dispatch books as execute,
which is the trace-visible proof the overlap worked.  A warmup span for an
already-seen shape books nothing.

Coordination with the dispatch path: before dispatching a shape, the
executor calls ``claim(key)``: a still-queued warmup is cancelled (the
dispatch captures inline, exactly as without warmup), an in-flight one
returns an Event to wait on (the capture is already running on the other
thread; waiting costs no more than capturing and avoids a duplicate), a
finished or unknown one returns None.

On the card the port's plane is off unless ``--warmup`` is given
(cfg.warmup_compile); the JAX package's is on unless ``--no-warmup``.  Off,
the driver constructs no WarmupCompiler, and each shape's first slab runs
eagerly and its second captures (graphs.dispatch).  The port's dispatch
path waits for a predicted shape's build (``promote``) rather than
claiming it back.  Failures in a builder are
swallowed with a stderr note: the dispatch path builds inline and owns the
real failure (a program that cannot be built ends the run,
pipeline/graphs.py).
"""

from __future__ import annotations

import sys
import time
import threading
from typing import Callable, Dict, List, Optional, Tuple


class WarmupCompiler:
    """One background thread draining a FIFO of (key, builder) capture
    jobs.  Keys are arbitrary hashables (the executors use program-identity
    tuples); a key is only ever built once.

    ``debounce_s``: a job only STARTS once it has sat queued this long.
    Executors refine their shape predictions as admission accumulates
    holes (warm_refine's row accumulator) and cancel superseded keys
    via claim(), but a build that already started cannot be cancelled.
    The JAX package settles for half a second, noise against an XLA
    compile of tens of seconds.  A capture costs milliseconds and a whole
    run of a few dozen holes well under a second, so half a second would
    leave every prediction queued until its own dispatch claims it back;
    and a superseded prediction costs at most one capture, since the
    predicted heights are the group's canonical ones, which its tail
    slabs dispatch at anyway.  The default is no settle time.

    ``workers``: build threads.  The JAX package runs a small pool because
    XLA compiles release the interpreter lock.  A capture does not: it is
    Python issuing the step's launches, so a second thread adds no
    concurrency, only lock contention with the dispatch stream; and
    pipeline/graphs.py serializes captures anyway.  The default is one
    worker."""

    def __init__(self, debounce_s: float = 0.0,
                 workers: Optional[int] = None):
        self.debounce_s = max(0.0, float(debounce_s))
        if workers is None:
            workers = 1
        self._cv = threading.Condition()
        self._queue: List[Tuple[object, Callable[[], None], float]] = []
        self._state: Dict[object, str] = {}  # queued|running|claimed|done
        self._events: Dict[object, threading.Event] = {}
        self._stop = False
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"ccsx-warmup-{i}")
            for i in range(max(1, int(workers)))]
        for t in self._threads:
            t.start()

    def submit(self, key, builder: Callable[[], None],
               urgent: bool = False) -> bool:
        """Enqueue ``builder`` under ``key`` unless the key was ever
        submitted before (or the compiler is closed).  Returns whether
        the job was accepted.  ``urgent`` skips the debounce — for
        sweep-time EXACT shapes (no refinement can supersede them, and
        their dispatch is imminent).

        A CLAIMED (cancelled) key is resubmittable: prediction
        refinement cancels a superseded height, but the same height
        can become wanted again later (the dribble-tail warm after the
        group's prediction walked past it) — a permanent tombstone
        would silently drop exactly that resubmission.  If the claim
        came from a dispatch that captured inline, the re-build finds
        the program cached and costs one replay."""
        with self._cv:
            if self._stop or self._state.get(key) in ("queued",
                                                      "running", "done"):
                return False
            self._state[key] = "queued"
            t = time.monotonic() - (self.debounce_s if urgent else 0.0)
            self._queue.append((key, builder, t))
            self._cv.notify()
            return True

    def claim(self, key) -> Optional[threading.Event]:
        """Dispatch-path synchronization for ``key``:

        * queued  -> cancelled; returns None (caller captures inline —
                     no duplicated work, attribution lands on the
                     dispatch span as without warmup)
        * running -> returns the completion Event (caller should wait:
                     the capture is already happening concurrently)
        * done / claimed / never submitted -> None
        """
        with self._cv:
            st = self._state.get(key)
            if st == "queued":
                self._queue = [e for e in self._queue if e[0] != key]
                self._state[key] = "claimed"
                return None
            if st == "running":
                return self._events[key]
            return None

    def promote(self, key, timeout: Optional[float] = None) -> bool:
        """Dispatch-path synchronization for a caller that would rather
        wait for ``key``'s build than do it inline: a queued job jumps
        the queue (its debounce skipped) and, like a running one, is
        waited for.  Returns False on timeout; True once the key is
        built, never submitted, claimed, or the compiler closed."""
        with self._cv:
            if self._state.get(key) == "queued":
                self._queue = [(k, b, float("-inf") if k == key else t)
                               for k, b, t in self._queue]
                self._cv.notify_all()
            return self._cv.wait_for(
                lambda: self._stop or self._state.get(key) not in (
                    "queued", "running"), timeout=timeout)

    def busy(self) -> bool:
        """True while any accepted job is queued or building (the JAX
        package's serving plane reads it as its readiness probe)."""
        with self._cv:
            return bool(self._queue) or ("running"
                                         in self._state.values())

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted job has finished (a caller that
        wants every predicted program built before it times anything).
        Returns False on timeout."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._queue and "running" not in
                self._state.values(), timeout=timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Drop queued jobs, let in-flight builds finish, stop the
        threads.  Idempotent; safe from a driver finally block."""
        with self._cv:
            self._stop = True
            self._queue.clear()
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)

    def _run(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._stop:
                        return
                    if self._queue:
                        # debounce: give prediction refinement its
                        # cancellation window before committing.  Pick
                        # the EARLIEST-READY job, not the FIFO head: an
                        # urgent (pre-aged) sweep-time job must not sit
                        # behind a still-debouncing prediction, or its
                        # own dispatch claims it back and captures
                        # inline — the exact stall it exists to avoid.
                        now = time.monotonic()
                        i = min(range(len(self._queue)),
                                key=lambda j: self._queue[j][2])
                        wait = (self._queue[i][2] + self.debounce_s
                                - now)
                        if wait <= 0:
                            break
                        self._cv.wait(wait)
                    else:
                        self._cv.wait()
                key, builder, _ = self._queue.pop(i)
                self._state[key] = "running"
                ev = self._events[key] = threading.Event()
            try:
                builder()
            except Exception as e:  # the dispatch path owns the failure
                print(f"[ccsx-tpu-torch] warmup capture failed for {key!r} "
                      f"(dispatch will capture inline): {e}",
                      file=sys.stderr)
            finally:
                with self._cv:
                    self._state[key] = "done"
                    ev.set()
                    self._cv.notify_all()
