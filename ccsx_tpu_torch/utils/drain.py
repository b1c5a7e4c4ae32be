"""Graceful drain on SIGTERM/SIGINT (a copy of the JAX package's
utils/drain.py).

Production CCS jobs run on preemptible capacity: the scheduler sends
SIGTERM and the process has seconds to make its work durable.  Without
a handler, Python's default SIGTERM kills mid-hole — safe (journal v2's
torn-tail truncation repairs the output on resume) but wasteful, and
SIGINT raises KeyboardInterrupt through whatever stack frame is live.

``DrainGuard`` turns both signals into a cooperative drain: the first
signal sets a flag the drivers poll at their admission points — they
stop admitting new holes, finish every in-flight group, flush the
writer, settle the journal, and exit ``exitcodes.RC_INTERRUPTED`` (75,
EX_TEMPFAIL: resumable — re-running the same command with the same
--journal continues to a byte-identical output).  A second signal
restores the previous handlers, so a third behaves as if the guard were
never installed (the operator's escape hatch from a wedged drain).

Signal handlers can only be installed from the main thread; anywhere
else (e.g. a driver running under a test harness thread) install()
degrades to a no-op guard whose flag never fires — the historical
behavior, never an error.
"""

from __future__ import annotations

import signal
import sys
import threading

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class DrainGuard:
    """Install with DrainGuard.install(); poll ``.requested``; restore
    the previous handlers with ``.restore()`` (drivers do so in their
    ``finally`` so nested/successive runs in one process stack
    cleanly)."""

    def __init__(self):
        self.requested = False
        self._signum = None
        self._prev = {}
        self._installed = False

    @classmethod
    def install(cls) -> "DrainGuard":
        g = cls()
        if threading.current_thread() is not threading.main_thread():
            return g   # no-op guard: flag never fires
        try:
            for sig in _SIGNALS:
                g._prev[sig] = signal.signal(sig, g._handle)
            g._installed = True
        except (ValueError, OSError):
            g._prev.clear()
        return g

    def _handle(self, signum, frame) -> None:
        if self.requested:
            # second signal: hand control back to the previous
            # handlers — the third signal then acts on them
            self.restore()
            print("[ccsx-tpu-torch] second signal during drain: restoring "
                  "default handlers (next one is fatal)",
                  file=sys.stderr)
            return
        self.requested = True
        self._signum = signum
        print(f"[ccsx-tpu-torch] {signal.Signals(signum).name}: draining — "
              "admission stopped, finishing in-flight holes, then "
              "flushing writer + journal (resumable rc 75)",
              file=sys.stderr)

    def restore(self) -> None:
        if not self._installed:
            return
        self._installed = False
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass


class FlagGuard:
    """A drain-guard surrogate for EMBEDDED drivers (the JAX package's
    serving plane, not ported; kept with the copy): same ``.requested``
    / ``.restore()`` surface as DrainGuard, but raised by its owner — a job cancel (DELETE), the
    job deadline, or a server-wide drain fanning out — instead of a
    process signal.  Signal handlers belong to exactly one owner per
    process; under ``ccsx-tpu serve`` that owner is the server's main
    thread, and each job drains through one of these."""

    def __init__(self):
        self._ev = threading.Event()
        self.reason: str = ""

    @property
    def requested(self) -> bool:
        return self._ev.is_set()

    def request(self, reason: str = "") -> None:
        if reason and not self.reason:
            self.reason = reason
        self._ev.set()

    def restore(self) -> None:  # no handlers to restore
        pass
