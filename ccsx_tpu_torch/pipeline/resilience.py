"""Resilient execution: dispatch deadlines and a circuit breaker over the
card (a copy of the JAX package's pipeline/resilience.py).

Two mechanisms, both wired into the shared dispatch and recovery path of
``pipeline/batch.py``:

* **Dispatch deadlines** (``--dispatch-deadline``, 0 = off, the
  default): every batched device step's dispatch, and apart from it the
  device-to-host read of its output, runs as a bounded-wait call
  (``bounded_call``) on a fresh daemon thread.  On expiry the driver
  ABANDONS the wedged call: the thread is left parked, its eventual
  result lands in a slot nobody reads, and a ``DeadlineExpired``
  propagates into the recovery ladder, whose ``classify_failure`` maps it
  to the ``hang`` class — routed straight to the per-request replay: the
  per-hole round (``StarMsa.round``) on the same card, the bit-exact spec
  of every batched step, which is what the JAX package calls its host
  path.  Deadlines get the stall watchdog's first-of-shape allowance: the
  first bounded call of each (group, phase) gets ``grace`` x the budget
  (a first capture or a lazy module load is not a hang).

* **Circuit breaker** (``--breaker-strikes`` / ``--breaker-probe-s``):
  ``strikes`` qualifying failures — hangs and out-of-memory ladder
  bottoms; never per-hole ``data`` errors — within ``window_s`` trip the
  breaker OPEN: later groups skip the batched step and run per request
  (counted as ``host_fallbacks`` with reason ``breaker_open``).  With
  ``probe_s > 0`` the breaker goes HALF-OPEN every ``probe_s`` seconds:
  one group is dispatched as a probe; success closes the breaker, failure
  re-opens it and re-arms the timer.  State, trips, probes and the
  bounded strike log ride ``Metrics`` into ``/metrics``, ``/healthz``,
  ``stats`` and the HTML report.

Neither mechanism can change output bytes: they only choose which path a
request computes on, and both paths launch the same hand-written kernels
on the same card.  A kernel that never ends is out of their reach: the
replay's launches queue behind it on the card, so the process cannot
finish; the stall watchdog reports it and ``shepherd
--rank-stall-timeout`` kills and restarts such a rank.  A kernel that does
not build or launch is no strike either: it ends the run
(``cuda_ext.KernelError``, rc 1).
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Optional

from ccsx_tpu_torch.utils import faultinject

# first-of-(group, phase) bounded calls get grace x the deadline — the
# same first-of-shape allowance as the stall watchdog's COMPILE_GRACE.
# Env override (CCSX_DEADLINE_GRACE) exists for tests and chaos runs
# that need deterministic small budgets without minute-long waits.
DEFAULT_GRACE = 10.0


def _grace() -> float:
    try:
        return max(float(os.environ.get("CCSX_DEADLINE_GRACE",
                                        DEFAULT_GRACE)), 1.0)
    except ValueError:
        return DEFAULT_GRACE


class DeadlineExpired(RuntimeError):
    """A bounded device call outlived its deadline and was abandoned.

    classify_failure (pipeline/batch.py) maps this to the ``hang``
    failure class: no resplit, no retry — straight to the per-request
    replay.  The wedged worker thread keeps running detached; its result,
    if it ever arrives, is discarded by slot identity."""

    def __init__(self, label: str, phase: str, budget_s: float):
        super().__init__(
            f"device {phase} for group {label!r} exceeded its "
            f"{budget_s:g}s dispatch deadline; abandoning the wedged "
            "call and replaying per request on the per-hole path")
        self.label = label
        self.phase = phase
        self.budget_s = budget_s


def bounded_call(fn, timeout_s: float, label: str = "",
                 phase: str = "dispatch"):
    """Run ``fn()`` with a bounded wait; raise DeadlineExpired on
    expiry.  ``timeout_s <= 0`` calls inline (no thread, no overhead —
    the resilience-off fast path).

    One fresh daemon thread per call: dispatch rates are tens per
    second at most (one per shape group per sweep), so thread-spawn
    cost is noise, and per-call slots make abandonment race-free — a
    wedged call's eventual completion writes into a slot nobody reads.
    The thread is daemonic: a call that never returns must not block
    process exit."""
    if timeout_s is None or timeout_s <= 0:
        return fn()
    done = threading.Event()
    slot = {}

    def _run():
        try:
            slot["result"] = fn()
        except BaseException as e:  # delivered to the waiter
            slot["exc"] = e
        finally:
            done.set()

    # inherit() carries the caller's whole context into the worker: a
    # serve job's fault scope (its device_hang must fire inside ITS
    # bounded dispatch), its launch scope (ops/cuda_ext.scope) and its
    # trace cid
    t = threading.Thread(target=faultinject.inherit(_run), daemon=True,
                         name=f"ccsx-bounded-{phase}")
    t.start()
    if done.wait(timeout_s):
        if "exc" in slot:
            raise slot["exc"]
        return slot.get("result")
    raise DeadlineExpired(label, phase, timeout_s)


class CircuitBreaker:
    """Thread-safe closed/open/half-open breaker over device dispatch.

    Callers: ``admit()`` before dispatching a shape group ('host' =
    route the group to the per-request replay), ``strike(kind, group)`` on a
    qualifying failure, ``success()`` after any group materializes.
    The driver thread and the pair-gate pump thread both dispatch
    concurrently, so every transition holds the lock.

    ``strikes <= 0`` disables the breaker entirely (always closed).
    ``probe_s <= 0`` means a tripped breaker stays open for the rest of
    the run (every remaining group completes per request).
    """

    LOG_MAX = 32

    def __init__(self, strikes: int = 3, window_s: float = 60.0,
                 probe_s: float = 0.0, metrics=None):
        self.strikes = int(strikes)
        self.window_s = max(float(window_s), 0.0)
        self.probe_s = max(float(probe_s), 0.0)
        self.metrics = metrics
        self.state = "closed"
        self._recent: collections.deque = collections.deque()
        self._log: collections.deque = collections.deque(
            maxlen=self.LOG_MAX)
        self._opened_at: Optional[float] = None
        self._probing = False
        self._lock = threading.Lock()

    # ---- state plumbing --------------------------------------------------

    def _set_state(self, state: str) -> None:
        self.state = state
        if self.metrics is not None:
            self.metrics.breaker_state = state

    def _publish_log(self) -> None:
        if self.metrics is not None:
            self.metrics.breaker_strike_log = list(self._log)

    # ---- the breaker contract -------------------------------------------

    def admit(self) -> str:
        """'closed' = dispatch normally, 'probe' = dispatch as THE
        half-open probe (the caller must resolve it with
        probe_succeeded / strike(probe=True) / settle_probe), 'host' =
        route the group to the per-request replay.  The probe verdict is
        tied to the admitted group through this return value, NOT inferred from
        whichever thread finishes next — the driver and the pair-gate
        pump dispatch concurrently, and a pre-trip group materializing
        mid-probe must neither close the breaker on stale evidence nor
        steal the probe's settlement."""
        if self.strikes <= 0:
            return "closed"
        with self._lock:
            if self.state == "closed":
                return "closed"
            if (self.probe_s > 0 and not self._probing
                    and time.monotonic() - self._opened_at
                    >= self.probe_s):
                self._probing = True
                self._set_state("half-open")
                if self.metrics is not None:
                    self.metrics.bump(breaker_probes=1)
                print("[ccsx-tpu-torch] circuit breaker half-open: probing "
                      "the device with one group", file=sys.stderr)
                return "probe"
            return "host"

    def probe_succeeded(self) -> None:
        """THE probe group materialized cleanly: close the breaker
        (device traffic resumes).  Only the probe's own completion
        carries this verdict — ordinary successes never touch state."""
        if self.strikes <= 0:
            return
        with self._lock:
            if self._probing:
                self._probing = False
                self._recent.clear()
                self._set_state("closed")
                print("[ccsx-tpu-torch] circuit breaker closed: probe "
                      "dispatch succeeded, device traffic resumes",
                      file=sys.stderr)

    def settle_probe(self) -> None:
        """THE probe resolved WITHOUT a verdict on backend health —
        e.g. it failed with a per-hole `data` error, which never
        strikes.  The probe token must still be released (or the
        breaker wedges half-open forever: admit() refuses everything
        while a probe is outstanding) — back to open with a fresh
        probe timer."""
        if self.strikes <= 0:
            return
        with self._lock:
            if self._probing:
                self._probing = False
                self._opened_at = time.monotonic()
                self._set_state("open")
                print("[ccsx-tpu-torch] circuit breaker probe inconclusive "
                      "(non-device failure); re-opening, next probe in "
                      f"{self.probe_s:g}s", file=sys.stderr)

    def strike(self, kind: str, group: str, probe: bool = False) -> None:
        """A qualifying failure (hang / OOM ladder-bottom).
        ``strikes`` of them within ``window_s`` trip the breaker; a
        failed probe (``probe=True`` — the caller dispatched under an
        admit() == 'probe' token) re-opens it immediately."""
        if self.strikes <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self._log.append({"ts": round(time.time(), 3),
                              "kind": kind, "group": group})
            self._publish_log()
            if probe and self._probing:
                self._probing = False
                self._opened_at = now
                self._set_state("open")
                print(f"[ccsx-tpu-torch] circuit breaker re-opened: probe "
                      f"failed ({kind} on {group})", file=sys.stderr)
                return
            if self.state != "closed":
                return
            self._recent.append(now)
            while self._recent and now - self._recent[0] > self.window_s:
                self._recent.popleft()
            if len(self._recent) >= self.strikes:
                self._opened_at = now
                self._set_state("open")
                self._recent.clear()
                if self.metrics is not None:
                    self.metrics.bump(breaker_trips=1)
                probe = (f"; re-probing every {self.probe_s:g}s"
                         if self.probe_s > 0 else
                         "; no re-probe configured "
                         "(--breaker-probe-s), batched steps stay off "
                         "for the rest of the run")
                print(f"[ccsx-tpu-torch] CIRCUIT BREAKER OPEN: "
                      f"{self.strikes} device failures within "
                      f"{self.window_s:g}s (last: {kind} on {group}) — "
                      f"remaining work "
                      f"runs per request on the per-hole path{probe}",
                      file=sys.stderr)


class Resilience:
    """Per-run facade bundling the deadline runner + breaker; shared by
    BatchExecutor and PairExecutor (pipeline/batch.py) so strikes from
    pair fills and refine dispatches count against one breaker."""

    def __init__(self, cfg, metrics=None):
        self.metrics = metrics
        self.deadline_s = max(
            float(getattr(cfg, "dispatch_deadline_s", 0.0) or 0.0), 0.0)
        self.grace = _grace()
        self.breaker = CircuitBreaker(
            strikes=int(getattr(cfg, "breaker_strikes", 3)),
            window_s=float(getattr(cfg, "breaker_window_s", 60.0)),
            probe_s=float(getattr(cfg, "breaker_probe_s", 0.0)),
            metrics=metrics)
        self._grace_seen: set = set()
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.deadline_s > 0

    def admit(self) -> str:
        """'closed' | 'probe' | 'host' (CircuitBreaker.admit)."""
        return self.breaker.admit()

    def budget(self, label: str, phase: str) -> float:
        """Deadline for one bounded call: the first call of each
        (group, phase) gets the grace (the watchdog's rule — a shape's
        first capture, or a torch op's lazy module load, must not be
        classified a hang)."""
        with self._lock:
            key = (label, phase)
            first = key not in self._grace_seen
            self._grace_seen.add(key)
        return self.deadline_s * (self.grace if first else 1.0)

    def call(self, fn, label: str, phase: str):
        """Deadline-bounded call (inline when deadlines are off)."""
        if not self.enabled:
            return fn()
        return bounded_call(fn, self.budget(label, phase), label, phase)

    def note_hang(self, label: str, exc: BaseException,
                  probe: bool = False) -> None:
        """Book one abandoned dispatch: counter, degraded mark (a run
        that lost a device call is not clean even though its output
        is), and a breaker strike."""
        if self.metrics is not None:
            self.metrics.bump(device_hangs=1)
            if not self.metrics.degraded:
                self.metrics.degraded = (
                    f"dispatch deadline expired: {exc}")
        self.breaker.strike("hang", label, probe=probe)
