"""Deterministic fault-injection harness (a copy of the JAX package's
utils/faultinject.py; only the ``device_oom`` action differs).

Every recovery path of the port — per-hole quarantine, the OOM bisection
ladder and its per-request replay, torn-tail journal recovery, the drain,
salvage ingest — must be provable on the CPU in the tests and on the card
by ``chip_smoke.py``, which requires failures that fire on demand and on a
deterministic schedule.

Arming: the ``CCSX_FAULTS`` env var or the ``--inject-faults`` CLI flag,
with a comma-separated spec of ``point@N`` entries:

    CCSX_FAULTS="device_oom@1,write@3"

``point@N`` fires on the Nth call of that point (once); ``point@N+``
fires on every call from the Nth on; bare ``point`` means ``point@1``.
Schedules are call-count based, so a given input + spec reproduces the
same failure every run.

Points and their actions (each placed at ONE spot in the pipeline, the
JAX package's):

  ingest      raise ValueError at the stream read — the drivers' clean
              rc=1 invalid-input path, no traceback
  compute     raise RuntimeError inside a hole's consensus step — the
              per-hole quarantine path (one bad hole never kills a run)
  device_oom  raise torch.cuda.OutOfMemoryError before a batched device
              step — the OOM bisection ladder and its per-request replay
              (pipeline/batch.py classifies failures by type)
  stall       sleep CCSX_FAULT_STALL_S seconds (default 1.0) INSIDE a
              device step, while its trace span is open — the
              deterministic hang that proves the stall watchdog
              (utils/trace.py, --stall-timeout) fires and dumps; the
              step then completes normally
  device_hang sleep CCSX_FAULT_HANG_S seconds (default 3600) inside a
              device step — a permanent wedge at test scale.  Only the
              dispatch deadline (--dispatch-deadline,
              pipeline/resilience.py) rescues the run: the call is
              abandoned and its group replays per request on the
              per-hole path; with deadlines off the run stalls, the
              watchdog dumps (never kills), and the run completes when
              the sleep ends
  rank_death  hard process exit (os._exit) at a hole-retirement point
              in the batched driver — models a rank dying mid-run
              (SIGKILL/OOM-killer) and leaving a valid journal behind
  write       hard process exit (os._exit) after a record is written and
              flushed but BEFORE the journal advances — the torn-tail
              crash the journal v2 resume must repair
  journal     hard process exit inside a journal DISK update, after the
              tmp journal is fsynced but BEFORE the atomic replace —
              proves the journal update itself is atomic.  Disk updates
              are rate-limited (utils/journal.py fsync_interval_s); set
              CCSX_JOURNAL_FSYNC_S=0 for a deterministic per-advance
              schedule
  input_corrupt  raise a classified CorruptionError (reason
              "injected") at the stream read — with --salvage the
              drivers book a corrupt hole and continue (the salvage
              rung, drivable without a crafted file); without it, the
              clean rc-1 invalid-input path
  disk_full   raise OSError(ENOSPC) inside the output writer's put — the
              run must exit through the clean rc-1 path with the journal
              consistent (no traceback, no torn record past the
              journaled offset), and a resume must complete
              byte-identical
  sigterm     deliver a real SIGTERM to this process at a hole
              retirement (signal.raise_signal, so the drivers'
              graceful-drain handler runs exactly as it would for an
              external kill) — deterministic drain-and-resume testing

The hard exits use ``os._exit`` (no atexit, no finally blocks, writer
not closed) to model SIGKILL as closely as a same-process mechanism can.

Scoped arming (``scope_arm``, ``inherit``) is the JAX package's per-job
fault domain for a resident server, kept so the module stays a copy: a
plan carried by a ``contextvars.ContextVar`` applies to the calling thread
and to threads whose target was wrapped with ``inherit()``; while a scope
is set, the global plan is ignored for that thread family.

The module imports nothing beyond the standard library at import time
(torch only inside the ``device_oom`` action), so the torch-free
subcommands can import what imports it.
"""

from __future__ import annotations

import contextvars
import os
import threading
from typing import Dict, Optional

POINTS = ("ingest", "compute", "device_oom", "stall", "device_hang",
          "rank_death", "write", "journal", "input_corrupt",
          "disk_full", "sigterm")

# exit code of the write/journal crash actions — distinctive, so a test
# (or an operator) can tell an injected kill from a real failure
EXIT_CODE = 57

_UNSET = object()
# point -> [fire_at_call, repeat(bool)]; None = disarmed; _UNSET = not
# yet initialized from the environment
_plan = _UNSET
_calls: Dict[str, int] = {}
# fire() runs on worker threads too (run_pipeline -j>1 computes holes on
# a pool): the call counter must be atomic or an @N schedule can be
# skipped under a racy read-modify-write
_lock = threading.Lock()

# the per-context (per-job) fault domain; None = use the global plan
_scope_var: "contextvars.ContextVar[Optional[Scope]]" = \
    contextvars.ContextVar("ccsx_fault_scope", default=None)


class Scope:
    """One fault domain: a plan plus its own call counters, so two
    jobs arming the same point@N spec each see their own schedule."""

    def __init__(self, spec: Optional[str]):
        self.plan = parse_spec(spec) if spec else None
        self.calls: Dict[str, int] = {}
        self.lock = threading.Lock()


def scope_arm(spec: Optional[str]):
    """Arm ``spec`` for the current context (and for threads spawned
    through ``inherit()``-wrapped targets).  A falsy spec arms an EMPTY
    domain — the caller is isolated from the global plan but fires
    nothing.  Returns a token for ``scope_reset``."""
    return _scope_var.set(Scope(spec))


def scope_reset(token) -> None:
    _scope_var.reset(token)


def current_scope() -> Optional[Scope]:
    return _scope_var.get()


def inherit(fn):
    """Wrap a thread target so the new thread runs in a COPY of the
    spawning thread's context (carrying its fault scope): plain
    ``threading.Thread`` starts every target in a fresh context, which
    would silently drop a job's fault domain at the first pool or
    deadline-runner hop."""
    ctx = contextvars.copy_context()

    def _run(*args, **kwargs):
        return ctx.run(fn, *args, **kwargs)

    return _run


def parse_spec(spec: str) -> dict:
    """``"point@N[+],..."`` -> {point: [n, repeat]}; ValueError on junk."""
    plan = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        point, _, at = item.partition("@")
        repeat = at.endswith("+")
        n = at[:-1] if repeat else at
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r} (choose from {POINTS})")
        try:
            nth = int(n) if n else 1
        except ValueError:
            raise ValueError(f"bad fault schedule {item!r}: expected "
                             "point@N or point@N+") from None
        if nth < 1:
            raise ValueError(f"fault schedule {item!r}: N must be >= 1")
        plan[point] = [nth, repeat]
    return plan


def arm(spec: Optional[str]) -> None:
    """Arm (or with a falsy spec, disarm) the harness; resets call counts."""
    global _plan
    _plan = parse_spec(spec) if spec else None
    _calls.clear()


def disarm() -> None:
    arm(None)


def armed(point: Optional[str] = None) -> bool:
    scope = _scope_var.get()
    if scope is not None:
        plan = scope.plan
    else:
        _ensure_init()
        plan = _plan
    if plan is None:
        return False
    return point in plan if point else bool(plan)


def _ensure_init() -> None:
    # lazy env arming keeps import free of side effects and lets the CLI
    # flag override the environment (arm() is explicit).  A malformed
    # CCSX_FAULTS must fail ATTRIBUTED to the env var, not surface as a
    # ValueError inside whatever pipeline stage fired first (where the
    # drivers would misreport it as an input-stream error) — so it
    # escalates to SystemExit, which no recovery layer swallows.
    global _plan
    if _plan is _UNSET:
        try:
            _plan = parse_spec(os.environ.get("CCSX_FAULTS", "")) or None
        except ValueError as e:
            _plan = None
            raise SystemExit(f"Error: CCSX_FAULTS: {e}") from None


def fire(point: str) -> None:
    """Injection point hook: a no-op unless this point is armed and its
    schedule says this call is the one.  Raises/exits per the point's
    documented action.  A thread carrying a fault scope consults ONLY
    that scope's plan and counters (its job's fault domain)."""
    scope = _scope_var.get()
    if scope is not None:
        plan, calls, lock = scope.plan, scope.calls, scope.lock
    else:
        _ensure_init()
        plan, calls, lock = _plan, _calls, _lock
    if plan is None or point not in plan:
        return
    with lock:
        calls[point] = n = calls.get(point, 0) + 1
    fire_at, repeat = plan[point]
    if n != fire_at and not (repeat and n >= fire_at):
        return
    import sys

    print(f"[ccsx-tpu-torch] faultinject: firing {point!r} (call {n})",
          file=sys.stderr)
    if point == "ingest":
        raise ValueError(f"injected ingest fault (faultinject, call {n})")
    if point == "input_corrupt":
        # deferred import: corruption.py must stay importable without
        # this module's side effects and vice versa
        from ccsx_tpu_torch.io.corruption import CorruptionError

        raise CorruptionError(
            "injected",
            f"injected input corruption (faultinject, call {n})")
    if point == "disk_full":
        import errno

        raise OSError(errno.ENOSPC,
                      f"No space left on device (injected, call {n})")
    if point == "sigterm":
        import signal

        signal.raise_signal(signal.SIGTERM)
        return
    if point == "compute":
        raise RuntimeError(
            f"injected compute fault (faultinject, call {n})")
    if point == "device_oom":
        # the port's ladder classifies by type, not by message
        import torch

        raise torch.cuda.OutOfMemoryError(
            f"CUDA out of memory (injected, call {n})")
    if point in ("stall", "device_hang"):
        # a hang, not a failure: sleep with the dispatch span open.
        # `stall` is transient (the dispatch then completes — proves
        # the watchdog fires); `device_hang` is effectively permanent
        # at its default of 1 h (the dispatch deadline abandons it; the
        # parked thread is daemonic and dies with the process)
        import time

        env, dflt = (("CCSX_FAULT_STALL_S", 1.0) if point == "stall"
                     else ("CCSX_FAULT_HANG_S", 3600.0))
        try:
            dur = float(os.environ.get(env, str(dflt)))
        except ValueError:
            dur = dflt
        time.sleep(max(dur, 0.0))
        return
    # write / journal / rank_death: simulated SIGKILL — flush the
    # injection notice, then exit without running any cleanup
    sys.stderr.flush()
    os._exit(EXIT_CODE)
