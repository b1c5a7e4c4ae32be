"""Process exit-code taxonomy (a copy of the JAX package's exitcodes.py).

* ``RC_OK`` (0) — the run completed and the output is trustworthy.
* ``RC_FATAL`` (1) — a clean operational refusal or failure: invalid input
  stream, unwritable output path, bad flags, an unported mode.
* ``RC_FAILED_HOLES`` (2) — a failure budget was exceeded.
* ``RC_INTERRUPTED`` (75, EX_TEMPFAIL) — a graceful, resumable drain.
* ``RC_INJECTED_KILL`` (57) — a fault-injection hard exit.

Both drivers of this package return 0, 1 and 2 (``--max-failed-holes``,
utils/metrics.check_failure_budget); 75 and 57 wait for the drain and
fault-injection planes and are kept so the numbering cannot drift from the
reference.
"""

RC_OK = 0
RC_FATAL = 1
RC_FAILED_HOLES = 2
RC_INTERRUPTED = 75
RC_INJECTED_KILL = 57

__all__ = ["RC_OK", "RC_FATAL", "RC_FAILED_HOLES", "RC_INTERRUPTED",
           "RC_INJECTED_KILL"]
