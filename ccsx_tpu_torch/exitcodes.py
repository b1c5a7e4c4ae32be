"""Process exit-code taxonomy (a copy of the JAX package's exitcodes.py).

* ``RC_OK`` (0) — the run completed and the output is trustworthy.
* ``RC_FATAL`` (1) — a clean operational refusal or failure: invalid input
  stream, unwritable output path, bad flags, an unported mode.
* ``RC_FAILED_HOLES`` (2) — a failure budget was exceeded.
* ``RC_INTERRUPTED`` (75, EX_TEMPFAIL) — a graceful, resumable drain:
  SIGTERM/SIGINT stopped admission, the in-flight holes finished, the
  writer and the journal settled (utils/drain.py); re-running the same
  command with the same ``--journal`` continues to the same bytes.
* ``RC_INJECTED_KILL`` (57) — a fault-injection hard exit (the ``write``,
  ``journal`` and ``rank_death`` points of utils/faultinject.py, os._exit),
  distinct so a test or an operator can tell an injected kill from a real
  crash.  Mirrors faultinject.EXIT_CODE.

Both drivers of this package return all five.
"""

from ccsx_tpu_torch.utils.faultinject import EXIT_CODE as RC_INJECTED_KILL

RC_OK = 0
RC_FATAL = 1
RC_FAILED_HOLES = 2
RC_INTERRUPTED = 75

__all__ = ["RC_OK", "RC_FATAL", "RC_FAILED_HOLES", "RC_INTERRUPTED",
           "RC_INJECTED_KILL"]
