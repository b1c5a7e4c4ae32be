"""The run's Metrics: the JAX package's counters (utils/metrics.py, a copy)
plus the counters of the port's own driver steps, which have no JAX key.

They ride every snapshot under these names, after the JAX package's keys:

* ``slabs`` — packed refine slabs (one device step each);
* ``bucketed_groups`` / ``bucketed_dispatches`` — the ``--pass-buckets``
  refine groups and their device steps (a step per group, more after an
  out-of-memory bisection);
* ``round_groups`` — groups of bare RoundRequests (one bucketed round
  step each);
* ``seed_steps`` / ``screen_steps`` — device seed and screen steps of the
  pre-alignment plane;
* ``pair_fills`` — (qmax, tmax) groups of the strand walk's local fill;
* ``failed_steps`` — batched device steps whose requests were replayed
  one by one on the per-hole round (each replay counts in the JAX key
  ``host_fallbacks``).

``capture`` is no counter and rides no snapshot: the run's in-memory span
capture (utils/capture.py) where run.run_pipeline took one (while
torch.profiler records), else None.
"""

from __future__ import annotations

import dataclasses

from ccsx_tpu_torch.utils.metrics import Metrics

PORT_KEYS = ("slabs", "bucketed_groups", "bucketed_dispatches",
             "round_groups", "seed_steps", "screen_steps", "pair_fills",
             "failed_steps")


@dataclasses.dataclass
class RunMetrics(Metrics):
    slabs: int = 0
    bucketed_groups: int = 0
    bucketed_dispatches: int = 0
    round_groups: int = 0
    seed_steps: int = 0
    screen_steps: int = 0
    pair_fills: int = 0
    failed_steps: int = 0
    capture: object = dataclasses.field(default=None, repr=False,
                                        compare=False)

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap.update((k, getattr(self, k)) for k in PORT_KEYS)
        return snap
