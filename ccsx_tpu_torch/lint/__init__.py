"""ccsx-lint for the port: the JAX package's repo-native static analysis
(ccsx_tpu/lint/), run over ``ccsx_tpu_torch/`` against the port's own
baseline (``lint_baseline_torch.json``).

Pure ``ast`` — importing this package MUST NOT import torch or jax (or
anything that transitively does): the linter is a tier-1 test and a
pre-review gate, so it has to run in seconds on a host with no card.

One checker per defect family, by the JAX package's names:

- ``int32-overflow``   an int32 product feeding a floor-div, or a shift by
                       a non-literal amount, in ``ops/`` without an int64
                       promotion (``torch.int64``, ``.long()``,
                       ``.to(torch.int64)``) or limb reduction
- ``bare-write``       crash-safety writes in lease/journal/spool/fleet
                       domains that bypass ``write_json_atomic`` /
                       ``write_json_exclusive`` / ``O_EXCL``
- ``metrics-lock``     read-modify-write on Metrics counters outside
                       ``bump()``/``add_stage()``
- ``contextvar-restore`` ``ContextVar.set()`` with no token restore in
                       a ``finally``
- ``span-force``       ``device_span`` blocks that close without forcing
                       the CUDA work (``Span.force`` or a synchronise)
- ``schema-drift``     consumed keys exist in ``Metrics.snapshot()`` (with
                       ``RunMetrics``' step counters) and every snapshot
                       key reaches /metrics or the structured allowlist

See ``core.py`` for the findings format, the inline pragma
(``# lint: ok[<check>] <reason>``) and the baseline.
"""

from ccsx_tpu_torch.lint.core import Finding, LintResult, lint_main, run_lint

__all__ = ["Finding", "LintResult", "lint_main", "run_lint"]
