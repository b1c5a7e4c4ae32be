"""Config/code fingerprints for resume-compatibility checks (a copy of
the JAX package's utils/fingerprint.py; only ``code_fingerprint``'s source
list differs).

A checkpoint (the run journal, utils/journal.py v2) is only resumable into
a run that would have produced byte-identical output — resuming across a
consensus-code or consensus-config change silently mixes old-code
sections into an artifact that claims the new code.  The journal pins
these fingerprints and refuses (recomputes from scratch) on mismatch.

``code_fingerprint`` hashes the consensus-critical sources directly
(config + consensus/ops/pipeline modules, and the CUDA kernels' sources
under csrc/) rather than reading git HEAD: uncommitted edits must
invalidate a checkpoint too, and the hash needs no git binary or
repository to work from an installed tree.  The sources differ from the
JAX package's, so a journal cut by the JAX package is refused here and
the run recomputes, as on any fingerprint mismatch.  ``config_fingerprint``
is the JAX package's: the two CcsConfigs have the same fields, so one
config has one fingerprint in both packages.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os

# modules whose behavior shapes consensus OUTPUT bytes.  io/ is
# deliberately out: how bytes are parsed in is pinned byte-identical by
# tests, and including it would invalidate checkpoints on changes that
# cannot alter output.
_SRC_DIRS = ("consensus", "ops", "pipeline")

# CcsConfig fields that tile/observe but never change output bytes
# (bucketing is masked padding — pinned by
# test_pass_buckets_knob_output_invariant — and backend choice is
# bit-identical by the differential suite)
_NON_SEMANTIC = frozenset({
    "threads", "verbose", "device", "mesh_shape", "metrics_path",
    "trace_path", "stall_timeout_s",
    "pass_buckets", "zmw_microbatch", "chunk_size", "chunk_growth",
    "chunk_cap",
    # resilient execution (pipeline/resilience.py): deadlines/breaker
    # only choose WHERE a request computes (device vs the bit-exact
    # host spec), and the failure budget only changes the rc — none
    # can change output bytes, and the canonical recovery move ("it
    # hung; re-run WITH --dispatch-deadline and resume") must not be
    # refused as a config change
    "dispatch_deadline_s", "breaker_strikes", "breaker_window_s",
    "breaker_probe_s", "max_failed_holes",
    # hostile-input salvage (io/corruption.py): on the bytes a resume
    # re-reads, salvage changes nothing until the first corrupt byte —
    # exactly where a fail-fast run died — so the canonical recovery
    # move ("it died on a corrupt block; re-run WITH --salvage and
    # resume") must not be refused as a config change.  The emitted
    # prefix is byte-identical either way (pinned by test_salvage).
    # max_record_bytes stays SEMANTIC: it redefines which healthy
    # records are accepted, so resuming across a change would splice
    # sections read under different acceptance rules.
    "salvage",
    # pre-alignment plane (ops/sketch.py + ops/seed_device.py): the
    # prefilter only rejects pairs whose strand_match acceptance
    # would fail (the walk discards a failed pair's payload), and the
    # device seeder is bit-equal to the host one — neither can change
    # output bytes (pinned by the scale-config md5 across prefilter
    # on/off and both crossover settings)
    "prefilter", "seed_device_min_t",
    # banded DP-fill backend (consensus/star.banded_impl): scan, pallas
    # and rotband are pinned bit-identical by the three-way differential
    # suite and the scale-config md5 across all three values, so the
    # knob (and the canonical A/B move "re-run WITH --banded-impl X and
    # resume") can never change output bytes
    "banded_impl",
})


@functools.lru_cache(maxsize=1)
def code_fingerprint() -> str:
    """Short stable hash of the consensus-critical source files: the
    Python modules and the CUDA kernels (csrc/*.cu), whose changes can
    change output bytes as much as a module's."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(root, "config.py")]
    for d, ext in tuple((d, ".py") for d in _SRC_DIRS) + (("csrc", ".cu"),):
        dd = os.path.join(root, d)
        paths += [os.path.join(dd, f) for f in sorted(os.listdir(dd))
                  if f.endswith(ext)]
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.relpath(p, root).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def config_fingerprint(cfg) -> str:
    """Short hash of the output-shaping fields of a CcsConfig."""
    d = dataclasses.asdict(cfg)
    for k in _NON_SEMANTIC:
        d.pop(k, None)
    if d.get("exclude_holes") is not None:
        d["exclude_holes"] = sorted(d["exclude_holes"])
    blob = json.dumps(d, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def run_fingerprint(cfg) -> str:
    """The journal v2 compatibility key: code + config, either mismatch
    refuses a resume."""
    return f"{code_fingerprint()}-{config_fingerprint(cfg)}"
