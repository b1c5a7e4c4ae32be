"""schema-drift: the static half of the telemetry schema guard.

The runtime guard (tests/test_torch_telemetry.py) builds a populated
snapshot and cross-checks the consumer tuples against it.  This checker
computes the SAME contract from the AST alone — no imports, no Metrics
instance — so it holds even for code paths the populated snapshot doesn't
reach, and it runs anywhere the linter does.

The port's snapshot is ``RunMetrics.snapshot()`` (utils/run_metrics.py):
the JAX package's ``Metrics.snapshot()`` keys (utils/metrics.py, the
dict literal plus every ``snap["..."] = ...`` assignment) and the port's
step counters, which ``RunMetrics`` adds from its ``PORT_KEYS`` tuple.
Two directions, both from parsed source:

1. every counter key a consumer tuple names —
   ``PROM_COUNTERS``/``PROM_GAUGES``/``TOP_SUM_KEYS``/
   ``HEALTH_DETAIL_KEYS``/``JOB_PROM_COUNTERS``/``JOB_PROM_GAUGES``
   (utils/telemetry.py), ``OCCUPANCY_KEYS``/``RESILIENCE_KEYS``
   (utils/trace.py), ``REPORT_TILE_KEYS``/``REPORT_HEADER_KEYS``
   (utils/report.py) — must exist in that key set, or stats/top/report
   render a permanently-empty column;

2. every snapshot key — ``RunMetrics``' step counters included — must
   reach ``/metrics`` through ``PROM_COUNTERS | PROM_GAUGES |
   PROM_STRUCTURED``, or a new counter ships invisible to every
   dashboard.

(The ``FLEET_*`` gauges are sourced from the gateway's spool summary,
not from the snapshot, so they are deliberately outside this contract.)
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

from ccsx_tpu_torch.lint.core import Finding

CHECK = "schema-drift"

# (file under the scan root, tuple names consumed from snapshot keys)
CONSUMER_TUPLES = (
    ("utils/telemetry.py", ("PROM_COUNTERS", "PROM_GAUGES",
                            "TOP_SUM_KEYS", "HEALTH_DETAIL_KEYS",
                            "JOB_PROM_COUNTERS", "JOB_PROM_GAUGES")),
    ("utils/trace.py", ("OCCUPANCY_KEYS", "RESILIENCE_KEYS")),
    ("utils/report.py", ("REPORT_TILE_KEYS", "REPORT_HEADER_KEYS")),
)
EXPORT_TUPLES = ("PROM_COUNTERS", "PROM_GAUGES", "PROM_STRUCTURED")


def _module_tuples(tree: ast.AST) -> Dict[str, Tuple[int, Set[str]]]:
    """name -> (lineno, string elements) for module-level tuple/list
    assignments of string constants."""
    out: Dict[str, Tuple[int, Set[str]]] = {}
    for node in getattr(tree, "body", []):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        value = node.value
        if not isinstance(value, (ast.Tuple, ast.List)):
            continue
        elems = set()
        ok = True
        for el in value.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                elems.add(el.value)
            else:
                ok = False  # mixed tuple (e.g. HIST_FAMILIES triples)
        if ok and elems:
            out[node.targets[0].id] = (node.lineno, elems)
    return out


def _snapshot_method(tree: ast.AST, cls_name: str) -> Optional[ast.AST]:
    """``def snapshot()`` of class ``cls_name``, or None."""
    for cls in ast.walk(tree):
        if not (isinstance(cls, ast.ClassDef) and cls.name == cls_name):
            continue
        for fn in cls.body:
            if isinstance(fn, ast.FunctionDef) and fn.name == "snapshot":
                return fn
    return None


def _method_keys(fn: ast.AST, tuples=None) -> Set[str]:
    """Dict-literal keys and ``<name>["key"] = ...`` assignments of a
    snapshot method, plus the elements of every module-level string tuple
    it names (``tuples``: ``RunMetrics``' ``PORT_KEYS``)."""
    keys: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if isinstance(k, ast.Constant) and isinstance(
                        k.value, str):
                    keys.add(k.value)
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (isinstance(tgt, ast.Subscript)
                        and isinstance(tgt.slice, ast.Constant)
                        and isinstance(tgt.slice.value, str)):
                    keys.add(tgt.slice.value)
        if tuples and isinstance(node, ast.Name) and node.id in tuples:
            keys |= tuples[node.id][1]
    return keys


def _snapshot_keys(tree: ast.AST) -> Tuple[Optional[int], Set[str]]:
    """Key set of ``class Metrics: def snapshot()``: dict-literal keys
    plus ``<name>["key"] = ...`` assignments in the method body."""
    fn = _snapshot_method(tree, "Metrics")
    if fn is None:
        return None, set()
    return fn.lineno, _method_keys(fn)


def _run_metrics_keys(tree: Optional[ast.AST]
                      ) -> Tuple[Optional[int], Set[str]]:
    """The keys ``RunMetrics.snapshot()`` adds to the JAX package's."""
    fn = _snapshot_method(tree, "RunMetrics") if tree is not None else None
    if fn is None:
        return None, set()
    return fn.lineno, _method_keys(fn, _module_tuples(tree))


def _parse(path: Path) -> Optional[ast.AST]:
    try:
        return ast.parse(path.read_text(encoding="utf-8",
                                        errors="replace"))
    except (OSError, SyntaxError):
        return None


def check_tree(scan_root: Path, rel_prefix: str = "") -> Iterable[Finding]:
    mpath = scan_root / "utils" / "metrics.py"
    tpath = scan_root / "utils" / "telemetry.py"
    mtree = _parse(mpath)
    ttree = _parse(tpath)
    if mtree is None or ttree is None:
        return []  # not a tree that carries the telemetry contract
    snap_line, base_keys = _snapshot_keys(mtree)
    if snap_line is None:
        return []
    run_line, run_keys = _run_metrics_keys(
        _parse(scan_root / "utils" / "run_metrics.py"))
    snap_keys = base_keys | run_keys
    out: List[Finding] = []
    telemetry_tuples = _module_tuples(ttree)

    for relfile, names in CONSUMER_TUPLES:
        path = scan_root / relfile
        tree = ttree if relfile.endswith("telemetry.py") else _parse(path)
        if tree is None:
            continue
        tuples = (telemetry_tuples
                  if relfile.endswith("telemetry.py")
                  else _module_tuples(tree))
        for name in names:
            if name not in tuples:
                continue
            lineno, keys = tuples[name]
            for key in sorted(keys - snap_keys):
                out.append(Finding(
                    CHECK, rel_prefix + relfile, lineno, 0,
                    f"{name} consumes {key!r} which Metrics.snapshot() "
                    f"never emits — the column renders permanently "
                    f"empty; add it to snapshot() or drop it here",
                    name))

    exported: Set[str] = set()
    for name in EXPORT_TUPLES:
        if name in telemetry_tuples:
            exported |= telemetry_tuples[name][1]
    if exported:
        for relfile, line, keys in (
                ("utils/metrics.py", snap_line, base_keys),
                ("utils/run_metrics.py", run_line, run_keys - base_keys)):
            for key in sorted(keys - exported):
                out.append(Finding(
                    CHECK, rel_prefix + relfile, line, 0,
                    f"snapshot() emits {key!r} but no PROM_COUNTERS/"
                    f"PROM_GAUGES/PROM_STRUCTURED entry exports it — the "
                    f"key is invisible to /metrics and every dashboard",
                    "snapshot"))
    return out
