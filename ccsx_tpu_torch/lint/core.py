"""Checker framework: discovery, findings, suppression, baseline, CLI.

Findings format
---------------
One finding = (check, path, line, col, message, text) where ``text``
is the stripped source line.  ``text`` — not the line NUMBER — is the
baseline match key, so a baseline survives unrelated edits above the
suppressed line and goes stale (reported, not fatal) when the line
itself changes or disappears.

Suppression, two mechanisms
---------------------------
- inline pragma on the flagged line::

      metrics.holes_in += 1  # lint: ok[metrics-lock] single-writer loop

  The bracketed check id is required to match (a bare ``lint: ok``
  suppresses every check on that line — use the bracketed form).

- the committed baseline (``lint_baseline_torch.json`` at the repo root,
  the port's own; the JAX package's ``lint_baseline.json`` is its):
  entries ``{check, file, match, reason}`` where ``match`` is the
  stripped source line.  Every entry MUST carry a one-line reason;
  entries that no longer match anything are reported as stale so the
  baseline only shrinks.

Exit status: 0 iff no unsuppressed findings (parse errors count as
findings — an unparseable file cannot be vouched for).
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import re
import sys
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

PRAGMA_RE = re.compile(r"lint:\s*ok(?:\[([a-z0-9,\s-]+)\])?")
BASELINE_NAME = "lint_baseline_torch.json"
PACKAGE_DIR = "ccsx_tpu_torch"


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str
    path: str          # tree-root-relative, forward slashes
    line: int          # 1-based
    col: int           # 0-based
    message: str
    text: str          # stripped source line (baseline match key)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.check}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]                 # unsuppressed
    suppressed_pragma: int = 0
    suppressed_baseline: int = 0
    stale_baseline: List[dict] = dataclasses.field(default_factory=list)
    files_scanned: int = 0

    @property
    def clean(self) -> bool:
        return not self.findings

    def counts(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.check] = out.get(f.check, 0) + 1
        return out


# ---- checker registry ------------------------------------------------------
# Per-file checkers: fn(tree, src, lines, relpath) -> iterable of Finding.
# Tree checkers: fn(scan_root, rel_prefix) -> iterable of Finding (cross-
# file invariants that need several modules at once, e.g. schema-drift).

FileChecker = Callable[[ast.AST, str, Sequence[str], str], Iterable[Finding]]
TreeChecker = Callable[[Path, str], Iterable[Finding]]

FILE_CHECKS: List[Tuple[str, FileChecker]] = []
TREE_CHECKS: List[Tuple[str, TreeChecker]] = []


def _register() -> None:
    # deferred so the checker modules can import core's Finding without
    # a cycle at package-import time
    if FILE_CHECKS:
        return
    from ccsx_tpu_torch.lint import (
        checks_concurrency, checks_crashsafe, checks_numeric,
        checks_schema, checks_spans,
    )

    FILE_CHECKS.extend([
        (checks_numeric.CHECK, checks_numeric.check),
        (checks_crashsafe.CHECK, checks_crashsafe.check),
        (checks_concurrency.CHECK_LOCK, checks_concurrency.check_metrics_lock),
        (checks_concurrency.CHECK_CVAR, checks_concurrency.check_contextvar),
        (checks_spans.CHECK, checks_spans.check),
    ])
    TREE_CHECKS.append((checks_schema.CHECK, checks_schema.check_tree))


# ---- per-file run ----------------------------------------------------------


def lint_source(src: str, relpath: str,
                select: Optional[set] = None) -> List[Finding]:
    """All findings for one file's source, pragma suppression NOT yet
    applied (the runner applies it so it can count suppressions)."""
    _register()
    try:
        tree = ast.parse(src, filename=relpath)
    except SyntaxError as e:
        return [Finding("parse-error", relpath, e.lineno or 1,
                        (e.offset or 1) - 1, f"cannot parse: {e.msg}", "")]
    lines = src.splitlines()
    findings: List[Finding] = []
    for check_id, fn in FILE_CHECKS:
        if select and check_id not in select:
            continue
        findings.extend(fn(tree, src, lines, relpath))
    return findings


def _pragma_suppressed(finding: Finding, lines: Sequence[str]) -> bool:
    if not (1 <= finding.line <= len(lines)):
        return False
    m = PRAGMA_RE.search(lines[finding.line - 1])
    if not m:
        return False
    ids = m.group(1)
    if ids is None:
        return True
    return finding.check in {s.strip() for s in ids.split(",")}


def lint_file(path: Path, relpath: str,
              select: Optional[set] = None) -> Tuple[List[Finding], int]:
    """-> (findings, pragma_suppressed_count) for one file on disk."""
    src = path.read_text(encoding="utf-8", errors="replace")
    lines = src.splitlines()
    raw = lint_source(src, relpath, select)
    kept = [f for f in raw if not _pragma_suppressed(f, lines)]
    return kept, len(raw) - len(kept)


# ---- discovery -------------------------------------------------------------


def iter_py_files(scan_root: Path) -> List[Path]:
    return sorted(p for p in scan_root.rglob("*.py")
                  if "__pycache__" not in p.parts)


def _scan_root(root: Path) -> Path:
    """The real tree lints the package dir; a fixture mini-tree (no
    ``ccsx_tpu_torch/`` inside) lints the given root itself."""
    pkg = root / PACKAGE_DIR
    return pkg if pkg.is_dir() else root


# ---- baseline --------------------------------------------------------------


def load_baseline(path: Path) -> List[dict]:
    if not path.is_file():
        return []
    data = json.loads(path.read_text(encoding="utf-8"))
    entries = data.get("entries", [])
    for e in entries:
        for field in ("check", "file", "match", "reason"):
            if not isinstance(e.get(field), str) or not e[field].strip():
                raise ValueError(
                    f"baseline entry missing/empty {field!r}: {e} — every "
                    "suppression needs a check, file, match line, and a "
                    "one-line reason")
    return entries


def apply_baseline(findings: List[Finding], entries: List[dict],
                   ) -> Tuple[List[Finding], int, List[dict]]:
    """-> (unsuppressed, suppressed_count, stale_entries)."""
    used = [False] * len(entries)
    kept: List[Finding] = []
    for f in findings:
        hit = False
        for i, e in enumerate(entries):
            if (e["check"] == f.check and e["file"] == f.path
                    and e["match"] == f.text):
                used[i] = True
                hit = True
        if not hit:
            kept.append(f)
    stale = [e for i, e in enumerate(entries) if not used[i]]
    return kept, len(findings) - len(kept), stale


# ---- runner ----------------------------------------------------------------


def run_lint(root: Path, baseline: Optional[List[dict]] = None,
             select: Optional[set] = None,
             paths: Optional[Sequence[Path]] = None) -> LintResult:
    """Lint the tree under ``root`` (or just ``paths`` within it)."""
    _register()
    root = Path(root).resolve()
    scan = _scan_root(root)
    files = [Path(p).resolve() for p in paths] if paths \
        else iter_py_files(scan)
    findings: List[Finding] = []
    pragma_n = 0
    for path in files:
        rel = path.relative_to(root).as_posix()
        got, n = lint_file(path, rel, select)
        findings.extend(got)
        pragma_n += n
    if not paths:  # cross-file invariants need the whole tree
        prefix = "" if scan == root else scan.name + "/"
        for check_id, fn in TREE_CHECKS:
            if select and check_id not in select:
                continue
            findings.extend(fn(scan, prefix))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.check))
    kept, base_n, stale = apply_baseline(findings, baseline or [])
    return LintResult(findings=kept, suppressed_pragma=pragma_n,
                      suppressed_baseline=base_n, stale_baseline=stale,
                      files_scanned=len(files))


# ---- CLI -------------------------------------------------------------------


def _default_root() -> Path:
    # lint/core.py -> lint -> ccsx_tpu_torch -> repo root
    return Path(__file__).resolve().parents[2]


def lint_main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ccsx-tpu-torch lint",
        description="repo-native static analysis (see ccsx_tpu_torch/lint/)")
    ap.add_argument("paths", nargs="*", help="specific files (default: "
                    "the whole ccsx_tpu_torch package under --root)")
    ap.add_argument("--root", default=None,
                    help="tree root (default: this checkout)")
    ap.add_argument("--baseline", default=None,
                    help=f"suppression baseline (default: "
                         f"<root>/{BASELINE_NAME})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline (show every finding)")
    ap.add_argument("--select", default=None,
                    help="comma-separated checker ids to run")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    ap.add_argument("--write-baseline", action="store_true",
                    help="append current findings to the baseline as "
                         "unreviewed entries (then justify them)")
    ap.add_argument("--gauge-file", default=None,
                    help="write a {lint_findings: N} gauge JSON "
                         "(atomic) for dashboard scrapers")
    args = ap.parse_args(list(argv) if argv is not None else None)

    root = Path(args.root).resolve() if args.root else _default_root()
    bpath = Path(args.baseline) if args.baseline else root / BASELINE_NAME
    try:
        entries = [] if args.no_baseline else load_baseline(bpath)
    except (ValueError, json.JSONDecodeError) as e:
        print(f"ccsx-lint: bad baseline {bpath}: {e}", file=sys.stderr)
        return 2
    select = ({s.strip() for s in args.select.split(",")}
              if args.select else None)
    res = run_lint(root, baseline=entries, select=select,
                   paths=[Path(p) for p in args.paths] or None)

    n = len(res.findings)
    if args.gauge_file:
        # dogfood the crash-safe helper this linter enforces
        from ccsx_tpu_torch.utils.journal import write_json_atomic

        write_json_atomic(args.gauge_file, {"lint_findings": n})
    if args.write_baseline and res.findings:
        entries = entries + [
            {"check": f.check, "file": f.path, "match": f.text,
             "reason": "unreviewed (auto-added; replace with a "
                       "justification)"}
            for f in res.findings]
        from ccsx_tpu_torch.utils.journal import write_json_atomic

        write_json_atomic(str(bpath), {"version": 1, "entries": entries})
        print(f"ccsx-lint: wrote {len(res.findings)} entries to {bpath}")

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in res.findings],
            "counts": res.counts(),
            "suppressed": {"pragma": res.suppressed_pragma,
                           "baseline": res.suppressed_baseline},
            "stale_baseline": res.stale_baseline,
            "files_scanned": res.files_scanned,
            "gauge": {"lint_findings": n},
        }, indent=1, sort_keys=True))
    else:
        for f in res.findings:
            print(f.format())
        for e in res.stale_baseline:
            print(f"ccsx-lint: stale baseline entry (no longer matches): "
                  f"{e['file']}: {e['match']!r}", file=sys.stderr)
        print(f"ccsx-lint: {n} finding(s), "
              f"{res.suppressed_baseline} baseline-suppressed, "
              f"{res.suppressed_pragma} pragma-suppressed, "
              f"{res.files_scanned} files")
    return 1 if res.findings else 0


if __name__ == "__main__":
    sys.exit(lint_main())
