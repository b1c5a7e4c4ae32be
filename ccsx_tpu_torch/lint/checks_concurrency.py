"""metrics-lock + contextvar-restore: the concurrency disciplines.

``metrics-lock``: Metrics counters take concurrent writers (driver,
prep-pool workers, pair-gate pump, watchdog), and ``x += 1`` on an
attribute is a racy read-modify-write — updates vanish under load and
the books stop balancing (holes_in != holes_out + failed + filtered).
Every cross-thread increment must go through ``bump()`` /
``add_stage()`` / ``observe()``, which serialize under
``Metrics._count_lock``.  Rule: flag augmented assignment
(``+=``/``-=``/…) on an attribute reached through a ``metrics`` /
``_metrics`` / ``self.metrics`` base, anywhere outside
``utils/metrics.py`` itself.  Plain ``=`` publishes of gauges
(supervisor fleet gauges, queue depths) are a single-writer pattern
and stay legal.  Single-writer hot-loop ``+=`` sites that are provably
race-free may be baselined — with the justification in the entry.

``contextvar-restore``: the r17 cid cross-stamp — a ``ContextVar``
set without restoring the returned token leaks the value into every
later job on that thread (spans and metrics stamped with a dead job's
correlation id).  Rule: a call to ``<var>.set(...)`` on a module-level
ContextVar must either (a) be returned to the caller (token-handoff
API like ``faultinject.scope_arm``), or (b) sit in a function whose
``finally`` calls ``<var>.reset(...)`` (the ``trace.cid_scope``
shape).  Anything else is flagged.
"""

from __future__ import annotations

import ast
from pathlib import PurePosixPath
from typing import Dict, Iterable, List, Optional, Sequence, Set

from ccsx_tpu_torch.lint.core import Finding

CHECK_LOCK = "metrics-lock"
CHECK_CVAR = "contextvar-restore"

METRICS_NAMES = {"metrics", "_metrics"}

MESSAGE_LOCK = ("read-modify-write on a Metrics attribute outside "
                "bump()/add_stage() — concurrent writers lose updates; "
                "use metrics.bump(...) (locked) or baseline a provably "
                "single-writer site with its justification")
MESSAGE_CVAR = ("ContextVar.set() without a token restore — return the "
                "token to the caller or reset it in a finally "
                "(trace.cid_scope shape); a leaked value cross-stamps "
                "every later job on this thread (the r17 cid bug)")


def _line_text(lines: Sequence[str], lineno: int) -> str:
    return lines[lineno - 1].strip() if 1 <= lineno <= len(lines) else ""


# ---- metrics-lock ----------------------------------------------------------


def _metrics_attr_target(node: ast.AST) -> bool:
    """True for ``metrics.X`` / ``_metrics.X`` / ``<expr>.metrics.X``."""
    if not isinstance(node, ast.Attribute):
        return False
    base = node.value
    if isinstance(base, ast.Name) and base.id in METRICS_NAMES:
        return True
    if isinstance(base, ast.Attribute) and base.attr in METRICS_NAMES:
        return True
    return False


def check_metrics_lock(tree: ast.AST, src: str, lines: Sequence[str],
                       relpath: str) -> Iterable[Finding]:
    if PurePosixPath(relpath).name == "metrics.py":
        return []  # the locked methods themselves live here
    out: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.AugAssign) and _metrics_attr_target(
                node.target):
            out.append(Finding(CHECK_LOCK, relpath, node.lineno,
                               node.col_offset, MESSAGE_LOCK,
                               _line_text(lines, node.lineno)))
    return out


# ---- contextvar-restore ----------------------------------------------------


def _contextvar_names(tree: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(tree):
        value = None
        target = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign):
            target, value = node.target, node.value
        if not (isinstance(target, ast.Name)
                and isinstance(value, ast.Call)):
            continue
        fn = value.func
        if (isinstance(fn, ast.Name) and fn.id == "ContextVar") or (
                isinstance(fn, ast.Attribute)
                and fn.attr == "ContextVar"):
            names.add(target.id)
    return names


def _is_var_call(node: ast.AST, var: Set[str], method: str) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == method
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in var)


def check_contextvar(tree: ast.AST, src: str, lines: Sequence[str],
                     relpath: str) -> Iterable[Finding]:
    cvars = _contextvar_names(tree)
    if not cvars:
        return []
    parents: Dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node

    def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
        cur = parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = parents.get(cur)
        return None

    out: List[Finding] = []
    for node in ast.walk(tree):
        if not _is_var_call(node, cvars, "set"):
            continue
        if isinstance(parents.get(node), ast.Return):
            continue  # token handed to the caller (scope_arm shape)
        fn = enclosing_function(node)
        restored = False
        if fn is not None:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Try):
                    for final_stmt in sub.finalbody:
                        for leaf in ast.walk(final_stmt):
                            if _is_var_call(leaf, cvars, "reset"):
                                restored = True
        if not restored:
            out.append(Finding(CHECK_CVAR, relpath, node.lineno,
                               node.col_offset, MESSAGE_CVAR,
                               _line_text(lines, node.lineno)))
    return out
