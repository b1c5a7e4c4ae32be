"""bare-write: crash-domain writes that bypass the atomic helpers.

The r13/r16 invariant: any file a lease/journal/spool/fleet domain
reads back after a SIGKILL must be published atomically —
``write_json_atomic`` (tmp + fsync + ``os.replace`` + dir fsync),
``write_json_exclusive`` (``os.link`` O_EXCL publish), or an
``os.open(..., O_CREAT | O_EXCL)`` acquire.  A bare
``open(path, "w")`` + ``json.dump`` in those domains is a torn-state
bug waiting for the chaos suite to find it.

Rule: inside a crash-domain context — the domain modules by basename
(fleet/gateway/serve/lease/journal/blackbox), or any file when the
path expression itself names a domain artifact (lease/journal/spool/
fleet/done-marker/job-record) — flag ``open`` with a ``w``/``x``/``a``
mode and ``json.dump``, UNLESS the enclosing function also performs
the atomic publish (``write_json_atomic``/``write_json_exclusive``/
``os.replace``/``os.rename``/``os.link``/``O_EXCL``).  The exemption
is the idiom itself: a staged write followed by an atomic commit in
the same function IS the crash-safe pattern (journal.py's helpers,
gateway's upload-then-admit submit).
"""

from __future__ import annotations

import ast
import re
from pathlib import PurePosixPath
from typing import Iterable, List, Optional, Sequence

from ccsx_tpu_torch.lint.core import Finding

CHECK = "bare-write"

DOMAIN_BASENAMES = {"fleet.py", "gateway.py", "serve.py", "lease.py",
                    "journal.py", "blackbox.py"}
MARKER_RE = re.compile(r"lease|journal|spool|fleet|done_marker|job_record",
                       re.I)
ATOMIC_NAMES = {"write_json_atomic", "write_json_exclusive",
                "replace", "rename", "link"}

MESSAGE = ("bare write in a crash domain without an atomic publish in "
           "the same function — a SIGKILL here leaves a torn file; use "
           "utils.journal.write_json_atomic / write_json_exclusive or "
           "stage to a tmp and os.replace")


def _call_name(node: ast.Call) -> Optional[str]:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def _open_write_mode(node: ast.Call) -> bool:
    """builtin open() with a mode literal containing w/x/a."""
    if _call_name(node) != "open":
        return False
    if isinstance(node.func, ast.Attribute):
        # os.open has flag ints, not mode strings; gzip.open etc. on a
        # domain artifact would be its own policy — out of scope here
        base = node.func.value
        if not (isinstance(base, ast.Name) and base.id == "builtins"):
            return False
    mode = None
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
        mode = node.args[1].value
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return isinstance(mode, str) and any(c in mode for c in "wxa")


def _is_json_dump(node: ast.Call) -> bool:
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr == "dump"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "json")


def _has_atomic_publish(fn: ast.AST) -> bool:
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call) and _call_name(sub) in ATOMIC_NAMES:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "O_EXCL":
            return True
        if isinstance(sub, ast.Name) and sub.id == "O_EXCL":
            return True
    return False


def _path_arg_text(node: ast.Call) -> str:
    if not node.args:
        return ""
    try:
        return ast.unparse(node.args[0])
    except Exception:
        return ""


def _line_text(lines: Sequence[str], lineno: int) -> str:
    return lines[lineno - 1].strip() if 1 <= lineno <= len(lines) else ""


def check(tree: ast.AST, src: str, lines: Sequence[str],
          relpath: str) -> Iterable[Finding]:
    domain_file = PurePosixPath(relpath).name in DOMAIN_BASENAMES
    out: List[Finding] = []

    def visit(node: ast.AST, fn: Optional[ast.AST]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node
        for child in ast.iter_child_nodes(node):
            visit(child, fn)
        if not isinstance(node, ast.Call):
            return
        flagged = False
        if _open_write_mode(node):
            flagged = domain_file or bool(
                MARKER_RE.search(_path_arg_text(node)))
        elif _is_json_dump(node):
            flagged = domain_file
        if not flagged:
            return
        scope = fn if fn is not None else tree
        if _has_atomic_publish(scope):
            return
        out.append(Finding(CHECK, relpath, node.lineno, node.col_offset,
                           MESSAGE, _line_text(lines, node.lineno)))

    visit(tree, None)
    return out
