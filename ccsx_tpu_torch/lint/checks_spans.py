"""span-force: device spans must force the CUDA work before they close.

CUDA launches are asynchronous — a ``device_span`` that wraps only the
launches times the enqueue, not the card: every kernel looks free and the
compile/execute attribution table becomes fiction.  The port's rule, the
JAX package's restated for torch: the attributed path inside a device
span must reach ``Span.force`` (which synchronises the current stream
when a trace is recording) or a CUDA synchronise
(``torch.cuda.synchronize()``, ``stream.synchronize()``) before the span
closes.  ``block_until_ready`` is accepted too, so the JAX package's
fixtures keep their verdicts.

Rule: a ``with ... device_span(...)`` block whose body contains none of
those calls is flagged.  Lambdas and nested defs inside the body count
(the deadline runner receives the forcing closure), which errs toward
silence — the checker guards against the span that *cannot* force, not
against conditional paths that sometimes don't.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Sequence

from ccsx_tpu_torch.lint.core import Finding

CHECK = "span-force"

MESSAGE = ("device_span closes without forcing the CUDA work — add "
           "sp.force(...) or a torch.cuda synchronize on the attributed "
           "path, or the span times the async launches, not the card")


def _is_device_span_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    name = fn.id if isinstance(fn, ast.Name) else (
        fn.attr if isinstance(fn, ast.Attribute) else None)
    return name == "device_span"


def _forces(body: Sequence[ast.stmt]) -> bool:
    for stmt in body:
        for sub in ast.walk(stmt):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            name = fn.id if isinstance(fn, ast.Name) else (
                fn.attr if isinstance(fn, ast.Attribute) else None)
            if name in ("block_until_ready", "force", "synchronize"):
                return True
    return False


def _line_text(lines: Sequence[str], lineno: int) -> str:
    return lines[lineno - 1].strip() if 1 <= lineno <= len(lines) else ""


def check(tree: ast.AST, src: str, lines: Sequence[str],
          relpath: str) -> Iterable[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        if not any(_is_device_span_call(item.context_expr)
                   for item in node.items):
            continue
        if _forces(node.body):
            continue
        out.append(Finding(CHECK, relpath, node.lineno, node.col_offset,
                           MESSAGE, _line_text(lines, node.lineno)))
    return out
