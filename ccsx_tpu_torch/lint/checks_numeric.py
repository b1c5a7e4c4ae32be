"""int32-overflow: int32 index products that wrap before the divide.

The JAX package's shipped bug, twice: ``(i - li0) * (lj1 - lj0) //
max(li1 - li0, 1)`` — a nominal-line interpolation whose int32 product
exceeds 2**31 past ~47 kb templates, truncating every long-pair band
(``ops/banded._line_interp`` and ``compute_offsets``).  The port's ops keep
the JAX package's int32 tensors (``torch.int32``), and a torch int32
product wraps as silently: no exception, no NaN, just a wrong band and a
quietly bad consensus.

Rule (scoped to ``ops/`` modules, where operands are int32 tensors): flag

- ``X * Y // Z`` where neither factor is a literal — the exact shape
  of both historical bugs — and
- ``X << Y`` with a non-literal shift amount (same wrap, different
  operator),

unless the expression carries an int64 promotion (``torch.int64``,
``.to(torch.int64)``, ``.long()``, the JAX package's
``astype(jnp.int64)``, or an ``"int64"`` dtype string) or a factor is
already limb-reduced (``>>``/``&`` subexpressions — the ``_line_interp``
idiom keeps every partial product under 2**31 by splitting into 8-bit
limbs).

The fix is never "suppress": route through ``ops/banded._line_interp``
(exact floor semantics, negative-safe) or promote to int64 explicitly.
"""

from __future__ import annotations

import ast
from pathlib import PurePosixPath
from typing import Iterable, List, Sequence

from ccsx_tpu_torch.lint.core import Finding

CHECK = "int32-overflow"

MESSAGE = ("int32 product feeds a floor-div without int64 promotion or "
           "limb reduction (the JAX package's old _line_interp / "
           "compute_offsets wrap): use ops/banded._line_interp or "
           "promote with .long() / .to(torch.int64)")
MESSAGE_SHIFT = ("int32 value shifted by a non-literal amount without "
                 "int64 promotion — the result wraps silently; promote "
                 "with .long() / .to(torch.int64)")


def _applies(relpath: str) -> bool:
    return "ops" in PurePosixPath(relpath).parts


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp):
        return _is_literal(node.operand)
    if isinstance(node, ast.Name) and node.id.isupper():
        return True  # ALL_CAPS module constant — a static python int
    return False


def _has_int64(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "long"):
            return True  # torch's .long(): an int64 copy
        if isinstance(sub, ast.Name) and "int64" in sub.id:
            return True
        if isinstance(sub, ast.Attribute) and "int64" in sub.attr:
            return True
        if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                and "int64" in sub.value):
            return True
    return False


def _limb_reduced(node: ast.AST) -> bool:
    """8-bit-limb split markers: the factor was built from ``>>``/``&``
    pieces, so each partial product is bounded by construction."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.BinOp) and isinstance(
                sub.op, (ast.RShift, ast.BitAnd)):
            return True
    return False


def _line_text(lines: Sequence[str], lineno: int) -> str:
    return lines[lineno - 1].strip() if 1 <= lineno <= len(lines) else ""


def check(tree: ast.AST, src: str, lines: Sequence[str],
          relpath: str) -> Iterable[Finding]:
    if not _applies(relpath):
        return []
    out: List[Finding] = []
    # only function bodies: module-level arithmetic runs once at import
    # time on concrete python ints — never on a tensor
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    seen = set()
    for fn in funcs:
        for node in ast.walk(fn):
            if id(node) in seen or not isinstance(node, ast.BinOp):
                continue
            seen.add(id(node))
            if isinstance(node.op, ast.FloorDiv) and isinstance(
                    node.left, ast.BinOp) and isinstance(
                    node.left.op, ast.Mult):
                mult = node.left
                if _is_literal(mult.left) or _is_literal(mult.right):
                    continue
                if _has_int64(node):
                    continue
                if _limb_reduced(mult.left) or _limb_reduced(mult.right):
                    continue
                out.append(Finding(CHECK, relpath, node.lineno,
                                   node.col_offset, MESSAGE,
                                   _line_text(lines, node.lineno)))
            elif isinstance(node.op, ast.LShift):
                if _is_literal(node.left) or _is_literal(node.right):
                    continue
                if _has_int64(node):
                    continue
                out.append(Finding(CHECK, relpath, node.lineno,
                                   node.col_offset, MESSAGE_SHIFT,
                                   _line_text(lines, node.lineno)))
    return out
