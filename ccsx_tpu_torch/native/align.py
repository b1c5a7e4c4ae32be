"""ctypes wrapper for the native scalar aligner (align_native.cpp).

Returns the same AlnResult the NumPy oracle produces, so the two are
drop-in interchangeable and differentially testable.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ccsx_tpu_torch import native
from ccsx_tpu_torch.ops.oracle import AlnResult

_MODES = {"global": 0, "qfree": 1, "local": 2}


def _runs(ops: bytes) -> List[Tuple[str, int]]:
    out: List[Tuple[str, int]] = []
    for ch in ops.decode():
        if out and out[-1][0] == ch:
            out[-1] = (ch, out[-1][1] + 1)
        else:
            out.append((ch, 1))
    return out


def align_scalar_native(
    q: np.ndarray,
    t: np.ndarray,
    mode: str = "global",
    match: int = 2,
    mismatch: int = -6,
    gap_open: int = -3,
    gap_extend: int = -2,
) -> Optional[AlnResult]:
    """Native scalar Gotoh alignment; None when the library is unavailable
    or the problem exceeds the native path's size cap."""
    L = native.lib()
    if L is None:
        return None
    c = ctypes
    q = np.ascontiguousarray(q, dtype=np.uint8)
    t = np.ascontiguousarray(t, dtype=np.uint8)
    out = (c.c_int64 * 10)()
    cap = len(q) + len(t) + 2
    cigar = (c.c_uint8 * cap)()
    n = c.c_int64()
    rc = L.ccsx_align_scalar(
        q.ctypes.data_as(c.POINTER(c.c_uint8)), len(q),
        t.ctypes.data_as(c.POINTER(c.c_uint8)), len(t),
        _MODES[mode], match, mismatch, gap_open, gap_extend,
        out, cigar, cap, c.byref(n))
    if rc != 0:
        return None
    ops = bytes(cigar[: n.value]) if n.value >= 0 else b""
    return AlnResult(
        score=out[0], qb=out[1], qe=out[2], tb=out[3], te=out[4],
        aln=out[5], mat=out[6], mis=out[7], ins=out[8], del_=out[9],
        cigar=_runs(ops))
