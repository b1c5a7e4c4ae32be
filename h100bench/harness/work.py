"""The work a window's holes need, counted from the inputs, for the kernels'
roofline shares.

The counts come from each hole's generated pass lengths and kinds (the
corpus manifest) and the algorithm's constants, never from a kernel's
source or the program's counters, so the yardstick reads the same work
whatever implements it:

* which passes a hole's consensus uses: the strand walk's rules on the
  lengths alone (``prepare.group_lens``; passes of the template group, and
  a read-through clipped to one traversal), at most ``max_passes``;
* every refine window runs ``refine_iters + 1`` rounds, and a round fills
  each pass's window against the draft: over a hole, the rows of a round
  add up to the passes' bases (windows overlap by a breakpoint's few
  columns, which this leaves out);
* a pair check is one local fill of the doubtful pass against the template
  (the wrong strand dies at the seed or screen, before any fill); the
  walk checks every pass after an out-of-group one until a check succeeds;
* ``BAND`` = 128 cells a row.

Operations a cell, from the affine-gap recurrence: E = max(E_up + e, H_up +
o + e) (3), the diagonal H_diag + s(q, t) (3), Hd = max (1), F = max(F_left
+ e, Hd_left + o + e) (3), H = max (1); the global fill's move byte adds 3
(its H choice and two extension bits): 14.  The local fill adds the zero
floor and the row's best (2) and carries four path statistics through the
three choices and the floor (4 x 3) and their two counts (2), less the move
byte: 11 + 2 + 12 + 2 = 27.  The walk takes about 6 operations a step, a
step a query base or template column.  Bytes: each input byte read once and
each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

from h100bench.gen.holes import READ_THROUGH
from h100bench.reference import prepare

BAND = 128
OPS_GLOBAL_CELL = 14
OPS_LOCAL_CELL = 27
OPS_WALK_STEP = 6
# One H100 SXM: 132 SMs x 64 INT32 lanes x 1.98 GHz boost, and HBM3.
PEAK_INT32_OPS = 132 * 64 * 1.98e9
PEAK_BYTES = 3.35e12


def kept_and_checked(lens: np.ndarray, kinds: np.ndarray, max_passes: int):
    """(lengths of the passes the consensus uses, query lengths of the pair
    checks) of one hole, by the walk's rules on its lengths."""
    n = len(lens)
    if n < 3:
        return [], []
    groups = prepare.group_lens(lens)
    gi = {i: k for k, g in enumerate(groups) for i in g.ids}
    tg = groups[0]
    ti = tg.ids[tg.size // 2]
    tlen = int(lens[ti])
    kept = [tlen]
    checks = []

    def side(indices):
        adjust = False
        for k in indices:
            L = int(lens[k])
            if gi[k] != 0:
                adjust = True
                if L < tlen:
                    continue
            elif not adjust:
                kept.append(L)
                continue
            checks.append(L)
            kept.append(L // 2 if kinds[k] == READ_THROUGH else L)
            adjust = gi[k] != 0

    side(range(ti - 1, -1, -1))
    side(range(ti + 1, n))
    return kept[:max_passes], checks


def counts(manifest, indices: Iterable[int], refine_iters: int,
           max_passes: int) -> Dict[str, Tuple[float, float]]:
    """(operations, bytes) of each kernel's work for the holes ``indices``
    (corpus indices, once for each time the hole was handed over)."""
    rounds = refine_iters + 1
    g_rows = t_cols = l_cells = l_bytes = 0
    memo = {}
    for i in indices:
        if i not in memo:
            lens, kinds = manifest.passes(i)
            kept, checks = kept_and_checked(lens, kinds, max_passes)
            tlen = int(manifest.tlens[i])
            memo[i] = (sum(kept), len(kept) * tlen,
                       sum(checks) * BAND,
                       sum(q + tlen + 16 + 28 for q in checks))
        rows, cols, cells, byt = memo[i]
        g_rows += rows * rounds
        t_cols += cols * rounds
        l_cells += cells
        l_bytes += byt
    fill_bytes = g_rows * (1 + BAND + 4) + t_cols
    walk_bytes = g_rows * (BAND + 4 + 1) + t_cols * (1 + 4 + 4)
    return {
        "global_fill": (g_rows * BAND * OPS_GLOBAL_CELL, fill_bytes),
        "traceback_walk": ((g_rows + t_cols) * OPS_WALK_STEP, walk_bytes),
        "local_fill": (l_cells * OPS_LOCAL_CELL, l_bytes),
    }


def least_seconds(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time the chip could take, and which bound holds it."""
    t_ops = ops / PEAK_INT32_OPS
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
