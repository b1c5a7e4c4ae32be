"""Ragged pass-packing: variable-pass holes into fixed row slabs.

The r5 scale run decomposed the batched pipeline's occupancy loss
(utils/metrics.py cell-exact counters): length buckets are nearly free
(0.96) but the coarse {4,8,16,32} pass buckets (pass_fill 0.727) and
partial Z groups (z_fill 0.852) together waste ~40% of every dispatch,
and the (P, qmax, tmax, iters) shape-group explosion leaves ~1.7 windows
per dispatch.  Finer pass buckets trade occupancy for MORE groups and
compiles (r5 A/B, ARCHITECTURE.md).  The structural fix is to stop
bucketing the pass dimension entirely: flatten each hole's passes into
(hole, pass) ROWS and pack rows from many holes into fixed (R, qmax)
slabs — the inter-task batching move gpuPairHMM uses to pack
variable-length DP problems onto fixed accelerator tiles, and the ragged
analog of sequence packing in LLM training stacks.

This module is the HOST-side planner (pure Python/NumPy, a copy of the
JAX package's pipeline/pack.py so both packages plan the same slabs).  The
device side lives in pipeline/batch.py (`_refine_core_packed`): a row->hole
segment-id vector rides along, the column vote becomes a masked
segment-sum (ops/msa.make_segment_voter) and the breakpoint scan a segment
reduction (ops/breakpoint.make_bp_advance_packed).

Packing discipline (all deterministic — same inputs, same plan):

* first-fit-decreasing by hole: holes sorted by (-rows, index), each
  placed into the earliest open slab with row room AND a free hole slot;
  otherwise a new slab opens.  FFD keeps tail fragmentation low without
  the grouping explosion of exact bin packing.
* a slab's device shape is (R, qmax) rows plus (H, tmax) per-hole state,
  R a power of two (bounds jit retraces exactly like the Z bucket it
  replaces) and H = R // SEG_DIV the static segment capacity
  (`num_segments` of the device segment reductions).  The capacity is a
  packing constraint, not a truncation: plan_slabs never assigns more
  than H holes to a slab.
* the LAST slab of a group (and every slab re-packed by the OOM-resplit
  ladder, pipeline/batch._recover_group) snaps to the smallest of at
  most ``ladder`` CANONICAL heights that fits — budget, budget/2, ...
  (see slab_shape), so a (qmax, tmax, iters) group has at most
  ``ladder`` slab shapes.  The JAX package chose this for its compiler
  (one XLA program per shape); the port keeps the same plan so both
  packages lay out the same slabs, row for row.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# rows per hole slot: a slab of R rows exposes H = R // SEG_DIV segment
# slots.  4 is below the realistic minimum passes per hole (the count
# filter keeps holes at >= min_fulllen_count + 2 = 5 subreads), so the
# capacity almost never binds; when it does (many tiny holes) the packer
# simply opens another slab.
SEG_DIV = 4

# canonical tail heights per group: budget and budget/2 (cfg
# slab_shape_ladder / --slab-shape-ladder; 1 = every slab full-height)
DEFAULT_LADDER = 2


def pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    p = 1
    while p < n:
        p *= 2
    return p


def canonical_heights(slab_rows: int, ladder: int = DEFAULT_LADDER) -> list:
    """The allowed slab row counts at or below the budget: budget >> k
    for k in [0, ladder), descending, never below 1.  ladder=1 means
    every slab dispatches full-height; the default 2 adds budget/2 for
    small tails.  Oversize holes (rows > budget) still grow past the
    budget on the pow2 ladder — they get dedicated slabs and are the
    only way a group can exceed ``ladder`` distinct shapes."""
    budget = pow2(max(1, slab_rows))
    return [max(1, budget >> k) for k in range(max(1, int(ladder)))]


def slab_shape(rows: Sequence[int], slab_rows: int,
               seg_div: int = SEG_DIV,
               ladder: int = DEFAULT_LADDER) -> tuple:
    """(R, H) device shape for ONE slab holding holes with ``rows`` real
    rows each.

    R covers the row total, the segment capacity floor (seg_div rows per
    hole slot keeps H = R // seg_div >= len(rows)), and the largest
    single hole; oversize holes grow past the budget on the pow2
    ladder.  Everything else SNAPS UP to the smallest of the
    ``ladder`` canonical heights (canonical_heights) that covers it —
    at most 2 distinct XLA programs per (qmax, tmax, iters) group by
    default, each predictable (and so AOT-warmable) before any slab of
    the group exists.  The r7 budget/8 shrink ladder held tail waste
    under budget/8 rows but paid 4-5 compiles per group (trace-
    measured, BENCH r7) — masked tail rows are cheap fill, compiles
    are tens of seconds each, so the trade inverts."""
    if not rows:
        raise ValueError("empty slab")
    budget = pow2(max(1, slab_rows))
    need = max(sum(rows), seg_div * len(rows), max(rows))
    if need > budget:
        R = pow2(need)
    else:
        R = budget
        for h in canonical_heights(slab_rows, ladder):
            if h >= need:
                R = h
            else:
                break
    return R, max(1, R // seg_div)


def plan_slabs(rows: Sequence[int], slab_rows: int,
               seg_div: int = SEG_DIV) -> List[List[int]]:
    """First-fit-decreasing hole->slab assignment.

    Returns slabs as lists of item indices (into ``rows``), in slab
    creation order; within a slab, items are in placement (descending
    rows, index-tiebroken) order — the executor stacks rows in exactly
    this order, so the plan IS the device layout.  A hole larger than
    the row budget gets a dedicated slab (slab_shape grows it to the
    covering power of two); nothing else can join it, since the fit
    check is against the shared budget.
    """
    budget = pow2(max(1, slab_rows))
    cap = max(1, budget // seg_div)
    order = sorted(range(len(rows)), key=lambda i: (-rows[i], i))
    slabs: List[List[int]] = []
    used: List[int] = []
    for i in order:
        r = rows[i]
        for s in range(len(slabs)):
            if used[s] + r <= budget and len(slabs[s]) < cap:
                slabs[s].append(i)
                used[s] += r
                break
        else:
            slabs.append([i])
            used.append(r)
    return slabs


def segment_ids(rows: Sequence[int], R: int) -> np.ndarray:
    """(R,) int32 row->hole segment vector for a slab packed in ``rows``
    order: hole k's rows occupy the next rows[k] positions.  Padding
    rows at the tail carry the LAST segment id, keeping the vector
    sorted (the device segment-sums pass indices_are_sorted) — their
    contributions are masked to zero by row_mask, so the id only has to
    be in range."""
    total = int(sum(rows))
    if total > R:
        raise ValueError(f"{total} rows exceed slab of {R}")
    seg = np.repeat(np.arange(len(rows), dtype=np.int32),
                    np.asarray(rows, dtype=np.int64))
    pad = np.full(R - total, max(len(rows) - 1, 0), np.int32)
    return np.concatenate([seg, pad])
