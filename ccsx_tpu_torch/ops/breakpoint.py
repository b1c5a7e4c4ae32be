"""Breakpoint scan + cursor advance on the device, for the packed slabs
(the reference's MSA backward scan, main.c:580-612, and its per-pass cursor
bump, main.c:622-638).

The host NumPy functions (consensus/windowed.find_breakpoint and _advance)
are the spec; these are their tensor forms, so the batched driver brings
back a breakpoint per hole and an advance per pass row instead of the
match/aligned/ins_cnt tensors: ``make_bp_advance_packed`` for rows of many
holes sharing one packed slab, ``make_bp_advance`` for the bucketed (Z, P)
layout of the --pass-buckets path.
"""

from __future__ import annotations

import torch


def _wsum(x: torch.Tensor, W: int) -> torch.Tensor:
    """Sums over every window of W consecutive columns (last axis), int32:
    (..., T) -> (..., T - W + 1)."""
    c = torch.cumsum(x.to(torch.int32), dim=-1, dtype=torch.int32)
    c = torch.nn.functional.pad(c, (1, 0))
    return c[..., W:] - c[..., :-W]


def make_bp_advance(tmax: int, bp_window: int, bp_minwin: int,
                    bp_rowrate: int, bp_colrate: int, bp_colrate_lowpass: int):
    """Breakpoint + advance for Z holes of P pass rows each (the JAX
    package's ``jax.vmap(make_bp_advance(...))``).

    Inputs: match (Z, P, tmax) bool, cons (Z, tmax) uint8, aligned (Z, P,
    tmax) uint8, ins_cnt (Z, P, tmax) int32, lead_ins (Z, P) int32,
    row_mask (Z, P) bool, tlen (Z,) int32.

    Returns (bp (Z,) int32, advance (Z, P) int32): bp is the highest valid
    breakpoint column in [1, tlen - bp_window], or -1 when none exists (the
    spec's None; tlen < W + 1 leaves no candidate); advance is each row's
    query bases consumed by columns [0, bp_eff), where bp_eff = bp if bp >=
    1 else max(tlen - W, 1), the forced-flush column the windowed driver
    uses.  Padding rows are already False in match (the vote masks them)
    and pass the per-row agreement test.
    """
    W = bp_window

    def f(match, cons, aligned, ins_cnt, lead_ins, row_mask, tlen):
        dev = cons.device
        tlen = tlen.to(torch.int32)
        col = torch.arange(tmax, dtype=torch.int32, device=dev)
        incols = col[None, :] < tlen[:, None]                 # (Z, tmax)
        nseq = row_mask.sum(1, dtype=torch.int32)             # (Z,)
        isbase = (cons < 4) & incols
        matchcnt = match.sum(1, dtype=torch.int32)            # (Z, tmax)
        colrate = torch.where(nseq >= 10, bp_colrate, bp_colrate_lowpass)
        colok = matchcnt * 100 >= (colrate * nseq)[:, None]
        badbase = isbase & ~colok

        nog = _wsum(isbase, W)                                # (Z, tmax-W+1)
        bad = _wsum(badbase, W)
        rowin = _wsum(match & isbase[:, None, :], W)          # (Z, P, ...)
        idx = torch.arange(tmax - W + 1, dtype=torch.int32, device=dev)
        valid = (bad == 0) & (nog >= bp_minwin) & isbase[:, : tmax - W + 1]
        # every real row must match in >= rowrate% of the window's base
        # columns; padding rows pass
        rows_ok = ((rowin * 100 >= bp_rowrate * nog[:, None, :])
                   | ~row_mask[:, :, None]).all(1)
        valid &= rows_ok
        valid &= (idx[None, :] >= 1) & (idx[None, :] <= (tlen - W)[:, None])
        bp = torch.where(valid, idx[None, :], -1).max(dim=1).values

        bp_eff = torch.where(bp >= 1, bp, torch.clamp(tlen - W, min=1))
        ccols = (col[None, :] < bp_eff[:, None])[:, None, :]  # (Z, 1, tmax)
        nongap = ((aligned < 4) & ccols).sum(2, dtype=torch.int32)
        ins = (ins_cnt * ccols).sum(2, dtype=torch.int32)
        advance = nongap + ins + lead_ins.to(torch.int32)
        return bp.to(torch.int32), advance.to(torch.int32)

    return f


def make_bp_advance_packed(tmax: int, num_segments: int, bp_window: int,
                           bp_minwin: int, bp_rowrate: int,
                           bp_colrate: int, bp_colrate_lowpass: int):
    """Segment-id breakpoint + advance.

    Inputs: match (R, tmax) bool, cons (H, tmax) uint8, aligned (R, tmax)
    uint8, ins_cnt (R, tmax) int32, lead_ins (R,) int32, row_mask (R,)
    bool, seg (R,) int64, tlen (H,) int32.

    Returns (bp (H,) int32, advance (R,) int32): bp is the highest valid
    breakpoint column in [1, tlen - bp_window] of each hole slot, or -1
    (the spec's None); advance is each row's query bases consumed by
    columns [0, bp_eff) of its hole, where bp_eff = bp if bp >= 1 else
    max(tlen - W, 1), the forced-flush column the windowed driver uses.
    Every per-hole count is a masked int32 segment sum over exactly the
    hole's real rows; an empty hole slot has no base column, so bp = -1.
    """
    W = bp_window
    H = num_segments

    def f(match, cons, aligned, ins_cnt, lead_ins, row_mask, seg, tlen):
        dev = cons.device
        tlen = tlen.to(torch.int32)
        col = torch.arange(tmax, dtype=torch.int32, device=dev)

        def ssum(x):
            out = torch.zeros((H,) + tuple(x.shape[1:]), dtype=torch.int32,
                              device=dev)
            return out.index_add_(0, seg, x.to(torch.int32))

        def wsum(x):
            return _wsum(x, W)

        incols = col[None, :] < tlen[:, None]                 # (H, tmax)
        nseq = ssum(row_mask)                                 # (H,)
        isbase = (cons < 4) & incols
        matchcnt = ssum(match)                                # (H, tmax)
        colrate = torch.where(nseq >= 10, bp_colrate, bp_colrate_lowpass)
        colok = matchcnt * 100 >= (colrate * nseq)[:, None]
        badbase = isbase & ~colok

        nog = wsum(isbase)                                    # (H, tmax-W+1)
        bad = wsum(badbase)
        rowin = wsum(match & isbase.index_select(0, seg))     # (R, tmax-W+1)
        # every real row of the hole must match in >= rowrate% of the
        # window's base columns: count masked violations per segment
        viol = (rowin * 100 < bp_rowrate * nog.index_select(0, seg)) \
            & row_mask[:, None]
        rows_ok = ssum(viol) == 0
        idx = torch.arange(tmax - W + 1, dtype=torch.int32, device=dev)
        valid = (bad == 0) & (nog >= bp_minwin) \
            & isbase[:, : tmax - W + 1] & rows_ok
        valid &= (idx[None, :] >= 1) & (idx[None, :] <= (tlen - W)[:, None])
        bp = torch.where(valid, idx[None, :], -1).max(dim=1).values

        bp_eff = torch.where(bp >= 1, bp, torch.clamp(tlen - W, min=1))
        ccols = col[None, :] < bp_eff.index_select(0, seg)[:, None]
        nongap = ((aligned < 4) & ccols).sum(1, dtype=torch.int32)
        ins = (ins_cnt * ccols).sum(1, dtype=torch.int32)
        advance = nongap + ins + lead_ins.to(torch.int32)
        return bp.to(torch.int32), advance.to(torch.int32)

    return f
