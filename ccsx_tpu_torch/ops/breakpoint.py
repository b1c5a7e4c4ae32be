"""Breakpoint scan + cursor advance on the device, for the packed slabs
(the reference's MSA backward scan, main.c:580-612, and its per-pass cursor
bump, main.c:622-638).

The host NumPy functions (consensus/windowed.find_breakpoint and _advance)
are the spec; this is their tensor form for rows of many holes sharing one
slab, so the batched driver brings back a breakpoint per hole and an
advance per row instead of the (R, T) match/aligned/ins_cnt tensors.
"""

from __future__ import annotations

import torch


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
            c = torch.cumsum(x.to(torch.int32), dim=-1, dtype=torch.int32)
            c = torch.nn.functional.pad(c, (1, 0))
            return c[..., W:] - c[..., :-W]

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
