"""Star-MSA column voting: consensus call over stacked projections.

The vote is a reduction over the pass axis in plain tensor ops, on whatever
device the projections live: ``vote`` takes one hole's (P, T) block or a
bucketed batch's (Z, P, T) one, and the packed slabs of the batched driver
vote by segment id (``make_segment_voter``).  ``emit_insertions`` and
``materialize`` are the host (NumPy) spec; ``emit_insertions_t`` and
``make_materializer`` are their tensor twins, which keep the batched
refine loop's drafts on the device.
"""

from __future__ import annotations

import numpy as np
import torch

GAP = 4
PAD = 5


def vote(aligned: torch.Tensor, ins_cnt: torch.Tensor, ins_b: torch.Tensor,
         row_mask: torch.Tensor, max_ins: int = 4):
    """Column vote over the pass axis, for one hole or a batch of them (any
    leading axes, the counterpart of the JAX package's
    ``jax.vmap(make_voter(max_ins))``).  Shapes: aligned (..., P, T) uint8,
    ins_cnt (..., P, T) int32, ins_b (..., P, T, R) uint8, row_mask (..., P)
    bool.  Returns:
      cons      (..., T) uint8  — 0-3 base, 4 gap (column dropped)
      ins_base  (..., T, R) uint8 — majority inserted base per slot/rank
      ins_votes (..., T, R) int32 — passes inserting at least r+1 bases
      ncov      (..., T) int32  — covering passes per column
      match     (..., P, T) bool — pass agrees with the consensus at the column
      nwin      (..., T) int32  — passes voting the winning cell
    Every count is an exact int32 sum over the hole's real rows (masked pass
    rows count nothing); ties go to the lowest code (torch.argmax returns
    the first maximum).
    """
    mask = row_mask[..., None]
    cnts = torch.stack(
        [((aligned == c) & mask).sum(-2, dtype=torch.int32) for c in range(5)])
    ncov = cnts.sum(0, dtype=torch.int32)
    nwin = cnts.max(0).values
    cons = torch.argmax(cnts, dim=0).to(torch.uint8)
    cons = torch.where(ncov == 0, GAP, cons).to(torch.uint8)

    bases, votes = [], []
    for r in range(max_ins):
        has = mask & (ins_cnt > r)
        votes.append(has.sum(-2, dtype=torch.int32))
        bc = torch.stack([((ins_b[..., r] == c) & has).sum(-2,
                                                           dtype=torch.int32)
                          for c in range(4)])
        bases.append(torch.argmax(bc, dim=0).to(torch.uint8))
    ins_base = torch.stack(bases, dim=-1)
    ins_votes = torch.stack(votes, dim=-1)
    match = (aligned == cons[..., None, :]) & mask
    return cons, ins_base, ins_votes, ncov, match, nwin


def make_segment_voter(max_ins: int, num_segments: int):
    """Segment-id column vote for the packed slabs (pipeline/pack.py): rows
    of many holes share one (R, T) slab and ``seg`` maps each row to its
    hole slot in [0, num_segments).

    Shapes: aligned (R, T) uint8, ins_cnt (R, T) int32, ins_b (R, T,
    max_ins) uint8, row_mask (R,) bool, seg (R,) int64.  Returns the
    tuple of ``vote`` with the hole axis H = num_segments in front of the
    per-hole outputs and match per row: cons (H, T), ins_base (H, T,
    max_ins), ins_votes (H, T, max_ins), ncov (H, T), match (R, T), nwin
    (H, T).  Every count is a masked int32 ``index_add_``, exact in any
    order; ties go to the first maximum; an empty hole slot has ncov 0
    and so cons GAP.
    """
    H = num_segments

    def vote(aligned, ins_cnt, ins_b, row_mask, seg):
        mask = row_mask[:, None]

        def ssum(x):
            out = torch.zeros((H,) + tuple(x.shape[1:]), dtype=torch.int32,
                              device=x.device)
            return out.index_add_(0, seg, x.to(torch.int32))

        cnts = torch.stack([ssum((aligned == c) & mask) for c in range(5)])
        ncov = cnts.sum(0, dtype=torch.int32)
        nwin = cnts.max(0).values
        cons = torch.argmax(cnts, dim=0).to(torch.uint8)
        cons = torch.where(ncov == 0, GAP, cons).to(torch.uint8)

        bases, votes = [], []
        for r in range(max_ins):
            has = mask & (ins_cnt > r)
            votes.append(ssum(has))
            bc = torch.stack([ssum((ins_b[:, :, r] == c) & has)
                              for c in range(4)])
            bases.append(torch.argmax(bc, dim=0).to(torch.uint8))
        ins_base = torch.stack(bases, dim=2)
        ins_votes = torch.stack(votes, dim=2)
        match = (aligned == cons.index_select(0, seg)) & mask
        return cons, ins_base, ins_votes, ncov, match, nwin

    return vote


def emit_insertions_t(ins_base: torch.Tensor, ins_votes: torch.Tensor,
                      ncov: torch.Tensor, speculative: bool) -> torch.Tensor:
    """``emit_insertions`` as tensor ops over any leading axes: the same
    integer rules and the same prefix rule (rank r emits only if rank r-1
    did).  Keeps the refine loop's speculative drafts on the device."""
    iv = ins_votes.to(torch.int32)
    n = ncov.to(torch.int32)[..., None]
    emit = iv * 2 > n
    if speculative:
        third = -torch.div(-n, 3, rounding_mode="floor")
        emit = emit | (iv >= torch.clamp(third, min=2))
    for r in range(1, emit.shape[-1]):
        emit[..., r] &= emit[..., r - 1]
    return torch.where(emit, ins_base, PAD).to(torch.uint8)


def make_materializer(tmax_in: int, tmax_out: int, max_ins: int):
    """Materialize on the device at static shapes, for a batch of holes.

    Returns f(cons (H, tmax_in) uint8, ins_out (H, tmax_in, max_ins) uint8,
    tlen (H,) int32) -> (draft (H, tmax_out) uint8 padded with PAD, newlen
    (H,) int32, overflow (H,) bool).  Equal to the host ``materialize`` on
    the first ``newlen`` cells whenever ``overflow`` is False; on overflow
    the tail is dropped (writes past tmax_out go to a spare slot that is
    cut off) and the caller replays the hole exactly on the host.
    """

    def mat(cons, ins_out, tlen):
        H = cons.shape[0]
        dev = cons.device
        m = torch.cat([cons[:, :, None], ins_out], dim=2).reshape(H, -1)
        col = torch.arange(tmax_in, dtype=torch.int32,
                           device=dev).repeat_interleave(1 + max_ins)
        keep = (m < 4) & (col[None, :] < tlen.to(torch.int32)[:, None])
        pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
        newlen = keep.sum(1, dtype=torch.int32)
        idx = torch.where(keep & (pos < tmax_out), pos, tmax_out).long()
        out = torch.full((H, tmax_out + 1), PAD, dtype=torch.uint8,
                         device=dev)
        out.scatter_(1, idx, m.to(torch.uint8))
        return out[:, :tmax_out].contiguous(), newlen, newlen > tmax_out

    return mat


def emit_insertions(ins_base: np.ndarray, ins_votes: np.ndarray,
                    ncov: np.ndarray, speculative: bool) -> np.ndarray:
    """Decide which insertion cells become columns (host, NumPy).

    Strict: a majority of covering passes insert at the slot.  Speculative
    (intermediate refinement rounds): also accept >=2-pass / >=1/3 support,
    so a base the draft is missing becomes a column whose vote next round
    does not split; wrong speculations are deleted by majority gap.
    """
    ins_base = np.asarray(ins_base)
    # widen before arithmetic: votes/coverage may arrive as uint8, and
    # *2 / //3 must not wrap
    ins_votes = np.asarray(ins_votes).astype(np.int32, copy=False)
    n = np.asarray(ncov).astype(np.int32, copy=False)[:, None]
    emit = ins_votes * 2 > n
    if speculative:
        emit |= ins_votes >= np.maximum(2, -(-n // 3))
    # prefix rule: rank r only emits if rank r-1 did
    emit = np.logical_and.accumulate(emit, axis=1)
    return np.where(emit, ins_base, PAD).astype(np.uint8)


def materialize(cons: np.ndarray, ins_out: np.ndarray, tlen: int) -> np.ndarray:
    """Interleave base + insertion columns into the consensus sequence:
    column j's base (if not gap), then the insertions after column j."""
    cons = np.asarray(cons)[:tlen]
    ins = np.asarray(ins_out)[:tlen]
    m = np.concatenate([cons[:, None], ins], axis=1).ravel()
    return m[m < 4].astype(np.uint8)
