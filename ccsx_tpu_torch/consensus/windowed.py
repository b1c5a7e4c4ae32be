"""Windowed ("shred") consensus — the reference's default path
(ccs_for2, main.c:510-647), the long-context strategy of this framework.

The reference bounds POA size by consensing ~2kb windows per pass and
re-synchronizing cursors at an agreement breakpoint (SURVEY.md §5.7).  We
keep exactly that structure — it is what makes the kernel shapes static:

  window loop (host):
    slice window_size bases from each pass at its cursor
    star-MSA rounds over the windows (anchor = template pass window)
    scan for a breakpoint: `bp_window` consecutive MSA columns where the
      consensus is a base, per-column agreement >= colrate% of passes,
      >= minwin base columns, and EVERY pass matches in >= rowrate% of them
      (main.c:580-612)
    emit consensus columns before the breakpoint; advance each cursor by
      the bases that pass consumed there (main.c:622-638)
    no breakpoint -> grow the window by window_add (main.c:550) up to
      max_window, then force a flush (delta vs the reference's unbounded
      growth; --window-growth grow restores reference behavior — measured
      equivalent either way, BASELINE.md: the draft-anchored star MSA
      always finds breakpoints, so growth never engages in practice)
    any pass nearly exhausted (pos + window + minlen >= len) or <3 passes
      -> final flush of all tails (main.c:555-564)
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.consensus import prepare as prep
from ccsx_tpu_torch.consensus.star import (
    RoundResult, StarMsa, apply_hp_penalty, refine_rounds_gen, run_rounds,
)
from ccsx_tpu_torch.ops import encode as enc


def _window_sums(x: np.ndarray, w: int) -> np.ndarray:
    """Sliding sums of width w along the last axis: out[..., i] = sum x[..., i:i+w]."""
    c = np.cumsum(x, axis=-1, dtype=np.int64)
    pad = np.zeros(x.shape[:-1] + (1,), dtype=np.int64)
    c = np.concatenate([pad, c], axis=-1)
    return c[..., w:] - c[..., :-w]


def find_breakpoint(rr: RoundResult, nseq: int, cfg: CcsConfig) -> Optional[int]:
    """Vectorized equivalent of the reference's backward scan
    (main.c:580-612) over template-anchored columns.  Returns the highest
    valid breakpoint column i >= 1, or None."""
    W = cfg.bp_window
    T = rr.tlen
    if T < W + 1:
        return None
    match = rr.match[:nseq, :T]  # real rows only — padding rows never match
    isbase = (rr.cons[:T] < 4)
    matchcnt = match.sum(0)
    colrate = cfg.bp_colrate if nseq >= 10 else cfg.bp_colrate_lowpass
    colok = matchcnt * 100 >= colrate * nseq
    badbase = isbase & ~colok

    nog = _window_sums(isbase.astype(np.int64), W)          # (T-W+1,)
    bad = _window_sums(badbase.astype(np.int64), W)
    rowin = _window_sums((match & isbase[None, :]).astype(np.int64), W)

    valid = (bad == 0) & (nog >= cfg.bp_minwin) & isbase[: T - W + 1]
    rows_ok = (rowin * 100 >= cfg.bp_rowrate * nog[None, :]).all(axis=0)
    valid &= rows_ok
    # candidates are i in [1, T-W] (the reference scans msa_size-W down to 1)
    cand = np.nonzero(valid[1:])[0]
    if len(cand) == 0:
        return None
    return int(cand[-1]) + 1


def _advance(rr: RoundResult, bp: int) -> np.ndarray:
    """Per-pass query bases consumed by columns [0, bp) — non-gap cells,
    all insertions at slots < bp, and the leading insertions before
    column 0 (main.c:622-638 bumps pos through every MSA cell)."""
    nongap = (rr.aligned[:, :bp] < 4).sum(axis=1)
    ins = rr.ins_cnt[:, :bp].sum(axis=1)
    return (nongap + ins + rr.lead_ins).astype(np.int64)


def windowed_gen(passes: List[np.ndarray], cfg: CcsConfig):
    """Generator form of consensus_windowed: yields one RefineRequest per
    window attempt, receives RefineResults, returns the consensus codes
    (or (codes, phred_quals) with cfg.emit_quality) via
    StopIteration.value."""
    sm = StarMsa(cfg.align, cfg.max_ins_per_col, cfg.len_bucket_quant,
                 cfg.device)
    if len(passes) > cfg.max_passes:
        passes = passes[: cfg.max_passes]
    nseq = len(passes)
    pos = np.zeros(nseq, dtype=np.int64)
    lens = np.array([len(p) for p in passes], dtype=np.int64)
    out: List[np.ndarray] = []
    outq: List[np.ndarray] = []

    def emit(rr: RoundResult, upto=None, speculative=False):
        if not cfg.emit_quality:
            out.append(rr.materialize(upto=upto, speculative=speculative))
            return
        c, q = rr.materialize_with_qual(
            upto=upto, speculative=speculative,
            qv_coeffs=cfg.qv_coeffs, qmax=cfg.qv_cap)
        out.append(c)
        outq.append(q)

    flag = True
    while flag:
        window_size = cfg.window_init
        while True:
            fits = bool(
                ((pos + window_size + cfg.window_minlen) < lens).all())
            final = (not fits) or nseq < 3
            if final:
                windows = [p[int(pos[k]):] for k, p in enumerate(passes)]
            else:
                windows = [p[int(pos[k]):int(pos[k]) + window_size]
                           for k, p in enumerate(passes)]
            qs, qlens, row_mask = sm.pack(
                windows, cfg.pass_buckets, cfg.max_passes)
            # one RefineRequest per window attempt; non-final windows
            # consume only rr (materialize(upto=bp) + advance), the
            # final flush materializes the strict draft
            res = yield from refine_rounds_gen(
                qs, qlens, row_mask, windows[0], cfg.refine_iters)
            rr = res.rr

            if final:
                # the strict materialization of the final round — emit()
                # with speculative=False produces exactly `draft`
                emit(rr, speculative=False)
                flag = False
                break

            if rr.bp is not None:
                # device-computed scan (ops/breakpoint.py, batched path):
                # -1 encodes the spec's None
                bp = rr.bp if rr.bp >= 1 else None
            else:
                bp = find_breakpoint(rr, nseq, cfg)
            if cfg.verbose >= 3:
                # per-window breakpoint stats, -v level 3 (main.c:619-620)
                import sys

                print(f"[ccsx-tpu] window size={window_size} "
                      f"msa_cols={rr.tlen} breakpoint={bp}", file=sys.stderr)
            if bp is None and (
                    cfg.window_growth == "grow"
                    or window_size + cfg.window_add <= cfg.max_window):
                # no breakpoint: grow the window (main.c:550).  In "grow"
                # mode this is unbounded like the reference — the fits
                # check above flushes the tails once the window spans the
                # remaining pass lengths, exactly as main.c:555-564 does
                window_size += cfg.window_add
                continue
            if bp is None:
                # growth cap reached: force a flush point (delta vs the
                # reference's unbounded growth; disable via
                # window_growth="grow")
                bp = max(rr.tlen - cfg.bp_window, 1)
            emit(rr, upto=bp)
            if rr.advance is not None:
                # device advance was computed at this same bp_eff, and
                # arrives in THIS request's (P,) pass order whichever
                # executor ran (the pass-packed path scatters its
                # per-row advances back through row_mask; a masked row
                # consumed nothing, matching the fixed-P path's 0)
                pos += rr.advance[:nseq].astype(np.int64)
            else:
                pos += _advance(rr, bp)[:nseq]  # drop pass-bucket padding
            break

    codes = np.concatenate(out) if out else np.zeros(0, np.uint8)
    if not cfg.emit_quality:
        return codes
    quals = np.concatenate(outq) if outq else np.zeros(0, np.uint8)
    # hp penalty AFTER window assembly: a homopolymer run spanning a
    # window breakpoint must be penalized at its true length, not as
    # two split halves (star.apply_hp_penalty)
    return codes, apply_hp_penalty(codes, quals, cfg.qv_coeffs)


def consensus_windowed(passes: List[np.ndarray], cfg: CcsConfig):
    """Windowed consensus over oriented passes; passes[0] anchors.

    Returns consensus codes as an np.ndarray, or a (codes, quals)
    tuple when cfg.emit_quality is set (matching windowed_gen)."""
    sm = StarMsa(cfg.align, cfg.max_ins_per_col, cfg.len_bucket_quant,
                 cfg.device)
    return run_rounds(windowed_gen(passes, cfg), sm)


def ccs_windowed(zmw, aligner, cfg: CcsConfig):
    """Full default path for one ZMW (ccs_for2): prepare -> orient ->
    windowed star consensus.  Returns (seq_bytes, qual_bytes|None) per
    encode.to_record — the same contract as hole.ccs_hole — or None."""
    passes = prep.oriented_passes(zmw, aligner, cfg)
    if passes is None:  # main.c:515
        return None
    return enc.to_record(consensus_windowed(passes, cfg))
