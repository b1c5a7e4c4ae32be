"""The windowed consensus (NumPy), as a generator of refine requests.

Each window slices ``window_init`` bases from every pass at its cursor and
asks for a refinement (``RefineRequest``): ``iters`` speculative rounds and
a strict one, stopping early when a speculative round leaves the draft
unchanged.  The final round's columns are scanned for a breakpoint: the
last column i >= 1 that starts ``bp_window`` columns all called as bases,
at least ``bp_minwin`` of them, where every column is matched by at least
colrate% of the passes (80%, 60% under ten passes) and every pass matches
at least rowrate% (80%) of them.  The consensus before it is emitted and
each cursor advances by the bases its pass spent there.  No breakpoint: the
window grows by ``window_add`` up to ``max_window``, then is flushed at
``tlen - bp_window``.  When a pass would run out (cursor + window +
``window_minlen`` >= its length) or fewer than 3 passes remain, the tails
are refined as the last window and emitted whole.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

BP_WINDOW = 10
BP_MINWIN = 5
BP_ROWRATE = 80
BP_COLRATE = 80
BP_COLRATE_LOWPASS = 60
WINDOW_INIT = 2048
WINDOW_ADD = 2048
WINDOW_MINLEN = 1024
MAX_WINDOW = 8192


@dataclasses.dataclass
class RefineRequest:
    passes: List[np.ndarray]   # the window of each pass, template first
    draft: np.ndarray
    iters: int


def _window_sums(x: np.ndarray, w: int) -> np.ndarray:
    c = np.cumsum(x, axis=-1, dtype=np.int64)
    c = np.concatenate([np.zeros(x.shape[:-1] + (1,), np.int64), c], axis=-1)
    return c[..., w:] - c[..., :-w]


def find_breakpoint(rr, nseq: int) -> Optional[int]:
    W = BP_WINDOW
    T = rr.tlen
    if T < W + 1:
        return None
    match = rr.match[:nseq, :T]
    isbase = rr.cons[:T] < 4
    matchcnt = match.sum(0)
    colrate = BP_COLRATE if nseq >= 10 else BP_COLRATE_LOWPASS
    colok = matchcnt * 100 >= colrate * nseq
    badbase = isbase & ~colok
    nog = _window_sums(isbase.astype(np.int64), W)
    bad = _window_sums(badbase.astype(np.int64), W)
    rowin = _window_sums((match & isbase[None, :]).astype(np.int64), W)
    valid = (bad == 0) & (nog >= BP_MINWIN) & isbase[: T - W + 1]
    valid &= (rowin * 100 >= BP_ROWRATE * nog[None, :]).all(axis=0)
    cand = np.nonzero(valid[1:])[0]
    if len(cand) == 0:
        return None
    return int(cand[-1]) + 1


def _advance(rr, bp: int) -> np.ndarray:
    nongap = (rr.aligned[:, :bp] < 4).sum(axis=1)
    ins = rr.ins_cnt[:, :bp].sum(axis=1)
    return (nongap + ins + rr.lead_ins).astype(np.int64)


def consensus(passes: List[np.ndarray], iters: int, max_passes: int):
    """Yields RefineRequests, receives each one's final Round; returns the
    consensus codes."""
    passes = passes[:max_passes]
    nseq = len(passes)
    pos = np.zeros(nseq, dtype=np.int64)
    lens = np.array([len(p) for p in passes], dtype=np.int64)
    out: List[np.ndarray] = []
    while True:
        size = WINDOW_INIT
        while True:
            final = (not bool(((pos + size + WINDOW_MINLEN) < lens).all())
                     or nseq < 3)
            if final:
                windows = [p[int(pos[k]):] for k, p in enumerate(passes)]
            else:
                windows = [p[int(pos[k]):int(pos[k]) + size]
                           for k, p in enumerate(passes)]
            rr = yield RefineRequest(windows, windows[0], iters)
            if final:
                out.append(rr.materialize(speculative=False))
                codes = np.concatenate(out) if out else np.zeros(0, np.uint8)
                return codes
            bp = find_breakpoint(rr, nseq)
            if bp is None and size + WINDOW_ADD <= MAX_WINDOW:
                size += WINDOW_ADD
                continue
            if bp is None:
                bp = max(rr.tlen - BP_WINDOW, 1)
            out.append(rr.materialize(upto=bp))
            pos += _advance(rr, bp)[:nseq]
            break
