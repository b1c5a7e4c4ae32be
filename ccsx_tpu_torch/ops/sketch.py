"""The pre-alignment screen and its filter rules (the JAX package's
ops/sketch.py): batched k-mer statistics of strand-walk pairs on the
device, and the rules that reject hopeless pairs before the banded DP.

The orientation walk's strand_match pairs can be rejected before the
banded DP by three rules over k-mer seeding statistics; each only rejects
pairs whose acceptance (main.c:280) would fail, so output bytes do not
depend on the filter firing:

(a) **Seed-gate parity**: ``votes < MIN_VOTES`` or ``total == 0`` (exactly
    the pairs seed_diagonal returns None for).
(b) **Noise gate**: ``votes < min(qlen, tlen) >> NOISE_GATE_SHIFT``;
    identical to (a) below min(qlen, tlen) = SCREEN_MIN_QT.
(c) **Band-overlap impossibility**: when the seeded line would be used
    (|diag| > band/4), the band cannot reach enough matched bases.

``screen_step`` computes, for a whole (qmax, tmax) group of pairs in one
batch of tensor ops, exactly the statistics the host seed gate reads: the
capped k-mer hit total, the best two-bin diagonal-window vote count and
that window's lower edge.  ``reject_reason`` applies (a)-(c) to them;
PairExecutor screens this way the pairs of at least SPECULATE_MIN_QT bases
that it seeds on the host.  ``reject_from_hit`` applies (b) and (c) to an
already-seeded pair (any pair of at least SCREEN_MIN_QT bases not screened
so).  ``screen_host`` is the NumPy twin: the host rung of a failed screen
and the device screen's oracle.

The device functions are equal to the host's by construction: the same
codes, a stable sort of the template's codes (bad and pad codes on one
tail sentinel that no valid query code reaches), searchsorted left and
right, the first MAX_HITS hits of a code in sorted order, a floor-division
DIAG_BIN histogram with the hits that do not count sent to a spare bin,
and the first maximum of the paired bins.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ccsx_tpu_torch.ops import seed as seed_mod

K = seed_mod.DEFAULT_K
MAX_HITS = seed_mod.MAX_HITS_PER_KMER
DIAG_BIN = seed_mod.DIAG_BIN
SENTINEL = 1 << (2 * K)    # one past the largest 13-mer code; fits int32
MIN_VOTES = 3              # seed_diagonal's default gate
# noise gate: votes < min(qlen, tlen) >> NOISE_GATE_SHIFT (rule (b));
# identical to the legacy gate below min(Q,T) = MIN_VOTES << SHIFT
NOISE_GATE_SHIFT = 9
# screening floor: below it rule (b) degenerates to the seed gate
SCREEN_MIN_QT = (MIN_VOTES + 1) << NOISE_GATE_SHIFT   # 2048
# the device screen's floor and the walk's fwd+RC speculation floor
# (prepare.PairBatch): a speculated wrong arm must die in the screen
SPECULATE_MIN_QT = 16384
# band-geometry slack for rule (c): the binned (seed.DIAG_BIN) diagonal
# estimate, the boundary fringes and the offset tracker's catch-up
BAND_SLACK = 8 * 128
_MAXSHIFT = 4              # banded fill default, pinned by the kernels


def noise_gate(qlen: int, tlen: int) -> int:
    """The vote threshold of rules (a)+(b) for a (qlen, tlen) pair."""
    return max(MIN_VOTES, min(qlen, tlen) >> NOISE_GATE_SHIFT)


def _mat_upper_bound(diag: int, qlen: int, tlen: int) -> int:
    """Upper bound on matched bases the banded local DP can produce with
    its band following a slope-1 line on ``diag`` (rule (c))."""
    overlap = max(0, min(qlen - diag, tlen) - max(-diag, 0))
    bound = overlap + BAND_SLACK
    if diag < 0:
        # crawl phase: the band offset starts at 0 and closes on the
        # line at <= maxshift cols/row, one match per crawl row
        bound += min((-diag) // (_MAXSHIFT - 1),
                     min(qlen, tlen) // _MAXSHIFT) + _MAXSHIFT
    return bound


def reject_from_hit(hit, qlen: int, tlen: int, pct: int,
                    band: int) -> str:
    """'' (keep) or the rule that rejects an already-seeded pair (a
    seed.SeedHit).  ``hit is None`` is rule (a), handled by the caller."""
    if hit.votes < noise_gate(qlen, tlen):
        return "noise_gate"         # rule (b): statistical
    if abs(int(hit.diag)) <= band // 4:
        return ""                   # corner-line case: full overlap
    minqt = min(qlen, tlen)
    if _mat_upper_bound(int(hit.diag), qlen, tlen) * 200 <= minqt * pct:
        return "band_overlap"       # rule (c): provable geometry
    return ""


def reject_reason(total: int, votes: int, win_lo: int, qlen: int,
                  tlen: int, pct: int, band: int) -> str:
    """'' (keep) or the rule that rejects a screened pair, from its screen
    triple; ``win_lo`` is the lower diagonal edge of the best two-bin
    window [win_lo, win_lo + 2*DIAG_BIN)."""
    if total <= 0 or votes < MIN_VOTES:
        return "seed_gate"          # rule (a): host parity, provable
    if votes < noise_gate(qlen, tlen):
        return "noise_gate"         # rule (b): statistical
    # rule (c) at the window's |d|-minimal edge: the bound is monotone in
    # |d|, so this is the most permissive diagonal the median could take
    win_hi = win_lo + 2 * DIAG_BIN - 1
    d_best = min(max(0, win_lo), win_hi) if win_lo <= 0 <= win_hi \
        else (win_lo if win_lo > 0 else win_hi)
    if abs(d_best) <= band // 4:
        return ""
    minqt = min(qlen, tlen)
    # acceptance => aln*2 > minqt and mat*100 >= aln*pct => mat*200 > minqt*pct
    if _mat_upper_bound(int(d_best), qlen, tlen) * 200 <= minqt * pct:
        return "band_overlap"       # rule (c): provable geometry
    return ""


# ---- host twin -------------------------------------------------------------

def screen_host(q: np.ndarray, t: np.ndarray,
                t_index=None) -> Tuple[int, int, int]:
    """(total, votes, win_lo) for one pair, NumPy: seed_diagonal's counting
    up to (and excluding) the median."""
    qk = seed_mod.kmer_codes(q)
    if t_index is None:
        t_index = seed_mod.sorted_kmer_index(t)
    tks, order = t_index
    if len(qk) == 0 or len(tks) == 0:
        return (0, 0, 0)
    left = np.searchsorted(tks, qk, side="left")
    right = np.searchsorted(tks, qk, side="right")
    cnt = np.minimum(right - left, MAX_HITS)
    cnt[qk < 0] = 0
    total = int(cnt.sum())
    if total == 0:
        return (0, 0, 0)
    qpos = np.repeat(np.arange(len(qk)), cnt)
    starts = np.repeat(left, cnt)
    run_ids = np.repeat(np.cumsum(cnt) - cnt, cnt)
    offs = np.arange(total) - run_ids
    diags = qpos - order[starts + offs]
    lo = -len(t)
    nbins = (len(q) + len(t)) // DIAG_BIN + 2
    hist = np.bincount((diags - lo) // DIAG_BIN, minlength=nbins)
    paired = hist[:-1] + hist[1:]
    best = int(np.argmax(paired))
    return (total, int(paired[best]), best * DIAG_BIN + lo)


# ---- the device screen: batched tensor ops over (N, ...) rows ---------------

def _codes_dev(seq: torch.Tensor, k: int) -> torch.Tensor:
    """seed.kmer_codes over the rows of a padded (N, L) uint8 code tensor:
    (N, L - k + 1) int32, -1 for a window that touches an N (code 4) or the
    PAD byte (5), which makes the padded tail inert."""
    n = seq.shape[1] - k + 1
    s = seq.to(torch.int32)
    code = torch.zeros((seq.shape[0], n), dtype=torch.int32,
                       device=seq.device)
    bad = torch.zeros((seq.shape[0], n), dtype=torch.bool, device=seq.device)
    for i in range(k):
        w = s[:, i:i + n]
        code = (code << 2) | (w & 3)
        bad |= w >= 4
    return torch.where(bad, -1, code)


def _t_index_dev(t: torch.Tensor):
    """seed.sorted_kmer_index per row: the template codes sorted ascending
    by a STABLE sort (real codes keep the host's position order; bad and
    pad codes share the tail SENTINEL) and the positions they came from."""
    tk = _codes_dev(t, K)
    vals = torch.where(tk < 0, SENTINEL, tk)
    tks, order = torch.sort(vals, dim=1, stable=True)
    return tks.contiguous(), order


def _hits_dev(q: torch.Tensor, t: torch.Tensor):
    """The capped hit machinery shared by the screen and the seeder:
    (cnt, left, order, qpos) with cnt (N, Qn) = min(right - left,
    MAX_HITS), 0 for a bad query code."""
    qk = _codes_dev(q, K).contiguous()
    tks, order = _t_index_dev(t)
    left = torch.searchsorted(tks, qk, right=False).to(torch.int32)
    right = torch.searchsorted(tks, qk, right=True).to(torch.int32)
    cnt = torch.clamp(right - left, max=MAX_HITS)
    cnt = torch.where(qk < 0, 0, cnt)
    qpos = torch.arange(qk.shape[1], dtype=torch.int32, device=q.device)
    return cnt, left, order, qpos


def _diag_hist_dev(cnt, left, order, qpos, tlen, nb: int):
    """The DIAG_BIN histogram over the capped hits, (N, nb) int32, with
    the hits' diagonals (N, Qn, MAX_HITS), their mask and lo = -tlen
    (N, 1).  Hit j of query position p is the j-th entry of its run in
    sorted order, counted when j < cnt; the rest go to the spare bin nb,
    which is dropped.  ``nb`` is at least every (qlen + tlen) // DIAG_BIN
    + 2 of the group; bins past a row's own range stay 0."""
    N, Tn = order.shape
    lo = -tlen.to(torch.int32)[:, None]
    diags, oks = [], []
    for j in range(MAX_HITS):
        ok = j < cnt
        at = torch.clamp(left + j, 0, Tn - 1).long()
        tpos = order.gather(1, at).to(torch.int32)
        diags.append(qpos[None, :] - tpos)
        oks.append(ok)
    diags = torch.stack(diags, 2)
    inhit = torch.stack(oks, 2)
    b = torch.div(diags - lo[:, :, None], DIAG_BIN, rounding_mode="floor")
    b = torch.where(inhit & (b >= 0) & (b < nb), b, nb)
    rows = torch.arange(N, device=b.device)[:, None, None] * (nb + 1)
    hist = torch.bincount((b + rows).reshape(-1).long(),
                          minlength=N * (nb + 1)).view(N, nb + 1)
    return hist[:, :nb].to(torch.int32), diags, inhit, lo


def _best_window(hist):
    """(best (N,), votes (N,)): the first maximum of the paired bins."""
    paired = hist[:, :-1] + hist[:, 1:]
    best = torch.argmax(paired, dim=1)
    return best.to(torch.int32), paired.gather(1, best[:, None])[:, 0]


def screen_step(qmax: int, tmax: int):
    """The batched screen: f(big (N, qmax+tmax) uint8 codes, small (N, 2)
    int32 lengths) -> (N, 3) int32 (total, votes, win_lo), on the device
    the tensors live on; votes and win_lo are 0 when total is 0."""
    nb = (qmax + tmax) // DIAG_BIN + 2

    def step(big: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
        q, t = big[:, :qmax], big[:, qmax:qmax + tmax]
        cnt, left, order, qpos = _hits_dev(q, t)
        total = cnt.sum(1, dtype=torch.int32)
        hist, _, _, lo = _diag_hist_dev(cnt, left, order, qpos, small[:, 1],
                                        nb)
        best, votes = _best_window(hist)
        win_lo = best * DIAG_BIN + lo[:, 0]
        empty = total == 0
        return torch.stack([total, torch.where(empty, 0, votes),
                            torch.where(empty, 0, win_lo)],
                           dim=1).to(torch.int32)

    return step
