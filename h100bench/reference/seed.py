"""k-mer diagonal seeding of a pair check (NumPy): shared 13-mers (at most
4 hits a k-mer) vote for diagonals qpos - tpos in bins of 32, adjacent bins
summed; the winning pair of bins, with at least 3 votes, gives the median
diagonal, and that diagonal's nominal line through the pair."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

K = 13
MAX_HITS_PER_KMER = 4
DIAG_BIN = 32


class SeedHit(NamedTuple):
    diag: int
    votes: int
    line: np.ndarray


def kmer_codes(seq: np.ndarray, k: int = K) -> np.ndarray:
    seq = np.asarray(seq, dtype=np.int64)
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    codes = np.zeros(n, dtype=np.int64)
    bad = np.zeros(n, dtype=bool)
    for i in range(k):
        w = seq[i:i + n]
        codes = (codes << 2) | (w & 3)
        bad |= w >= 4
    codes[bad] = -1
    return codes


def seed_diagonal(q: np.ndarray, t: np.ndarray, k: int = K,
                  min_votes: int = 3) -> Optional[SeedHit]:
    qk = kmer_codes(q, k)
    tk = kmer_codes(t, k)
    vals = np.where(tk < 0, np.int64(1) << np.int64(2 * k), tk)
    order = np.argsort(vals, kind="stable")
    tks = vals[order]
    if len(qk) == 0 or len(tks) == 0:
        return None
    left = np.searchsorted(tks, qk, side="left")
    right = np.searchsorted(tks, qk, side="right")
    cnt = np.minimum(right - left, MAX_HITS_PER_KMER)
    cnt[qk < 0] = 0
    total = int(cnt.sum())
    if total == 0:
        return None
    qpos = np.repeat(np.arange(len(qk)), cnt)
    starts = np.repeat(left, cnt)
    run_ids = np.repeat(np.cumsum(cnt) - cnt, cnt)
    offs = np.arange(total) - run_ids
    tpos = order[starts + offs]
    diags = qpos - tpos
    lo = -len(t)
    nbins = (len(q) + len(t)) // DIAG_BIN + 2
    binned = (diags - lo) // DIAG_BIN
    hist = np.bincount(binned, minlength=nbins)
    paired = hist[:-1] + hist[1:]
    best = int(np.argmax(paired))
    votes = int(paired[best])
    if votes < min_votes:
        return None
    in_best = (binned == best) | (binned == best + 1)
    diag = int(np.median(diags[in_best]))
    Q, T = len(q), len(t)
    i0 = max(diag, 0)
    j0 = i0 - diag
    i1 = min(Q, T + diag)
    j1 = i1 - diag
    return SeedHit(diag=diag, votes=votes,
                   line=np.array([i0, j0, i1, j1], dtype=np.int32))
