"""Pre-alignment filter rules on k-mer seeding statistics (a copy of the
rules of the JAX package's ops/sketch.py that its host path applies).

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

``reject_from_hit`` applies (b) and (c) to an already-seeded pair, which
is how PairExecutor filters every pair of at least SCREEN_MIN_QT bases.
The JAX package's device screen (for pairs of SPECULATE_MIN_QT bases and
more) is not ported yet; the port seeds such pairs on the host and applies
the same rule to their statistics.
"""

from __future__ import annotations

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
