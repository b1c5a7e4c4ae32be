"""The hole model: one ZMW's subreads from a seed, vectorised.

A hole is one circular template read many times, each traversal an
independently noisy copy on the strand opposite to the last.  This is the
port's ``utils/synth`` model (``mutate``, ``make_zmw(partial_ends=True)``,
``read_through``, ``make_long_fasta``'s interrupted traversals) rewritten
with whole-array NumPy operations, so that a window's thousands of holes
are made in seconds:

* per template base: a deletion with ``del_rate``, else a substitution with
  ``sub_rate`` (to one of the three other bases), else the base; after a
  base that was not deleted, a geometric run of uniform inserted bases
  (each further one with ``ins_rate``);
* the full traversals' count and the template length from the mix's laws,
  stratified: every block of ``BLOCK`` consecutive holes takes the laws'
  same ``BLOCK`` quantiles, in an order drawn from the seed, so any seed's
  first k blocks hold the same sizes and a window's work does not depend
  on the seed's luck;
* a partial first pass (its last 30-60%) and a partial last pass (its
  first 30-60%), since the polymerase starts and stops mid-molecule;
* on every ``read_through_every``-th hole an adapter read-through (a
  traversal that runs on round the hairpin: template ++ revcomp(template),
  each half noisy) in the middle of the hole;
* in ``interrupt.prob`` of the gaps between two full traversals (rounded,
  at gaps drawn from the seed), an interrupted traversal (a head fragment
  of ``lo``-``hi`` of a traversal, at least ``min_len`` bases) on its own
  strand of the alternation.

Every hole draws from its own generator, ``default_rng([seed, index])``, so
any hole can be made again on its own, by the reference as by the corpus.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import List

import numpy as np

FULL, PARTIAL, READ_THROUGH, INTERRUPTED = 0, 1, 2, 3
BLOCK = 64
_MASK = 2 ** 63 - 1


@dataclasses.dataclass
class Hole:
    index: int
    template: np.ndarray          # uint8 codes 0-3
    passes: List[np.ndarray]      # uint8 codes, as sequenced
    kinds: List[int]              # FULL / PARTIAL / READ_THROUGH / INTERRUPTED

    @property
    def bases(self) -> int:
        return int(sum(len(p) for p in self.passes))


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


def mutate(rng: np.random.Generator, seq: np.ndarray, sub_rate: float,
           ins_rate: float, del_rate: float) -> np.ndarray:
    """One noisy copy of ``seq`` (the module docstring's error model)."""
    n = len(seq)
    r = rng.random(n)
    keep = r >= del_rate
    sub = keep & (r < del_rate + sub_rate)
    base = seq.copy()
    base[sub] = (seq[sub] + 1 + rng.integers(0, 3, int(sub.sum()))) % 4
    n_ins = rng.geometric(1.0 - ins_rate, n) - 1
    n_ins[~keep] = 0
    seg = keep.astype(np.int64) + n_ins
    total = int(seg.sum())
    out = rng.integers(0, 4, total).astype(np.uint8)
    starts = np.cumsum(seg) - seg
    out[starts[keep]] = base[keep]
    return out


def quantile(law: dict, u: float) -> int:
    """The whole number at quantile ``u`` of a law of the traffic file:
    ``uniform`` over [lo, hi], or ``lognormal`` with ``median`` and
    ``sigma``, rounded and clipped to [lo, hi]."""
    if law["law"] == "uniform":
        return int(law["lo"] + int(u * (law["hi"] - law["lo"] + 1)))
    if law["law"] == "lognormal":
        x = law["median"] * np.exp(law["sigma"]
                                   * statistics.NormalDist().inv_cdf(u))
        return int(np.clip(np.round(x), law["lo"], law["hi"]))
    raise ValueError(f"unknown law {law['law']!r}")


def stratum(seed: int, index: int, which: int) -> float:
    """Hole ``index``'s quantile of law ``which``: its block's quantiles
    (k + 0.5) / BLOCK in the seed's order for that block."""
    block, slot = divmod(int(index), BLOCK)
    perm = np.random.default_rng(
        [int(seed) & _MASK, block, which]).permutation(BLOCK)
    return (int(perm[slot]) + 0.5) / BLOCK


def make_hole(seed: int, index: int, mix: dict, errors: dict) -> Hole:
    """Hole ``index`` of the corpus of ``seed`` under ``mix`` (a traffic
    file's dict) and ``errors`` (a configuration's sub/ins/del rates)."""
    rng = np.random.default_rng([int(seed) & _MASK, int(index)])
    tlen = quantile(mix["template"], stratum(seed, index, 0))
    n_full = quantile(mix["full_passes"], stratum(seed, index, 1))
    template = rng.integers(0, 4, tlen).astype(np.uint8)
    inter = mix.get("interrupt") or {}
    gaps = max(n_full - 1, 0)
    n_inter = int(round(float(inter.get("prob", 0.0)) * gaps))
    at_gap = set(int(g) + 1 for g in rng.choice(gaps, n_inter,
                                                replace=False)) \
        if n_inter else set()
    passes: List[np.ndarray] = []
    kinds: List[int] = []
    strand = 0

    def traversal():
        nonlocal strand
        p = mutate(rng, template, **errors)
        if strand:
            p = revcomp(p)
        strand ^= 1
        return p

    if mix.get("partial_ends", True):
        p = traversal()
        keep = max(int(len(p) * (0.3 + 0.3 * rng.random())), 50)
        passes.append(p[-keep:])
        kinds.append(PARTIAL)
    for k in range(n_full):
        if k in at_gap:
            p = traversal()
            keep = int(len(p) * (inter["lo"]
                                 + (inter["hi"] - inter["lo"]) * rng.random()))
            passes.append(p[:max(keep, int(inter["min_len"]))])
            kinds.append(INTERRUPTED)
        passes.append(traversal())
        kinds.append(FULL)
    if mix.get("partial_ends", True):
        p = traversal()
        keep = max(int(len(p) * (0.3 + 0.3 * rng.random())), 50)
        passes.append(p[:keep])
        kinds.append(PARTIAL)
    every = int(mix.get("read_through_every", 0))
    if every and index % every == 0:
        rt = np.concatenate([mutate(rng, template, **errors),
                             revcomp(mutate(rng, template, **errors))])
        at = len(passes) // 2
        passes.insert(at, rt)
        kinds.insert(at, READ_THROUGH)
    return Hole(index=index, template=template, passes=passes, kinds=kinds)
