"""Synthetic ZMW/subread generator for tests and benchmarks.

Models the PacBio data the reference consumes: a circular template read many
times with alternating strand per pass (main.c:374-375 walks outward from the
template alternating expected strand), each pass an independently noisy copy
(mismatches + insertions + deletions).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ccsx_tpu_torch.ops import encode as enc


@dataclasses.dataclass
class SynthZmw:
    movie: str
    hole: str
    template: np.ndarray          # 2-bit codes
    passes: List[np.ndarray]      # 2-bit codes, oriented as sequenced
    strands: List[int]            # 0 fwd / 1 rev per pass

    @property
    def names(self) -> List[str]:
        out = []
        off = 0
        for p in self.passes:
            out.append(f"{self.movie}/{self.hole}/{off}_{off + len(p)}")
            off += len(p)
        return out

    def fasta(self) -> str:
        recs = []
        for name, p in zip(self.names, self.passes):
            recs.append(f">{name}\n{enc.decode(p)}\n")
        return "".join(recs)


def _run_lengths(seq: np.ndarray) -> np.ndarray:
    """len of the maximal homopolymer run containing each position."""
    n = len(seq)
    runs = np.empty(n, np.int32)
    i = 0
    while i < n:
        j = i
        while j < n and seq[j] == seq[i]:
            j += 1
        runs[i:j] = j - i
        i = j
    return runs


def mutate(
    rng: np.random.Generator,
    seq: np.ndarray,
    sub_rate: float,
    ins_rate: float,
    del_rate: float,
    hp_factor: float = 0.0,
    hp_ins_same: float = 0.0,
    context_sub: Optional[tuple] = None,
) -> np.ndarray:
    """Apply per-base errors to a 2-bit sequence.

    Defaults are the i.i.d. model (and consume the identical rng
    stream, so seeded fixtures are unchanged).  The optional knobs
    model where real CCS consensus and QV calibration actually get
    stressed — errors CORRELATED across passes at the same template
    loci, so unanimous columns can be unanimously wrong:

    * ``hp_factor`` — indel rates scale by (1 + hp_factor*min(run-1, 4))
      inside homopolymer runs (PacBio's dominant error mode).
    * ``hp_ins_same`` — probability an inserted base copies the current
      base (homopolymer extension) instead of being uniform.
    * ``context_sub`` — per-base (A,C,G,T) multiplier on sub_rate.
    """
    biased = hp_factor or context_sub is not None
    runs = _run_lengths(seq) if hp_factor else None
    out = []
    for i, b in enumerate(seq):
        dr, sr, ir = del_rate, sub_rate, ins_rate
        if biased:
            if hp_factor:
                m = 1.0 + hp_factor * min(int(runs[i]) - 1, 4)
                dr, ir = dr * m, ir * m
            if context_sub is not None:
                sr = sr * context_sub[int(b)]
        r = rng.random()
        if r < dr:
            continue
        if r < dr + sr:
            out.append((int(b) + 1 + rng.integers(3)) % 4)
        else:
            out.append(int(b))
        while rng.random() < ir:
            if hp_ins_same and rng.random() < hp_ins_same:
                out.append(int(b))
            else:
                out.append(int(rng.integers(4)))
    return np.array(out, dtype=np.uint8)


def make_zmw(
    rng: np.random.Generator,
    template_len: int = 1000,
    n_passes: int = 5,
    sub_rate: float = 0.02,
    ins_rate: float = 0.04,
    del_rate: float = 0.04,
    movie: str = "m0",
    hole: str = "1",
    first_strand: int = 0,
    template: Optional[np.ndarray] = None,
    partial_ends: bool = False,
    hp_factor: float = 0.0,
    hp_ins_same: float = 0.0,
    context_sub: Optional[tuple] = None,
) -> SynthZmw:
    """With ``partial_ends``, the first and last passes are truncated
    fragments (the polymerase starts/ends mid-molecule on real ZMWs) —
    these fall outside the dominant length group, forcing the prepare
    stage through its alignment-verified strand walk (main.c:392-406)
    instead of the trusted-parity shortcut."""
    if template is None:
        template = rng.integers(0, 4, size=template_len).astype(np.uint8)
    passes, strands = [], []
    for k in range(n_passes):
        strand = (first_strand + k) % 2
        p = mutate(rng, template, sub_rate, ins_rate, del_rate,
                   hp_factor=hp_factor, hp_ins_same=hp_ins_same,
                   context_sub=context_sub)
        if strand:
            p = enc.revcomp_codes(p)
        if partial_ends and n_passes >= 5 and k in (0, n_passes - 1):
            frac = 0.3 + 0.3 * rng.random()  # keep 30-60%
            keep = max(int(len(p) * frac), 50)
            # first pass keeps its tail (run-up), last keeps its head
            p = p[-keep:] if k == 0 else p[:keep]
        passes.append(p)
        strands.append(strand)
    return SynthZmw(movie=movie, hole=hole, template=template,
                    passes=passes, strands=strands)


def read_through(
    rng: np.random.Generator,
    template: np.ndarray,
    sub_rate: float = 0.02,
    ins_rate: float = 0.04,
    del_rate: float = 0.04,
) -> np.ndarray:
    """A missed-adapter ("read-through") pass: template ++
    revcomp(template), each half independently noisy.  ~2x the template
    group length, so the reference's prepare stage aligns and clips it
    to one template span (main.c:392-406) instead of trusting strand
    parity."""
    return np.concatenate([
        mutate(rng, template, sub_rate, ins_rate, del_rate),
        enc.revcomp_codes(mutate(rng, template, sub_rate, ins_rate,
                                 del_rate)),
    ])


def make_fasta(zmws: List[SynthZmw]) -> str:
    return "".join(z.fasta() for z in zmws)


def identity(a: np.ndarray, b: np.ndarray) -> float:
    """Global-alignment identity between two code sequences (oracle-based)."""
    from ccsx_tpu_torch.ops import oracle

    rs = oracle.align(a, b, mode="global")
    return rs.identity


def identity_either(a: np.ndarray, b: np.ndarray) -> float:
    """Identity of a vs b in the better of the two orientations.

    Consensus strand follows the chosen template pass (an arbitrary strand,
    in the reference as here), so template comparisons must accept either.
    """
    return max(identity(a, b), identity(enc.revcomp_codes(a), b))


# ---- the scale corpus (a copy of benchmarks/e2e_scale.make_big_bam with
#      benchmarks/quality's error rates and pass-count distribution) ----

# per-pass subread error rates (CLR-like: ~12% total, indel heavy)
ERR = dict(sub_rate=0.02, ins_rate=0.05, del_rate=0.05)


def sample_pass_counts(rng, n, lo=5, hi=30):
    """Log-normal pass counts: median ~9, tail to ~30."""
    counts = np.clip(np.round(rng.lognormal(np.log(9), 0.45, n)),
                     lo, hi).astype(int)
    return counts


def make_big_bam(path, n_holes: int, rng, tlen_lo=1000, tlen_hi=5000):
    """A realistic subreads.bam: lognormal pass counts, mixed-length
    templates (default 1-5 kb), truncated first/last passes, an adapter
    read-through on every 5th hole, BGZF container.  ``rng`` =
    default_rng(42) with 64 holes is the 64-hole scale corpus."""
    from ccsx_tpu_torch.io import bam

    counts = sample_pass_counts(rng, n_holes)
    tlens = rng.integers(tlen_lo, tlen_hi + 1, n_holes)
    zs = []
    recs = []
    for h in range(n_holes):
        z = make_zmw(rng, int(tlens[h]), int(counts[h]),
                     movie="mv", hole=str(h), partial_ends=True, **ERR)
        if h % 5 == 0:
            # read-through: longer than the template group, so the strand
            # walk aligns and clips it
            z.passes.insert(len(z.passes) // 2,
                            read_through(rng, z.template, **ERR))
            z.strands.insert(len(z.strands) // 2, 0)
        zs.append(z)
        for name, p in zip(z.names, z.passes):
            recs.append((name, enc.decode(p).encode(), None))
    bam.write_bam(path, recs, bgzf=True)
    return zs
