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


# ---- the long-molecule corpus (a copy of benchmarks/long_molecule's
#      make_long_fasta, its default "partials" corpus) ----

# a modern-chemistry ~5% per-pass error mix: at 12% the pass-vs-pass indel
# random walk out-drifts the +-64-diagonal band by 50 kb
ERR_LONG = dict(sub_rate=0.01, ins_rate=0.02, del_rate=0.02)


def make_long_fasta(path: str, holes: int, tlen: int, n_passes: int,
                    seed: int) -> None:
    """``holes`` molecules of ``tlen`` bases, each with ``n_passes``
    COMPLETE traversals and two interrupted ones (12-40% head fragments, of
    at least 1,200 bases, on the right alternating strand) between each
    consecutive pair: the ultra-long regime, where the strand walk verifies
    every complete pass by alignment and about half of them try the
    wrong-strand arm first.  Seed 11 with 4 x 50,000 bases and 8 passes is
    the ``4x50000`` scenario of benchmarks/long_molecule_r11.json."""
    rng = np.random.default_rng(seed)
    zs = []
    for h in range(holes):
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        passes, strands = [], []
        for trav in range(3 * n_passes - 2):
            strand = trav % 2
            p = mutate(rng, t, **ERR_LONG)
            if strand:
                p = enc.revcomp_codes(p)
            if trav % 3:   # interrupted traversal: head fragment
                keep = int(len(p) * (0.12 + 0.28 * rng.random()))
                p = p[:max(keep, 1200)]
            passes.append(p)
            strands.append(strand)
        zs.append(SynthZmw(movie="mv", hole=str(h), template=t,
                           passes=passes, strands=strands))
    with open(path, "w") as f:
        f.write(make_fasta(zs))


def _tie_pair(seed: int, tlen: Optional[int] = None):
    """A noisy pair (found by a seed search) whose local path statistics
    change if one level of the F scan let the earlier cell win a tie: seed
    119 the exclusive step, seed 2100 the in-lane scan."""
    rng = np.random.default_rng(seed)
    n = tlen if tlen is not None else int(rng.integers(100, 250))
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = mutate(rng, t, 0.1, 0.15, 0.15)
    if rng.random() < 0.5:
        q = np.concatenate([rng.integers(0, 2, int(rng.integers(1, 40))
                                         ).astype(np.uint8), q])
    return q, t, None


def fill_tie_cases(rng, qmax: int = 320, tmax: int = 448):
    """A batch for the banded fills where ties decide: homopolymers and
    all-equal sequences (every E and F choice ties), short repeats, an
    all-mismatch pair, qlen 0, 1 and == qmax, tlen < 128, a template much
    longer than its query (the band clips at tcap), and noisy pairs.  Each
    problem has a nominal line for the local fill (its corners, or a seeded
    one: some start at li0 > 1, so the first rows' numerators are negative,
    one falls).  Returns (qs, qlens, ts, tlens, lines) as numpy arrays:
    uint8 (n, qmax) and (n, tmax) padded with 5, int32 (n,) and (n, 4)."""
    def seq(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    zeros = np.zeros
    rep = np.tile(np.array([0, 1], np.uint8), tmax)
    tl = seq(260)
    long_t = seq(tmax)
    noisy = mutate(rng, tl, 0.03, 0.08, 0.08)
    cases = [
        (zeros(60, np.uint8), zeros(50, np.uint8), None),      # homopolymer
        (zeros(90, np.uint8), zeros(200, np.uint8), (20, 5, 90, 190)),
        (zeros(40, np.uint8), np.full(70, 2, np.uint8), None),  # all mismatch
        (rep[:150], rep[:171], None),                          # repeats
        (rep[:140], np.concatenate([rep[:60], rep[61:130]]), (3, 0, 140, 129)),
        (np.zeros(0, np.uint8), tl[:100], None),               # qlen 0
        (tl[:1], tl[:90], None),                               # qlen 1
        (np.concatenate([noisy, seq(qmax)]), tl, None),        # == qmax
        (noisy[:100], tl[:110], None),                         # tlen < 128
        (noisy[:150], long_t, None),                           # clips at tcap
        (noisy, tl, (40, 30, 250, 240)),                       # li0 > 1
        (np.concatenate([seq(90), noisy[:200]]), tl, (91, 0, 290, 200)),
        (noisy[:200], tl, (5, 100, 200, 20)),                  # falling line
        (noisy, long_t, (60, 180, 300, 437)),                  # floor, i < li0
        (seq(120), seq(130), None),                            # unrelated
        _tie_pair(119, tlen=150),
        _tie_pair(2100),
    ]
    cases = [(q[:qmax], t[:tmax], ln) for q, t, ln in cases]
    qs = np.full((len(cases), qmax), 5, np.uint8)
    ts = np.full((len(cases), tmax), 5, np.uint8)
    for k, (q, t, _) in enumerate(cases):
        qs[k, :len(q)] = q
        ts[k, :len(t)] = t
    qlens = np.array([len(q) for q, _, _ in cases], np.int32)
    tlens = np.array([len(t) for _, t, _ in cases], np.int32)
    lines = np.array([ln if ln is not None else (0, 0, len(q), len(t))
                      for q, t, ln in cases], np.int32)
    return qs, qlens, ts, tlens, lines


def walk_cases(rng, qmax: int = 256, tmax: int = 320, n: int = 24):
    """A batch for the traceback walk whose move bytes no fill produces:
    random bytes (choice 3 and random E/F bits and high bits among them)
    over offsets that are random, non-monotone, or push the walk's lanes
    out of [0, 127] on either side; and lengths at and beyond the edges:
    qlen 0, tlen 0, qlen == qmax, tlen == tmax, negative, and above qmax
    and tmax (the walk clamps them); some rows have every F bit set.  Half the passes have fill-like bytes
    (mostly diagonals, short gap runs, one long insertion run) over a
    drifting band.  Returns
    (moves (n, qmax, 128) uint8, offs (n, qmax) int32, qs (n, qmax) uint8,
    qlens (n,) int32, tlens (n,) int32)."""
    lens = [(0, 50), (40, 0), (0, 0), (qmax, tmax), (qmax, 100), (30, tmax),
            (-5, 60), (70, -3), (qmax + 7, tmax + 9), (1, 1), (qmax, 1),
            (1, tmax)]
    moves = np.zeros((n, qmax, 128), np.uint8)
    offs = np.zeros((n, qmax), np.int32)
    qs = rng.integers(0, 4, (n, qmax)).astype(np.uint8)
    qlens = np.zeros(n, np.int32)
    tlens = np.zeros(n, np.int32)
    rows = np.arange(qmax)
    for k in range(n):
        if k < len(lens):
            ql, tl = lens[k]
        else:
            ql, tl = (int(x) for x in rng.integers(1, (qmax, tmax)))
        qlens[k], tlens[k] = ql, tl
        kind = k % 4
        if kind == 0:       # fill-like bytes over a drifting band
            choice = rng.choice(4, (qmax, 128), p=[0.8, 0.08, 0.08, 0.04])
            ebit = (rng.random((qmax, 128)) < 0.3) * 4
            fbit = (rng.random((qmax, 128)) < 0.3) * 8
            moves[k] = choice + ebit + fbit
            # an insertion run longer than any max_ins: 24 rows of up moves
            # whose E bit holds the walk in the E state
            r0 = int(rng.integers(0, max(qmax - 24, 1)))
            moves[k, r0:r0 + 24] = 1 + 4
            slope = max(tl, 1) / max(ql, 1)
            offs[k] = (rows * slope).astype(np.int64) - 64 \
                + rng.integers(-3, 4, qmax)
        else:               # any byte at all
            moves[k] = rng.integers(0, 256, (qmax, 128))
            # rows whose every F bit is set: a run that reaches lane 0
            moves[k, rng.integers(0, qmax, qmax // 8)] |= 8
            if kind == 1:   # a random, non-monotone walk of offsets
                offs[k] = np.cumsum(rng.integers(-40, 41, qmax)) - 64
            elif kind == 2:  # far right of the lanes, or far left
                offs[k] = rng.choice([-400, 0, 500], qmax)
            else:
                offs[k] = rng.integers(-300, tmax + 300, qmax)
    return moves, offs, qs, qlens, tlens


def rotband_cases(rng, qmax: int = 384, tmax: int = 576):
    """A batch for the rotating-band global fill whose band offsets walk
    through every (offset mod 4, advance d in 0..4) pair and around the
    ring of 128 residues several times: queries that follow their template
    end to end at slopes tlen / qlen from about 0.4 to 4.6 (the band
    advances 0-1, 1-2, 2-3, 3-4 or 4 columns a row, with the odd steps
    moving it across the four residues of a lane), templates up to tmax
    bases; tlen < 128 (the band never moves); qlen 0, 1 and == qmax; bands
    clipped at tcap for about 190 rows, at tcap mod 4 = 0..3; and
    homopolymer and repeat pairs, where ties decide.  Returns (qs, qlens,
    ts, tlens) as numpy arrays: uint8 (n, qmax) and (n, tmax) padded with
    5, int32 (n,)."""
    def seq(n):
        return rng.integers(0, 4, n).astype(np.uint8)

    def along(t, qlen):
        """qlen bases that follow t end to end: t's bases at sorted
        positions (deletions) or t with random bases inserted, then 2%
        substitutions."""
        tl = len(t)
        if qlen <= tl:
            q = t[np.sort(rng.choice(tl, qlen, replace=False))].copy()
        else:
            ins = np.zeros(qlen, bool)
            ins[rng.choice(qlen, qlen - tl, replace=False)] = True
            q = np.empty(qlen, np.uint8)
            q[~ins] = t
            q[ins] = seq(int(ins.sum()))
        sub = rng.random(qlen) < 0.02
        q[sub] = seq(int(sub.sum()))
        return q

    cases = []
    for slope in (0.45, 0.75, 1.3, 1.7, 2.3, 2.7, 3.3, 3.7, 4.6):
        ql = min(qmax, int(tmax / slope))
        t = seq(min(tmax, int(round(slope * ql))))
        cases.append((along(t, ql), t))
    for tl in (129, 130, 131, 132):              # clipped at tcap = tl - 127
        t = seq(tl)
        cases.append((along(t, qmax), t))
    t = seq(300)
    cases += [
        (along(t[:100], 200), t[:100]),                    # tlen < 128
        (along(t[:120], 60), t[:120]),
        (np.zeros(0, np.uint8), t),                        # qlen 0
        (t[:1], t),                                        # qlen 1
        (np.concatenate([along(t, 280), seq(qmax)])[:qmax], t),  # == qmax
        (np.zeros(200, np.uint8), np.zeros(tmax, np.uint8)),     # homopolymer
        (np.tile(np.array([0, 1], np.uint8), 150),
         np.tile(np.array([0, 1], np.uint8), 260)),        # repeats
    ]
    qs = np.full((len(cases), qmax), 5, np.uint8)
    ts = np.full((len(cases), tmax), 5, np.uint8)
    for k, (q, t) in enumerate(cases):
        qs[k, :len(q)] = q[:qmax]
        ts[k, :len(t)] = t[:tmax]
    qlens = np.array([min(len(q), qmax) for q, _ in cases], np.int32)
    tlens = np.array([min(len(t), tmax) for _, t in cases], np.int32)
    return qs, qlens, ts, tlens
