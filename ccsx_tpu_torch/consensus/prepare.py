"""Pass orientation and template selection (host side).

Re-implements the semantics of the reference's prepare stage
(main.c:116-453): length clustering at 10% tolerance, template-group
selection with the palindrome/adapter border check, and the outward
orientation walk that alternates expected strand, verifies/clips doubtful
passes by alignment against the template, and keeps only passes whose
clipped length stays in the template length group.

This is control-flow-heavy scalar work (SURVEY.md §7.3) — it stays on the
host; only the pairwise alignments inside it run on the device (via
HostAligner / the batched runner).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.ops import encode as enc
from ccsx_tpu_torch.ops.sketch import SPECULATE_MIN_QT


@dataclasses.dataclass
class LenGroup:
    ids: List[int]
    sum_len: int

    @property
    def size(self) -> int:
        return len(self.ids)


def len_in_group(g: LenGroup, length: int, tolerance_pct: int) -> bool:
    """|len - mean| < tol% of mean, in integer arithmetic (main.c:124-129)."""
    tmp = length * g.size
    diff = abs(tmp - g.sum_len)
    return diff * 100 < tolerance_pct * g.sum_len


def group_in_group(a: LenGroup, b: LenGroup, tolerance_pct: int) -> bool:
    """Means within tolerance (main.c:131-137)."""
    ma = a.sum_len * b.size
    mb = b.sum_len * a.size
    return abs(ma - mb) * 100 < ma * tolerance_pct


def group_lens(lens: Sequence[int], tolerance_pct: int) -> List[LenGroup]:
    """Greedy length clustering + transitive merge + sort by size
    (init_group_lens, main.c:139-212).  Member ids keep insertion order —
    the "median member" picks ids[size//2] of that order, as the reference
    does (main.c:317,364)."""
    n = len(lens)
    groups: List[LenGroup] = [LenGroup([], 0) for _ in range(n)]
    for i in range(n):
        placed = False
        create_at = None
        for j in range(n):
            if groups[j].size == 0:
                # first truly empty slot: create a new group here (the
                # reference scans j<i then creates at the first free j)
                create_at = j
                break
            if groups[j].sum_len == 0:
                # zero-length-members group: unjoinable, skip — matches the
                # reference's `if (!sum_len) continue` (main.c:150)
                continue
            if len_in_group(groups[j], int(lens[i]), tolerance_pct):
                groups[j].ids.append(i)
                groups[j].sum_len += int(lens[i])
                placed = True
                break
        if not placed:
            groups[create_at].ids.append(i)
            groups[create_at].sum_len = int(lens[i])

    # transitive merge (main.c:169-195)
    changed = True
    while changed:
        changed = False
        for j in range(n):
            if groups[j].size == 0:
                continue
            for k in range(j):
                if groups[k].size and group_in_group(groups[k], groups[j],
                                                     tolerance_pct):
                    groups[k].ids.extend(groups[j].ids)
                    groups[k].sum_len += groups[j].sum_len
                    groups[j] = LenGroup([], 0)
                    changed = True
                    break

    out = [g for g in groups if g.size > 0]
    out.sort(key=lambda g: -g.size)  # stable, like the bubble sort (main.c:208)
    return out


@dataclasses.dataclass
class Segment:
    """Oriented, clipped view into a ZMW's concatenated buffer
    (segment_t, main.c:292-297)."""

    offs: int
    length: int
    reverse: bool
    pos: int = 0


@dataclasses.dataclass
class PairRequest:
    """One strand_match pair alignment (main.c:255-290), requested by a
    prep generator.  The per-hole path satisfies these immediately via
    HostAligner.strand_match; the batched pipeline stacks pairs from many
    holes into padded-bucket device dispatches (pipeline/batch.py
    PairExecutor) — prep measured ~95% of wall time at device-round speed
    when dispatched one pair at a time (benchmarks/prep_share.py)."""

    q: np.ndarray
    t: np.ndarray
    pct: int
    # Optional identity token for ``t``: requests carrying the same token
    # share one template array, so the executor's seeding can sort its
    # k-mers once and reuse the index across the walk's many pairings
    # (ops/seed.sorted_kmer_index).  None = no sharing (one-shot pairs,
    # e.g. the border checks).  Purely a performance hint — never
    # affects results.
    t_token: object = None


@dataclasses.dataclass
class PairBatch:
    """A FIRST-ACCEPT group of PairRequests yielded as one step of the
    walk (the fwd+RC strand speculation the prefilter enables,
    cfg.prefilter).

    Contract: the driver answers with a list aligned to ``requests``;
    every entry up to and including the first accepted one is a real
    (ok, MatchResult), later entries MAY be None (unevaluated).  The
    walk reads results in order and stops at the first ok=True, so the
    two legal evaluation strategies cannot diverge:

    * lazily (drive_pairs / the per-hole spec path): evaluate in order,
      stop at the first accept — exactly the sequential walk's cost;
    * speculatively (PairExecutor): evaluate every arm in ONE batched
      wave — the wrong-strand arm is hopeless at speculation lengths
      and dies in the pre-alignment screen (ops/sketch.py) for the
      cost of a screen row, while the walk saves a sequential
      pair-wave round trip per doubtful pass.
    """

    requests: List[PairRequest]


def _template_grp_gen(codes: np.ndarray, lens, offs, groups: List[LenGroup],
                      cfg: CcsConfig):
    """Template-group adjustment rejecting palindrome/adapter artifacts
    (main.c:300-342): a larger-length candidate group is adopted unless the
    reverse-complement of either 1000bp border matches the rest of the read
    at 70% identity.  Yields PairRequests; receives (ok, MatchResult)."""
    template_grp = 0
    if groups[0].size < 2:
        return 0
    bl = cfg.border_len
    for cg in range(1, len(groups)):
        g = groups[cg]
        if g.size < 2 or g.size * 5 < 4 * groups[0].size:
            continue
        ci = g.ids[g.size // 2]
        clen = int(lens[ci])
        cur = groups[template_grp]
        cur_med = int(lens[cur.ids[cur.size // 2]])
        if clen <= cur_med or clen <= cfg.border_min_template:
            continue
        start = int(offs[ci])
        read = codes[start:start + clen]
        head_rc = enc.revcomp_codes(read[:bl])
        ok, _ = yield PairRequest(head_rc, read[bl:],
                                  cfg.border_identity_pct)
        if ok:
            continue  # palindromic head: artifact, keep current template
        tail_rc = enc.revcomp_codes(read[clen - bl:])
        ok, _ = yield PairRequest(tail_rc, read[:clen - bl],
                                  cfg.border_identity_pct)
        if ok:
            continue
        template_grp = cg
    return template_grp


def ccs_prepare_gen(codes: np.ndarray, lens, offs, cfg: CcsConfig):
    """The outward orientation walk (ccs_prepare, main.c:344-453), in
    generator form: yields PairRequests, receives (ok, MatchResult),
    returns the segment list via StopIteration.value.

    Starting from the template pass, walk outward in both directions,
    alternating the expected strand each step.  In-group passes are trusted
    by parity until a mismatch event; out-of-group or doubtful passes are
    aligned against the template (fwd then RC) at 75% identity, clipped to
    the aligned query span, and kept only if the clipped length is still in
    the template group.  Returns segments with the template first.
    """
    tol = cfg.group_tolerance_pct
    groups = group_lens(lens, tol)
    map_group = {}
    for gi, g in enumerate(groups):
        for i in g.ids:
            map_group[i] = gi

    template_grp = yield from _template_grp_gen(codes, lens, offs, groups,
                                                cfg)
    tg = groups[template_grp]
    template_i = tg.ids[tg.size // 2]
    template_offs = int(offs[template_i])
    template_len = int(lens[template_i])
    tseq = codes[template_offs:template_offs + template_len]
    t2seq = enc.revcomp_codes(tseq)
    # per-template seeding tokens: every doubtful pass in the walk below
    # aligns against tseq (then t2seq), so the executor can k-mer-sort
    # each template once for the whole hole (ops/seed.py cache)
    tok_f, tok_r = object(), object()
    # fwd+RC speculation floor: only where the pre-alignment screen's
    # noise gate has decisive margin over wrong-strand noise
    # (SPECULATE_MIN_QT) is a speculated wrong arm guaranteed-cheap;
    # below it, speculation trades a sequential wave for a possible full
    # extra DP.  The per-hole driver evaluates a PairBatch lazily
    # (drive_pairs), so the floor only shapes the requests, never results
    spec_min = (SPECULATE_MIN_QT
                if getattr(cfg, "prefilter", True) else None)

    segments = [Segment(template_offs, template_len, False)]

    def walk(indices):
        reverse = False
        strand_adjust = False
        for k in indices:
            reverse = not reverse
            seg = Segment(int(offs[k]), int(lens[k]), reverse)
            if map_group[k] != template_grp:
                strand_adjust = True
                if seg.length < template_len:
                    continue
            elif not strand_adjust:
                segments.append(seg)
                continue
            qseq = codes[seg.offs:seg.offs + seg.length]
            fwd = PairRequest(qseq, tseq, cfg.strand_identity_pct,
                              t_token=tok_f)
            rcq = PairRequest(qseq, t2seq, cfg.strand_identity_pct,
                              t_token=tok_r)
            ok_r, rs_r = False, None
            if (spec_min is not None
                    and map_group[k] == template_grp
                    and min(seg.length, template_len) >= spec_min):
                # IN-GROUP passes only: a single-strand pass can accept
                # on exactly one arm, so the loser is hopeless and the
                # screen eats it; an out-of-group read-through carries
                # both strands and would accept BOTH arms — speculation
                # there burns a full extra DP the lazy order never pays.
                # One first-accept batch instead of two sequential waves
                res = yield PairBatch([fwd, rcq])
                ok_f, rs = res[0]
                if not ok_f:
                    ok_r, rs_r = res[1]
            else:
                ok_f, rs = yield fwd
                if not ok_f:
                    ok_r, rs_r = yield rcq
            # ONE epilogue for both evaluation paths (result precedence
            # fwd-then-RC is fixed by the PairBatch contract, and the
            # accept/clip/strand_adjust logic exists exactly once — so
            # output bytes cannot depend on which branch ran; pinned by
            # tests/test_sketch.py)
            if ok_f:
                reverse = False
            elif ok_r:
                reverse, rs = True, rs_r
            else:
                strand_adjust = True
                continue
            clipped = Segment(seg.offs + rs.qb, rs.qe - rs.qb, reverse)
            if len_in_group(groups[template_grp], clipped.length, tol):
                segments.append(clipped)
            strand_adjust = map_group[k] != template_grp

    yield from walk(range(template_i - 1, -1, -1))
    yield from walk(range(template_i + 1, len(lens)))
    return segments


def drive_pairs(gen, aligner):
    """Run a PairRequest generator to completion with immediate
    (per-pair) strand_match dispatches; returns its result.

    PairBatches are evaluated LAZILY (in order, stopping at the first
    accept) — the sequential walk's exact cost, so the per-hole spec
    path never pays for speculation it cannot amortize."""
    from ccsx_tpu_torch.utils import trace

    def one(req):
        with trace.span("pair_host", cat="prep",
                        q=len(req.q), t=len(req.t)):
            return aligner.strand_match(req.q, req.t, req.pct)

    try:
        req = next(gen)
        while True:
            if isinstance(req, PairBatch):
                res: List = []
                accepted = False
                for sub in req.requests:
                    if accepted:
                        res.append(None)   # first-accept: skip the rest
                    else:
                        r = one(sub)
                        res.append(r)
                        accepted = bool(r[0])
                req = gen.send(res)
            else:
                req = gen.send(one(req))
    except StopIteration as e:
        return e.value


def get_template_grp(codes: np.ndarray, lens, offs, groups: List[LenGroup],
                     aligner, cfg: CcsConfig) -> int:
    """Synchronous wrapper of _template_grp_gen (kept for tests/tools)."""
    return drive_pairs(
        _template_grp_gen(codes, lens, offs, groups, cfg), aligner)


def ccs_prepare(codes: np.ndarray, lens, offs, aligner,
                cfg: CcsConfig) -> List[Segment]:
    """Synchronous ccs_prepare: drives ccs_prepare_gen with immediate
    per-pair dispatches (the per-hole path; batched path uses the
    generator directly)."""
    return drive_pairs(ccs_prepare_gen(codes, lens, offs, cfg), aligner)


def passes_from_segments(codes: np.ndarray, segments: List[Segment],
                         zmw, cfg) -> List[np.ndarray]:
    """Segment dump (-v level 1, main.c:477-479,533-535) + oriented pass
    slicing — the tail of prep shared by the sync (oriented_passes) and
    batched (hole.full_gen_for_zmw) paths, factored so they can't drift."""
    if cfg.verbose >= 1:
        import sys

        for s in segments:
            print(f"[ccsx-tpu] {zmw.movie}/{zmw.hole} segment "
                  f"offs={s.offs} len={s.length} reverse={int(s.reverse)}",
                  file=sys.stderr)
    return [oriented_pass(codes, s) for s in segments]


def oriented_passes(zmw, aligner, cfg):
    """Prep shared by every consensus path: encode, orient/clip, slice.

    Returns the oriented pass code arrays (template pass first), or None
    when the hole has <3 passes (main.c:460,515).
    """
    if zmw.n_passes < 3:
        return None
    codes = enc.encode(zmw.seqs)
    segments = ccs_prepare(codes, zmw.lens, zmw.offs, aligner, cfg)
    return passes_from_segments(codes, segments, zmw, cfg)


def oriented_pass(codes: np.ndarray, seg: Segment) -> np.ndarray:
    """Extract a segment's bases, reverse-complemented when needed
    (the in-place RC at main.c:471-480, done functionally here)."""
    s = codes[seg.offs:seg.offs + seg.length]
    return enc.revcomp_codes(s) if seg.reverse else s
