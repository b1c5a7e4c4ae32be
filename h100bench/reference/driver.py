"""Many holes' consensus in lock step: every step answers each hole's next
request, with one local fill for all the pair checks asked for and one
global fill a refine round for all the windows being refined.

``consensus(holes, params)`` maps each hole's subreads (a list of uint8
code arrays, as sequenced) to its consensus codes, or None for a hole the
filters drop or with fewer than 3 subreads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from h100bench.reference import fill, prepare, vote, walk, windowed
from h100bench.reference.seed import seed_diagonal

MAX_INS = 4   # inserted bases kept a (pass, column)


@dataclasses.dataclass(frozen=True)
class Params:
    """The algorithm's settings that a configuration states (the CLI's
    defaults unless its flags say otherwise)."""

    min_len: int = 5000          # -m: a hole's subread bases at least
    max_len: int = 500000        # -M: and at most
    min_count: int = 3           # -c: subreads at least this + 2
    refine_iters: int = 2
    max_passes: int = 32
    device: str = "cuda"


@dataclasses.dataclass
class Match:
    ok: bool
    qb: int = 0
    qe: int = 0


def keep(passes: List[np.ndarray], p: Params) -> bool:
    """The read filters: enough subreads, and a total length in range."""
    total = sum(len(s) for s in passes)
    return (len(passes) >= p.min_count + 2 and total <= p.max_len
            and total >= p.min_len)


def _hole(passes: List[np.ndarray], p: Params):
    if len(passes) < 3:
        return None
    codes = np.concatenate(passes).astype(np.uint8)
    lens = np.array([len(s) for s in passes], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    segments = yield from prepare.walk(codes, lens, offs)
    oriented = [prepare.oriented(codes, s) for s in segments]
    return (yield from windowed.consensus(oriented, p.refine_iters,
                                          p.max_passes))


def _pad(rows: List[np.ndarray]) -> np.ndarray:
    width = max(1, max(len(r) for r in rows))
    out = np.full((len(rows), width), fill.PAD, np.uint8)
    for k, r in enumerate(rows):
        out[k, :len(r)] = r
    return out


def match_pairs(reqs: List[prepare.PairRequest], p: Params,
                fills: fill.Fills) -> List[tuple]:
    """(ok, Match) of each pair check: no seed, no alignment; else a local
    fill along the seed's line (or the corners, for a seed diagonal within
    a quarter band of 0), accepted when the path spans more than half the
    shorter sequence at the request's identity."""
    out: List[Optional[tuple]] = [None] * len(reqs)
    run, lines = [], []
    for k, r in enumerate(reqs):
        hit = seed_diagonal(r.q, r.t)
        if hit is None:
            out[k] = (False, Match(False))
            continue
        line = hit.line if abs(hit.diag) > fill.BAND // 4 else np.array(
            [0, 0, len(r.q), len(r.t)], np.int32)
        run.append(k)
        lines.append(line)
    if run:
        qs = torch.from_numpy(_pad([reqs[k].q for k in run]))
        ts = torch.from_numpy(_pad([reqs[k].t for k in run]))
        ql = torch.tensor([len(reqs[k].q) for k in run], dtype=torch.int32)
        tl = torch.tensor([len(reqs[k].t) for k in run], dtype=torch.int32)
        res = fills.local(qs, ql, ts, tl, torch.from_numpy(np.stack(lines)))
        cols = torch.stack([res.qb, res.qe, res.aln, res.mat]).numpy()
        for n, k in enumerate(run):
            qb, qe, aln, mat = (int(x) for x in cols[:, n])
            r = reqs[k]
            ok = (aln * 2 > min(len(r.q), len(r.t))
                  and mat * 100 >= aln * r.pct)
            out[k] = (ok, Match(ok, qb, qe))
    return out


def round_many(windows: List[List[np.ndarray]], drafts: List[np.ndarray],
               p: Params, fills: fill.Fills) -> List[vote.Round]:
    """One round for each (windows, draft): every pass window's global fill
    to its draft, its walk, and the vote."""
    rows = [w for ws in windows for w in ws]
    tmpl = [d for ws, d in zip(windows, drafts) for _ in ws]
    qs = _pad(rows)
    ts = _pad(tmpl)
    ql = np.array([len(r) for r in rows], np.int32)
    tl = np.array([len(t) for t in tmpl], np.int32)
    _, moves, offs = fills.global_moves(
        torch.from_numpy(qs), torch.from_numpy(ql), torch.from_numpy(ts),
        torch.from_numpy(tl))
    aligned, ins_cnt, ins_b, lead = walk.project(
        moves.numpy(), offs.numpy(), qs, ql, tl, ts.shape[1], MAX_INS)
    out = []
    r0 = 0
    for ws, d in zip(windows, drafts):
        s = slice(r0, r0 + len(ws))
        r0 += len(ws)
        rr = vote.vote(aligned[s], ins_cnt[s], ins_b[s], ql[s] > 0,
                       MAX_INS, len(d))
        rr.lead_ins = lead[s]
        out.append(rr)
    return out


def refine_many(reqs: List[windowed.RefineRequest], p: Params,
                fills: fill.Fills) -> List[vote.Round]:
    """Each request's refinement: ``iters`` speculative rounds and the
    strict one, a request leaving the lock step when a speculative round
    gives back its draft."""
    drafts = [r.draft for r in reqs]
    its = [0] * len(reqs)
    final: List[Optional[vote.Round]] = [None] * len(reqs)
    active = list(range(len(reqs)))
    while active:
        rounds = round_many([reqs[k].passes for k in active],
                            [drafts[k] for k in active], p, fills)
        still = []
        for k, rr in zip(active, rounds):
            if its[k] == reqs[k].iters:
                final[k] = rr
                continue
            new = rr.materialize(speculative=True)
            if np.array_equal(new, drafts[k]):
                final[k] = rr
                continue
            drafts[k] = new
            its[k] += 1
            still.append(k)
        active = still
    return final


def consensus(holes: Dict[object, List[np.ndarray]],
              p: Params) -> Dict[object, Optional[np.ndarray]]:
    result: Dict[object, Optional[np.ndarray]] = {}
    fills = fill.Fills(p.device)
    pending: Dict[object, tuple] = {}
    for key, passes in holes.items():
        if not keep(passes, p):
            result[key] = None
            continue
        gen = _hole(passes, p)
        try:
            pending[key] = (gen, next(gen))
        except StopIteration as e:
            result[key] = e.value
    while pending:
        keys = list(pending)
        pairs = [k for k in keys
                 if isinstance(pending[k][1], prepare.PairRequest)]
        refines = [k for k in keys if k not in set(pairs)]
        answers = {}
        if pairs:
            for k, a in zip(pairs, match_pairs(
                    [pending[k][1] for k in pairs], p, fills)):
                answers[k] = a
        if refines:
            for k, a in zip(refines, refine_many(
                    [pending[k][1] for k in refines], p, fills)):
                answers[k] = a
        for k in keys:
            gen = pending[k][0]
            try:
                pending[k] = (gen, gen.send(answers[k]))
            except StopIteration as e:
                result[k] = e.value
                del pending[k]
    return result
