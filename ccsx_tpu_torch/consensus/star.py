"""Shared star-MSA machinery: one alignment+projection+vote round.

A "round" aligns every pass (globally, banded) to the current draft,
projects each alignment onto draft coordinates, and votes per column.  The
round moves its inputs to the device once, launches fill -> walk -> vote
there, and brings the results back in one transfer.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.ops import (banded, banded_cuda, banded_rotband, msa,
                                 traceback)

BANDED_IMPLS = ("", "scan", "pallas", "rotband")


def global_fill(params: AlignParams, impl: str = ""):
    """The global fill with move bytes of one arm (``CcsConfig.banded_impl``,
    CLI --banded-impl), as f(qs, qlens, ts, tlens) -> (score, moves, offs).

    On CUDA tensors '' (the default), 'scan' and 'pallas' launch the
    band-local kernel (ops/banded_cuda.py) and 'rotband' the rotating-band
    kernel (ops/banded_rotband.py); on CPU tensors each arm's wrapper runs
    its plain version.  Every arm gives the same values, so the choice only
    moves time.  The JAX package's names are kept: there 'scan' is the
    lax.scan spec and 'pallas' the band-local TPU kernel."""
    if impl not in BANDED_IMPLS:
        raise ValueError(f"banded_impl {impl!r}: expected one of "
                         f"{BANDED_IMPLS[1:]}")
    mod = banded_rotband if impl == "rotband" else banded_cuda

    def fill(qs, qlens, ts, tlens):
        return mod.batched_align_global_moves(qs, qlens, ts, tlens, params)

    return fill


def pass_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def bucket_len(n: int, q: int) -> int:
    """Geometric length bucket (~1.25x steps, q-aligned): the padded
    widths of a round, shared with the JAX package so both see the same
    shapes."""
    b = q
    while b < n:
        b = max(b + q, (int(b * 1.25) // q) * q)
    return b


def pad_to(x: np.ndarray, n: int) -> np.ndarray:
    out = np.full(n, banded.PAD, np.uint8)
    out[: len(x)] = x
    return out


@dataclasses.dataclass
class RoundRequest:
    """One star-MSA round of device work, requested by a consensus
    generator; the per-hole path satisfies these one at a time."""

    qs: np.ndarray        # (P, qmax) uint8 padded passes
    qlens: np.ndarray     # (P,) int32
    row_mask: np.ndarray  # (P,) bool
    draft: np.ndarray     # (tlen,) uint8 codes — alignment target


@dataclasses.dataclass
class RefineRequest:
    """One window's entire refinement loop (iters speculative rounds + the
    final strict round), requested as a single unit of work."""

    qs: np.ndarray        # (P, qmax) uint8 padded passes
    qlens: np.ndarray     # (P,) int32
    row_mask: np.ndarray  # (P,) bool
    draft: np.ndarray     # (tlen,) uint8 codes — initial alignment target
    iters: int            # speculative refinement rounds before the final


@dataclasses.dataclass
class RefineResult:
    """The final round of a window's refinement, with the strict draft
    materialized lazily (non-final windows never need it)."""

    rr: "RoundResult"
    _draft: "np.ndarray | None" = dataclasses.field(default=None, repr=False)

    @property
    def draft(self) -> np.ndarray:
        if self._draft is None:
            self._draft = self.rr.materialize(speculative=False)
        return self._draft


def run_rounds(gen, sm: "StarMsa"):
    """Drive a consensus generator with immediate per-hole device work."""
    try:
        req = next(gen)
        while True:
            if isinstance(req, RefineRequest):
                res = refine_host(sm.round, req.qs, req.qlens,
                                  req.row_mask, req.draft, req.iters)
                req = gen.send(res)
            else:
                rr = sm.round(req.qs, req.qlens, req.row_mask, req.draft)
                req = gen.send(rr)
    except StopIteration as e:
        return e.value


def refine_host(round_fn, qs, qlens, row_mask, draft, iters: int) -> "RefineResult":
    """The refinement loop: iters speculative rounds + a final one, with a
    fixpoint early exit (a speculative round that leaves the draft
    unchanged makes the remaining rounds no-ops)."""
    rr = None
    it = 0
    while True:
        rr = round_fn(qs, qlens, row_mask, draft)
        if it == iters:
            break
        new_draft = rr.materialize(speculative=True)
        if np.array_equal(new_draft, draft):
            break
        draft = new_draft
        it += 1
    return RefineResult(rr=rr)


def refine_rounds_gen(qs, qlens, row_mask, draft, iters: int):
    """Request one window's refinement from the driving executor."""
    res = yield RefineRequest(qs, qlens, row_mask, draft, iters)
    return res


@dataclasses.dataclass
class RoundResult:
    """Host arrays from one star-MSA round (draft coordinates)."""

    cons: np.ndarray      # (T,) uint8: 0-3 base, 4 gap
    ins_base: np.ndarray  # (T, R) uint8 majority inserted base per slot/rank
    ins_votes: np.ndarray  # (T, R) int32 supporting passes per slot/rank
    ncov: np.ndarray      # (T,) int32 covering passes
    tlen: int
    nwin: np.ndarray | None = None     # (T,) int32 winning-cell votes
    match: np.ndarray | None = None    # (P, T) bool: pass matches consensus
    aligned: np.ndarray | None = None  # (P, T) uint8 projection
    ins_cnt: np.ndarray | None = None  # (P, T) int32 insertion counts
    lead_ins: np.ndarray | None = None  # (P,) int32 bases before column 0
    bp: int | None = None              # device breakpoint (unused here)
    advance: np.ndarray | None = None  # (P,) device cursor advance (unused)

    def ins_out(self, speculative: bool = False) -> np.ndarray:
        return msa.emit_insertions(self.ins_base, self.ins_votes,
                                   self.ncov, speculative)

    def materialize(self, upto: int | None = None,
                    speculative: bool = False) -> np.ndarray:
        n = self.tlen if upto is None else upto
        return msa.materialize(self.cons, self.ins_out(speculative), n)

    def materialize_with_qual(self, upto: int | None = None,
                              speculative: bool = False,
                              qv_coeffs: tuple = (8.0, 3.0, 6.0, 5, 1.0,
                                                  7.0, 4),
                              qmax: int = 60):
        """(codes, quals): the materialized consensus plus a per-base
        Phred-scale confidence from the coverage-conditioned vote margin:

        Q = clip(round(base + per_s*min(s, knee)
                       + per_s_tail*max(s - knee, 0) - per_d*d), 1, qmax)

        with s the supporting passes (nwin for a base column, ins_votes for
        an insertion column) and d = ncov - s.  The homopolymer terms of
        qv_coeffs are applied after assembly (apply_hp_penalty).
        """
        n = self.tlen if upto is None else upto
        ins = self.ins_out(speculative)
        cons = np.asarray(self.cons)[:n]
        m = np.concatenate([cons[:, None], np.asarray(ins)[:n]], axis=1)
        ncov = np.asarray(self.ncov).astype(np.int32)[:n, None]
        support = np.concatenate(
            [np.asarray(self.nwin).astype(np.int32)[:n, None],
             np.asarray(self.ins_votes).astype(np.int32)[:n]], axis=1)
        dissent = ncov - support
        base, per_s, per_d, knee, per_s_tail = qv_coeffs[:5]
        sterm = (per_s * np.minimum(support, knee)
                 + per_s_tail * np.maximum(support - knee, 0))
        q = base + sterm - per_d * dissent
        keep = m.ravel() < 4
        codes = m.ravel()[keep].astype(np.uint8)
        return (codes, np.clip(np.rint(q.ravel()[keep]),
                               1, qmax).astype(np.uint8))


def apply_hp_penalty(codes: np.ndarray, quals: np.ndarray,
                     qv_coeffs: tuple) -> np.ndarray:
    """Homopolymer-run QV penalty on the final assembled consensus:
    Q -= per_hp * min(run - 1, hp_cap), re-clipped to >= 1.  A 5-tuple
    qv_coeffs is a no-op."""
    per_hp, hp_cap = qv_coeffs[5:7] if len(qv_coeffs) > 5 else (0.0, 0)
    if not per_hp or not len(codes):
        return quals
    change = np.flatnonzero(np.diff(codes)) + 1
    bounds = np.concatenate([[0], change, [len(codes)]])
    runs = np.repeat(np.diff(bounds), np.diff(bounds))
    q = quals.astype(np.int32) - np.rint(
        per_hp * np.minimum(runs - 1, hp_cap)).astype(np.int32)
    return np.maximum(q, 1).astype(np.uint8)


class StarMsa:
    def __init__(self, params: AlignParams, max_ins: int = 4,
                 len_quant: int = 512, device="cuda", impl: str = ""):
        self.params = params
        self.max_ins = max_ins
        self.len_quant = len_quant
        self.device = torch.device(device)
        self.fill = global_fill(params, impl)

    def round(self, qs: np.ndarray, qlens: np.ndarray, row_mask: np.ndarray,
              draft: np.ndarray) -> RoundResult:
        """qs: (P, qmax) uint8 padded passes; draft: (tlen,) codes."""
        P, qmax = qs.shape
        tlen = len(draft)
        tmax = bucket_len(tlen, self.len_quant)
        R = self.max_ins
        dev = self.device
        if P and (int(qlens.min()) < 0 or int(qlens.max()) > qmax):
            raise ValueError("a pass length is negative or exceeds qmax")
        q_t = torch.from_numpy(np.ascontiguousarray(qs, np.uint8)).to(dev)
        ql_t = torch.from_numpy(np.asarray(qlens, np.int32)).to(dev)
        # one template row, broadcast over the passes (stride 0)
        t_t = torch.from_numpy(pad_to(draft, tmax)).to(dev)[None].expand(P, tmax)
        tl_t = torch.full((P,), tlen, dtype=torch.int32, device=dev)
        mask_t = torch.from_numpy(np.asarray(row_mask, bool)).to(dev)
        _, moves, offs = self.fill(q_t, ql_t, t_t, tl_t)
        aligned, ins_cnt, ins_b, lead_ins = traceback.project(
            moves, offs, q_t, ql_t, tl_t, tmax, R)
        cons, ins_base, ins_votes, ncov, match, nwin = msa.vote(
            aligned, ins_cnt, ins_b, mask_t, R)
        # one device->host transfer for everything the host reads
        parts = (cons, ins_base, ins_votes, ncov, nwin, match, aligned,
                 ins_cnt, lead_ins)
        flat = torch.cat([x.reshape(-1).to(torch.int32) for x in parts]).cpu()
        out = []
        at = 0
        for x in parts:
            n = x.numel()
            out.append(flat[at:at + n].numpy().reshape(x.shape).astype(
                _NP_DTYPE[x.dtype]))
            at += n
        cons, ins_base, ins_votes, ncov, nwin, match, aligned, ins_cnt, \
            lead_ins = out
        return RoundResult(cons=cons, ins_base=ins_base, ins_votes=ins_votes,
                           ncov=ncov, nwin=nwin, match=match,
                           aligned=aligned, ins_cnt=ins_cnt,
                           lead_ins=lead_ins, tlen=tlen)

    def pack(self, passes: List[np.ndarray], pass_buckets: Sequence[int],
             max_passes: int, qmax: int | None = None):
        """Pad a pass list to (P, qmax) + lens + row mask."""
        if len(passes) > max_passes:
            passes = passes[:max_passes]
        P = pass_bucket(len(passes), pass_buckets)
        if P < len(passes):
            raise ValueError(
                f"pass_buckets {tuple(pass_buckets)} do not cover "
                f"{len(passes)} passes (max_passes={max_passes})")
        if qmax is None:
            qmax = bucket_len(max(len(p) for p in passes), self.len_quant)
        qs = np.stack(
            [pad_to(p, qmax) for p in passes]
            + [np.full(qmax, banded.PAD, np.uint8)] * (P - len(passes)))
        qlens = np.array(
            [len(p) for p in passes] + [0] * (P - len(passes)), np.int32)
        return qs, qlens, qlens > 0

    def consensus_gen(self, passes: List[np.ndarray], iters: int,
                      pass_buckets: Sequence[int], max_passes: int,
                      quality: "tuple | None" = None):
        """Whole-read consensus as a generator: yields one RefineRequest,
        receives a RefineResult, returns the final draft — or
        (draft, phred_quals) when ``quality=(qv_coeffs, qv_cap)``."""
        qs, qlens, row_mask = self.pack(passes, pass_buckets, max_passes)
        res = yield from refine_rounds_gen(
            qs, qlens, row_mask, passes[0], iters)
        if quality is not None:
            codes, quals = res.rr.materialize_with_qual(
                speculative=False, qv_coeffs=quality[0],
                qmax=quality[1])
            return codes, apply_hp_penalty(codes, quals, quality[0])
        return res.draft

    def consensus(self, passes: List[np.ndarray], iters: int,
                  pass_buckets: Sequence[int], max_passes: int,
                  quality: "tuple | None" = None):
        """iters+1 rounds; intermediate rounds insert speculatively, the
        final round applies strict majority."""
        return run_rounds(
            self.consensus_gen(passes, iters, pass_buckets, max_passes,
                               quality), self)


_NP_DTYPE = {torch.uint8: np.uint8, torch.int32: np.int32, torch.bool: bool}
