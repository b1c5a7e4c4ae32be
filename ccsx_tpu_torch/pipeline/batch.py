"""The batched driver: many holes per device step.

The per-hole driver (pipeline/run.py) runs one star-MSA round of one hole
at a time, so a round of at most 32 passes fills at most 32 of the card's
SMs.  This driver multiplexes the consensus generators of many in-flight
holes and serves their pending requests together:

  admit holes ──> per-hole generator (host state machine)
                    │ yields PairRequest / PairBatch (the strand walk)
                    │ or RefineRequest (one window's refinement)
                    ▼
  pair sweep (PairExecutor): screen long pairs on the device, seed long
  templates on the device and the rest on the host, filter on the seed
  statistics, then ONE batched local fill per padded (qmax, tmax) group
  refine sweep (BatchExecutor), packed (the default): group by (qmax,
  tmax, iters), flatten each hole's passes into (hole, pass) ROWS and pack
  rows of many holes into (R, qmax) slabs first-fit-decreasing by hole
  (pipeline/pack.py), a row->hole segment vector riding along; or bucketed
  (--pass-buckets): group by (P, qmax, tmax, iters) and stack the holes
  as (Z, P) with their pad passes
                    ▼
  ONE device step per slab or group (_refine_core_packed / _refine_core):
  the speculative rounds and the final round (global fill -> walk -> vote
  -> draft re-materialization) loop with the drafts on the device, then
  the breakpoint scan; one transfer in and one out per step
                    ▼
  results routed back into each generator; finished holes go to the
  ordered writer in input order.

This is the JAX package's pipeline/batch.py, single-device path (its
``pool is None`` inline-prep branch), with the same slab plan and groups,
the same per-hole freeze/fixpoint/overflow rules and so the same output
bytes.  JAX runs the refine loop as a device ``while_loop``; here it is a
host loop of at most iters + 1 rounds that reads one bool per round.  The
JAX package pads a bucketed group's Z to a power of two (_z_bucket) to
bound its compiles; the port compiles nothing per shape and does not.

Failures (classify_failure): a CUDA out-of-memory error bisects the slab by
hole and retries the halves (capped depth, backoff); a kernel or card fault,
or a kernel wrapper refusing its tensors, ends the run
(``cuda_ext.KernelError``, rc 1 from the caller), never replayed or
quarantined; any other error replays each request of the group through the
per-hole round on the same device (counted as ``failed_steps`` and
``host_replays``, which the run reports even without -v), and a failure
there quarantines that one hole.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ccsx_tpu_torch.config import AlignParams, CcsConfig
from ccsx_tpu_torch.consensus import prepare as prep_mod
from ccsx_tpu_torch.consensus.align_host import HostAligner, MatchResult
from ccsx_tpu_torch.consensus.hole import full_gen_for_zmw
from ccsx_tpu_torch.consensus.star import (
    RefineRequest, RefineResult, RoundRequest, RoundResult, StarMsa,
    bucket_len, global_fill, pad_to, refine_host)
from ccsx_tpu_torch.ops import banded, banded_cuda
from ccsx_tpu_torch.ops import breakpoint as bp_mod
from ccsx_tpu_torch.ops import cuda_ext
from ccsx_tpu_torch.ops import encode as enc
from ccsx_tpu_torch.ops import msa, seed, seed_device, sketch, traceback
from ccsx_tpu_torch.pipeline import pack as pack_mod


def _bump(counts: dict, **kw) -> None:
    for k, v in kw.items():
        counts[k] = counts.get(k, 0) + v


# ---- failure taxonomy and recovery (shared by both executors) ------------

def classify_failure(exc: BaseException) -> str:
    """'oom' | 'fatal' | 'data' for an exception from a device step.

    'oom' (torch.cuda.OutOfMemoryError) is transient: the group is bisected
    and retried.  'fatal' is a kernel that did not build or launch, a
    wrapper that refused its tensors (cuda_ext.RefusedInputs), or a CUDA
    runtime error (cuda_ext.is_device_fault): every later step would hit it
    too, so the run ends.  'data' is a fault in the requests' own data:
    each request is replayed on the per-hole path, so the blast radius is
    one quarantined hole."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "oom"
    if cuda_ext.is_device_fault(exc):
        return "fatal"
    return "data"


def _fatal(exc: BaseException) -> cuda_ext.KernelError:
    if isinstance(exc, cuda_ext.KernelError):
        return exc
    err = cuda_ext.KernelError(str(exc))
    err.__cause__ = exc
    return err


def _host_replay_all(idxs, host_one, results, counts) -> None:
    """Replay each request on the per-hole path; a failure there becomes
    that request's result (an Exception the driver quarantines per hole).
    A device fault during the replay still ends the run."""
    for i in idxs:
        _bump(counts, host_replays=1)
        try:
            results[i] = host_one(i)
        except Exception as e:
            if classify_failure(e) == "fatal":
                raise _fatal(e) from e
            results[i] = e


def _run_group_sync(idxs, key, dispatch, finish, host_one, results, counts,
                    depth, max_resplits, backoff_s) -> None:
    """Dispatch and finish one (sub)group, recovering from failures."""
    try:
        finish(idxs, key, dispatch(idxs, key))
    except Exception as e:
        _recover_group(e, idxs, key, dispatch, finish, host_one, results,
                       counts, depth, max_resplits, backoff_s)


def _recover_group(exc, idxs, key, dispatch, finish, host_one, results,
                   counts, depth, max_resplits, backoff_s) -> None:
    """The recovery ladder for one failed group.

    fatal -> re-raised as cuda_ext.KernelError: the run ends
    oom   -> bisect idxs (each half re-packs into a smaller covering slab)
             with exponential backoff, at most max_resplits deep; the
             bottom replays per request like 'data'
    data  -> replay each request on the per-hole path
    """
    kind = classify_failure(exc)
    if kind == "fatal":
        raise _fatal(exc) from exc
    if kind == "oom" and depth < max_resplits and len(idxs) > 1:
        _bump(counts, oom_resplits=1)
        print(f"[ccsx-tpu-torch] device OOM on a {len(idxs)}-request group "
              f"{key}: resplitting (depth {depth + 1}): {exc}",
              file=sys.stderr)
        time.sleep(backoff_s * (2 ** depth))
        mid = (len(idxs) + 1) // 2
        for part in (idxs[:mid], idxs[mid:]):
            _run_group_sync(part, key, dispatch, finish, host_one, results,
                            counts, depth + 1, max_resplits, backoff_s)
        return
    _bump(counts, failed_steps=1)
    print(f"[ccsx-tpu-torch] device step failed ({kind}) for a "
          f"{len(idxs)}-request group {key}; replaying per request: {exc}",
          file=sys.stderr)
    _host_replay_all(idxs, host_one, results, counts)


def _run_groups_recovering(groups, dispatch, finish, host_one, results,
                           counts, max_resplits=3, backoff_s=0.05) -> None:
    """Dispatch every group's device work before finishing any (launches
    are asynchronous, so one group's device work overlaps the previous
    group's host side); a failure at either phase drops that one group
    into the recovery ladder."""
    pending = []
    for key, idxs in groups.items():
        try:
            pending.append((idxs, key, None, dispatch(idxs, key)))
        except Exception as e:
            pending.append((idxs, key, e, None))
    for idxs, key, exc, out in pending:
        try:
            if exc is not None:
                raise exc
            finish(idxs, key, out)
        except Exception as e:
            _recover_group(e, idxs, key, dispatch, finish, host_one,
                           results, counts, 0, max_resplits, backoff_s)


def _fused_tmax(tlen: int, quant: int) -> int:
    """Draft capacity for the packed refine step: one geometric bucket above
    the request's own, so the speculative rounds' liberal inserts stay on
    the device in the common case.  A draft outgrowing even that is flagged
    by the step and replayed exactly on the per-hole path (refine_host)."""
    b = bucket_len(tlen, quant)
    return bucket_len(b + 1, quant)


# ---- the packed refine step -----------------------------------------------

def _refine_loop(one_round, mat, iters: int, draft, dlen, fixed, row_fixed,
                 rows: tuple, max_ins: int):
    """The refinement loop both refine cores run, over H holes (slots).

    ``one_round(draft, dlen)`` gives the 9 round outputs: five hole-shaped
    (H, ...) and four row-shaped (``rows`` + ...: (R,) rows of a packed
    slab, or (Z, P) of a bucketed group); ``row_fixed(fixed)`` maps the
    holes' frozen flags onto those rows' leading axes.  A hole whose
    speculative draft stops changing is frozen (re-rounds on a fixed draft
    are no-ops) and keeps its LAST live round's outputs; a hole whose draft
    would outgrow tmax is frozen and flagged (``ovf``) for an exact host
    replay; the round at it == iters is the mandatory final round; holes
    ``fixed`` at the start (no real rows) never change.  At most iters + 1
    rounds, one bool read per round (whether every hole is frozen).
    Returns (outs, dlen, ovf)."""
    dev = draft.device
    H, tmax = draft.shape

    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    outs = (z(H, tmax, dtype=torch.uint8),              # cons
            z(H, tmax, max_ins, dtype=torch.uint8),     # ins_base
            z(H, tmax, max_ins, dtype=torch.int32),     # ins_votes
            z(H, tmax, dtype=torch.int32),              # ncov
            z(H, tmax, dtype=torch.int32),              # nwin
            z(*rows, tmax, dtype=torch.bool),           # match
            z(*rows, tmax, dtype=torch.uint8),          # aligned
            z(*rows, tmax, dtype=torch.int32),          # ins_cnt
            z(*rows, dtype=torch.int32))                # lead_ins
    ovf = torch.zeros(H, dtype=torch.bool, device=dev)
    dlen = dlen.to(torch.int32)
    it = 0
    while True:
        new = one_round(draft, dlen)
        fr = row_fixed(fixed)
        outs = tuple(
            torch.where(f.view(f.shape + (1,) * (n.dim() - f.dim())), o, n)
            for f, o, n in zip((fixed,) * 5 + (fr,) * 4, outs, new))
        if it >= iters:
            break          # the final round: no draft is consumed past it
        cons, ins_base, ins_votes, ncov = outs[:4]
        ins_out = msa.emit_insertions_t(ins_base, ins_votes, ncov, True)
        nd, nl, o = mat(cons, ins_out, dlen)
        # fixpoint: same length AND same padded cells == the host's
        # np.array_equal on the exact-length drafts
        now_fixed = (nl == dlen) & (nd == draft).all(dim=1)
        o = ~fixed & o
        grow = ~fixed & ~o & ~now_fixed
        draft = torch.where(grow[:, None], nd, draft)
        dlen = torch.where(grow, nl, dlen)
        fixed = fixed | now_fixed | o
        ovf = ovf | o
        it += 1
        if bool(fixed.all()):
            break
    return outs, dlen, ovf



def _round_body_packed(params: AlignParams, max_ins: int, tmax: int,
                       nseg: int, impl: str = ""):
    """One star round over a packed slab: (R, qmax) rows of up to ``nseg``
    holes, each row aligned to ITS hole's draft (a per-row gather into a
    contiguous (R, tmax) tensor), walked, and voted by segment id.  A
    row's tensors do not depend on which slab it rides in."""
    fill = global_fill(params, impl)
    voter = msa.make_segment_voter(max_ins, nseg)

    def body(qs, qlens, row_mask, seg, draft, dlen):
        ts_r = draft.index_select(0, seg)          # (R, tmax) per-row targets
        tl_r = dlen.index_select(0, seg)           # (R,)
        _, moves, offs = fill(qs, qlens, ts_r, tl_r)
        aligned, ins_cnt, ins_b, lead_ins = traceback.project(
            moves, offs, qs, qlens, tl_r, tmax, max_ins)
        cons, ins_base, ins_votes, ncov, match, nwin = voter(
            aligned, ins_cnt, ins_b, row_mask, seg)
        return (cons, ins_base, ins_votes, ncov, nwin, match, aligned,
                ins_cnt, lead_ins)

    return body


def _refine_core_packed(params: AlignParams, max_ins: int, tmax: int,
                        iters: int, nseg: int, bp_consts: tuple,
                        impl: str = ""):
    """The whole-window refinement loop (_refine_loop) over ONE packed slab.

    core(qs (R, qmax) uint8, qlens (R,) int32, row_mask (R,) bool, seg (R,)
    int, ts (H, tmax) uint8, tlens (H,) int32) -> (cons, ins_base,
    ins_votes, ncov, nwin, bp, advance, dlen, ovf), H = nseg, as the JAX
    package's ``_refine_core_packed`` returns them.  A frozen hole keeps
    its row-shaped outputs through the segment vector; empty hole slots
    (no real rows) start frozen."""
    one_round = _round_body_packed(params, max_ins, tmax, nseg, impl)
    bp_advance = bp_mod.make_bp_advance_packed(tmax, nseg, *bp_consts)
    mat = msa.make_materializer(tmax, tmax, max_ins)
    H = nseg

    def core(qs, qlens, row_mask, seg, ts, tlens):
        seg = seg.long()
        nrows = torch.zeros(H, dtype=torch.int32, device=qs.device
                            ).index_add_(0, seg, row_mask.to(torch.int32))
        outs, dlen, ovf = _refine_loop(
            lambda d, dl: one_round(qs, qlens, row_mask, seg, d, dl), mat,
            iters, ts, tlens, nrows == 0, lambda f: f.index_select(0, seg),
            (qs.shape[0],), max_ins)
        (cons, ins_base, ins_votes, ncov, nwin, match, aligned, ins_cnt,
         lead_ins) = outs
        bp, advance = bp_advance(match, cons, aligned, ins_cnt, lead_ins,
                                 row_mask, seg, dlen)
        # votes and coverage are bounded by the hole's rows (<= max_passes)
        return (cons, ins_base, ins_votes.to(torch.uint8),
                ncov.to(torch.uint8), nwin.to(torch.uint8), bp, advance,
                dlen, ovf)

    return core


def _pack_slab_args(args, pin: bool = False):
    """Host side of the slab protocol: the 6 packed-refine inputs become one
    uint8 and one int32 buffer (pinned when ``pin``, so each goes to the
    card in ONE non-blocking copy)."""
    qs, qlens, row_mask, seg, ts, tlens = args
    R, qmax = qs.shape
    H, tmax = ts.shape
    big_t = torch.empty(R * qmax + H * tmax, dtype=torch.uint8,
                        pin_memory=pin)
    small_t = torch.empty(3 * R + H, dtype=torch.int32, pin_memory=pin)
    big, small = big_t.numpy(), small_t.numpy()
    big[:R * qmax] = qs.reshape(-1)
    big[R * qmax:R * qmax + H * tmax] = ts.reshape(-1)
    small[:R] = qlens
    small[R:2 * R] = row_mask
    small[2 * R:3 * R] = seg
    small[3 * R:3 * R + H] = tlens
    return big_t, small_t


def _unpack_slab_args(big, small, R: int, qmax: int, H: int, tmax: int):
    """Device side of _pack_slab_args: views into the two buffers."""
    qs = big[:R * qmax].view(R, qmax)
    ts = big[R * qmax:R * qmax + H * tmax].view(H, tmax)
    qlens = small[:R]
    row_mask = small[R:2 * R] != 0
    seg = small[2 * R:3 * R].long()
    tlens = small[3 * R:3 * R + H]
    return qs, qlens, row_mask, seg, ts, tlens


def _refine_step_packed(params: AlignParams, max_ins: int, tmax: int,
                        iters: int, nseg: int, bp_consts: tuple,
                        pack: tuple, impl: str = ""):
    """The slab step at pack=(R, qmax): the two wire buffers (already on the
    device) in, ONE uint8 buffer out — the hole-shaped outputs, then the
    int32 (bp, dlen, ovf, advance) as bytes — so the result comes back in
    one copy (_unpack_slab_refine splits it)."""
    R, qmax = pack
    core = _refine_core_packed(params, max_ins, tmax, iters, nseg,
                               bp_consts, impl)

    def step(big, small):
        args = _unpack_slab_args(big, small, R, qmax, nseg, tmax)
        (cons, ins_base, ins_votes, ncov, nwin, bp, advance, dlen,
         ovf) = core(*args)
        small_out = torch.cat([bp, dlen, ovf.to(torch.int32), advance])
        return torch.cat([cons.reshape(-1), ins_base.reshape(-1),
                          ins_votes.reshape(-1), ncov.reshape(-1),
                          nwin.reshape(-1),
                          small_out.to(torch.int32).view(torch.uint8)])

    return step


def _unpack_slab_refine(out: np.ndarray, max_ins: int, tmax: int, H: int,
                        R: int):
    """Host-side split of a slab step's output back into the 9-tuple (cons,
    ins_base, ins_votes, ncov, nwin, bp, advance, dlen, ovf): hole-shaped
    fields (H, ...), advance per row (R,)."""
    T, M = tmax, max_ins
    sizes = [H * T, H * T * M, H * T * M, H * T, H * T]
    offs = np.cumsum([0] + sizes)
    cons = out[offs[0]:offs[1]].reshape(H, T)
    ins_base = out[offs[1]:offs[2]].reshape(H, T, M)
    ins_votes = out[offs[2]:offs[3]].reshape(H, T, M)
    ncov = out[offs[3]:offs[4]].reshape(H, T)
    nwin = out[offs[4]:offs[5]].reshape(H, T)
    small = np.frombuffer(out[offs[5]:].tobytes(), np.int32)
    bp = small[:H]
    dlen = small[H:2 * H]
    ovf = small[2 * H:3 * H] != 0
    advance = small[3 * H:3 * H + R]
    return cons, ins_base, ins_votes, ncov, nwin, bp, advance, dlen, ovf


# ---- the bucketed (Z, P) steps (--pass-buckets, the A/B control) ----------

def _round_body(params: AlignParams, max_ins: int, tmax: int,
                impl: str = ""):
    """One star round over a bucketed group: (Z, P, qmax) passes, each hole
    padded to its pass bucket P (pad passes have qlen 0 and a False
    row_mask), aligned to that hole's (Z, tmax) draft, walked, and voted
    per hole.  The per-hole drafts are gathered into a contiguous (Z·P,
    tmax) tensor (the kernels take one row stride), so each round is one
    fill and one walk launch for the whole group.  Pad passes are filled
    and walked like any row and count nothing in the vote."""
    fill = global_fill(params, impl)

    def body(qs, qlens, row_mask, draft, dlen):
        Z, P, qmax = qs.shape
        hole = torch.arange(Z, device=qs.device).repeat_interleave(P)
        ts_r = draft.index_select(0, hole)          # (Z·P, tmax)
        tl_r = dlen.to(torch.int32).index_select(0, hole)
        q_r = qs.reshape(Z * P, qmax).contiguous()
        ql_r = qlens.reshape(Z * P).to(torch.int32).contiguous()
        _, moves, offs = fill(q_r, ql_r, ts_r, tl_r)
        aligned, ins_cnt, ins_b, lead_ins = traceback.project(
            moves, offs, q_r, ql_r, tl_r, tmax, max_ins)
        aligned = aligned.view(Z, P, tmax)
        ins_cnt = ins_cnt.view(Z, P, tmax)
        ins_b = ins_b.view(Z, P, tmax, max_ins)
        lead_ins = lead_ins.view(Z, P)
        cons, ins_base, ins_votes, ncov, match, nwin = msa.vote(
            aligned, ins_cnt, ins_b, row_mask, max_ins)
        return (cons, ins_base, ins_votes, ncov, nwin, match, aligned,
                ins_cnt, lead_ins)

    return body


def _round_core(params: AlignParams, max_ins: int, tmax: int,
                bp_consts: tuple, impl: str = ""):
    """core(qs (Z, P, qmax), qlens (Z, P), ts (Z, tmax), tlens (Z,),
    row_mask (Z, P)) -> (cons, ins_base, ins_votes, ncov, nwin, bp,
    advance): one round and the breakpoint scan, votes and coverage as
    uint8 (bounded by the pass bucket)."""
    body = _round_body(params, max_ins, tmax, impl)
    bp_advance = bp_mod.make_bp_advance(tmax, *bp_consts)

    def core(qs, qlens, ts, tlens, row_mask):
        (cons, ins_base, ins_votes, ncov, nwin, match, aligned, ins_cnt,
         lead_ins) = body(qs, qlens, row_mask, ts, tlens)
        bp, advance = bp_advance(match, cons, aligned, ins_cnt, lead_ins,
                                 row_mask, tlens)
        return (cons, ins_base, ins_votes.to(torch.uint8),
                ncov.to(torch.uint8), nwin.to(torch.uint8), bp, advance)

    return core


def _refine_core(params: AlignParams, max_ins: int, tmax: int, iters: int,
                 bp_consts: tuple, impl: str = ""):
    """A window's whole refinement loop (_refine_loop) over a bucketed
    group, with the packed core's rules per hole; holes without a real pass
    start frozen.

    core(qs, qlens, ts, tlens, row_mask) (the shapes of _round_core) ->
    (cons, ins_base, ins_votes, ncov, nwin, bp, advance, dlen, ovf), as
    the JAX package's ``_refine_step`` core returns them."""
    one_round = _round_body(params, max_ins, tmax, impl)
    bp_advance = bp_mod.make_bp_advance(tmax, *bp_consts)
    mat = msa.make_materializer(tmax, tmax, max_ins)

    def core(qs, qlens, ts, tlens, row_mask):
        outs, dlen, ovf = _refine_loop(
            lambda d, dl: one_round(qs, qlens, row_mask, d, dl), mat, iters,
            ts, tlens, ~row_mask.any(dim=1), lambda f: f, qs.shape[:2],
            max_ins)
        (cons, ins_base, ins_votes, ncov, nwin, match, aligned, ins_cnt,
         lead_ins) = outs
        bp, advance = bp_advance(match, cons, aligned, ins_cnt, lead_ins,
                                 row_mask, dlen)
        return (cons, ins_base, ins_votes.to(torch.uint8),
                ncov.to(torch.uint8), nwin.to(torch.uint8), bp, advance,
                dlen, ovf)

    return core


def _pack_args(args, pin: bool = False) -> torch.Tensor:
    """Host side of the bucketed transfer protocol: the 5 round/refine
    inputs (qs (Z, P, qmax), qlens (Z, P), ts (Z, tmax), tlens (Z,),
    row_mask (Z, P)) become ONE (Z, P·qmax + tmax + 4·(2P + 1)) uint8
    buffer, a hole a row: its passes, its draft, then the int32 qlens,
    tlen and row_mask as bytes (pinned when ``pin``, so it goes to the
    card in one non-blocking copy)."""
    qs, qlens, ts, tlens, row_mask = args
    Z, P, qmax = qs.shape
    tmax = ts.shape[1]
    small = np.concatenate([np.asarray(qlens, np.int32),
                            np.asarray(tlens, np.int32)[:, None],
                            np.asarray(row_mask, np.int32)], axis=1)
    buf_t = torch.empty((Z, P * qmax + tmax + 4 * (2 * P + 1)),
                        dtype=torch.uint8, pin_memory=pin)
    buf = buf_t.numpy()
    buf[:, :P * qmax] = qs.reshape(Z, P * qmax)
    buf[:, P * qmax:P * qmax + tmax] = ts
    buf[:, P * qmax + tmax:] = small.view(np.uint8)
    return buf_t


def _unpack_args(buf: torch.Tensor, P: int, qmax: int, tmax: int):
    """Device side of _pack_args: (qs, qlens, ts, tlens, row_mask)."""
    Z = buf.shape[0]
    qs = buf[:, :P * qmax].reshape(Z, P, qmax)
    ts = buf[:, P * qmax:P * qmax + tmax]
    small = buf[:, P * qmax + tmax:].contiguous().view(torch.int32)
    return qs, small[:, :P], ts, small[:, P], small[:, P + 1:] != 0


def _pack_out(hole_fields, ints) -> torch.Tensor:
    """The step's ONE (Z, ...) uint8 output: the hole-shaped uint8 fields
    flattened per hole, then the int32 columns as bytes."""
    Z = hole_fields[0].shape[0]
    small = torch.cat([x.reshape(Z, -1).to(torch.int32) for x in ints],
                      dim=1).contiguous()
    return torch.cat([x.reshape(Z, -1) for x in hole_fields]
                     + [small.view(torch.uint8)], dim=1)


def _round_step(params: AlignParams, max_ins: int, tmax: int,
                bp_consts: tuple, pack: tuple, impl: str = ""):
    """The bucketed single round at pack=(P, qmax): the _pack_args buffer
    (on the device) in, one uint8 buffer out (_unpack_round splits it)."""
    core = _round_core(params, max_ins, tmax, bp_consts, impl)
    P, qmax = pack

    def step(buf):
        cons, ins_base, ins_votes, ncov, nwin, bp, advance = core(
            *_unpack_args(buf, P, qmax, tmax))
        return _pack_out((cons, ins_base, ins_votes, ncov, nwin),
                         (bp, advance))

    return step


def _refine_step(params: AlignParams, max_ins: int, tmax: int, iters: int,
                 bp_consts: tuple, pack: tuple, impl: str = ""):
    """The bucketed refinement step (_refine_core) at pack=(P, qmax), as
    _round_step; its output also carries dlen and ovf (_unpack_refine)."""
    core = _refine_core(params, max_ins, tmax, iters, bp_consts, impl)
    P, qmax = pack

    def step(buf):
        (cons, ins_base, ins_votes, ncov, nwin, bp, advance, dlen,
         ovf) = core(*_unpack_args(buf, P, qmax, tmax))
        return _pack_out((cons, ins_base, ins_votes, ncov, nwin),
                         (bp, advance, dlen, ovf))

    return step


def _unpack_round(out: np.ndarray, max_ins: int, tmax: int):
    """Host-side split of a bucketed step's (Z, ...) output into (cons,
    ins_base, ins_votes, ncov, nwin, bp, rest): rest holds the int32
    columns after bp (advance, and for a refine step dlen and ovf)."""
    Z = out.shape[0]
    T, M = tmax, max_ins
    cons = out[:, :T]
    ins_base = out[:, T:T * (1 + M)].reshape(Z, T, M)
    ins_votes = out[:, T * (1 + M):T * (1 + 2 * M)].reshape(Z, T, M)
    ncov = out[:, T * (1 + 2 * M):T * (2 + 2 * M)]
    nwin = out[:, T * (2 + 2 * M):T * (3 + 2 * M)]
    small = np.ascontiguousarray(out[:, T * (3 + 2 * M):]).view(np.int32)
    return cons, ins_base, ins_votes, ncov, nwin, small[:, 0], small[:, 1:]


def _unpack_refine(out: np.ndarray, max_ins: int, tmax: int):
    """_unpack_round for a refine step: the 9-tuple (cons, ins_base,
    ins_votes, ncov, nwin, bp, advance, dlen, ovf)."""
    cons, ins_base, ins_votes, ncov, nwin, bp, rest = _unpack_round(
        out, max_ins, tmax)
    return (cons, ins_base, ins_votes, ncov, nwin, bp, rest[:, :-2],
            rest[:, -2], rest[:, -1] != 0)


def _pair_fill_packed(params: AlignParams, qmax: int, tmax: int, device):
    """The batched local fill of the strand walk's pairs: one (N, qmax+tmax)
    uint8 and one (N, 6) int32 buffer (qlen, tlen, line) in, one (N, 7)
    int32 out (score, qb, qe, tb, te, aln, mat) — one kernel launch."""

    def step(big: np.ndarray, small: np.ndarray) -> torch.Tensor:
        b = torch.from_numpy(big).to(device)
        s = torch.from_numpy(small).to(device)
        r = banded_cuda.batched_align_local(
            b[:, :qmax].contiguous(), s[:, 0].contiguous(),
            b[:, qmax:qmax + tmax].contiguous(), s[:, 1].contiguous(),
            s[:, 2:6].contiguous(), params)
        return torch.stack([r.score, r.qb, r.qe, r.tb, r.te, r.aln, r.mat],
                           dim=1)

    return step


_REJECTED = (False, MatchResult(False, 0, 0, 0, 0, 0, 0, 0))


class PairExecutor:
    """Batches the strand walk's PairRequests (strand_match pairs) across
    holes, in the JAX package's three stages:

    1. the device screen (sketch.screen_step, one batched step per padded
       (qmax, tmax) group) for the pairs of at least ``screen_min_device``
       bases that will not seed on the device; sketch.reject_reason drops
       the hopeless ones.  The screen is advisory: a pair whose screen
       failed on both rungs stays alive;
    2. seeding of the survivors: on the device (seed_device.seed_step, one
       step per group) for templates of at least ``seed_device_min_t``
       bases, otherwise the cached host sort-join (ops/seed.py, with an
       LRU of template indexes).  A pair whose seed failed on both rungs
       quarantines its hole;
    3. the filter rule on the seed statistics (sketch.reject_from_hit) for
       every pair of at least SCREEN_MIN_QT bases not screened in stage 1,
       then ONE batched local-mode fill launch per (qmax, tmax) group.

    Each stage's groups go through the recovery ladder
    (_run_groups_recovering) with its host rung: sketch.screen_host,
    seed.seed_diagonal, HostAligner.strand_match.  Every rule only rejects
    pairs whose acceptance would fail, and either seeding path gives the
    same hit, so the output bytes do not depend on the routing.

    PairBatch entries (the walk's fwd+RC speculation) are evaluated in the
    same wave, every arm, and answered with the aligned list of (ok, rs)
    the first-accept contract requires.
    """

    # bounded LRU of per-template sorted k-mer indexes (keyed by
    # PairRequest.t_token): the walk pairs many passes against one template
    seed_cache_max = 128

    def __init__(self, params: AlignParams, quant: int = 512,
                 device="cuda", counts: Optional[dict] = None,
                 prefilter: bool = True, seed_device_min_t: int = 16384):
        self.params = params
        self.quant = quant
        self.device = torch.device(device)
        self.counts = counts if counts is not None else {}
        self.prefilter = bool(prefilter)
        self.seed_device_min_t = max(0, int(seed_device_min_t))
        # the device screen's floor; below it the rules ride the seed
        # statistics (stage 3).  An attribute so tests can drive the
        # screen at small shapes
        self.screen_min_device = sketch.SPECULATE_MIN_QT
        self._host_aligner = None
        self._seed_cache: "OrderedDict" = OrderedDict()

    def _screens(self, pr) -> bool:
        return (self.prefilter
                and min(len(pr.q), len(pr.t)) >= self.screen_min_device)

    def _seeds_on_device(self, pr) -> bool:
        return (self.seed_device_min_t > 0
                and len(pr.t) >= self.seed_device_min_t)

    @staticmethod
    def _flatten(pairs):
        """Expand PairBatch entries into a flat request list plus the
        (start, count, is_batch) spans to fold results back."""
        flat: List[prep_mod.PairRequest] = []
        spans: List[tuple] = []
        for pr in pairs:
            if isinstance(pr, prep_mod.PairBatch):
                spans.append((len(flat), len(pr.requests), True))
                flat.extend(pr.requests)
            else:
                spans.append((len(flat), 1, False))
                flat.append(pr)
        return flat, spans

    def _seed_indexes(self, pairs):
        """Per-pair sorted template k-mer indexes: cache hits (token-keyed,
        LRU) cost nothing, misses are sorted in ONE vectorized argsort
        (seed.batch_sorted_indexes), and tokened misses enter the cache."""
        indexes: Dict[int, tuple] = {}
        need: List[int] = []
        need_owner: Dict[object, int] = {}
        shared: List[tuple] = []
        for i, pr in enumerate(pairs):
            tok = getattr(pr, "t_token", None)
            if tok is not None:
                hit = self._seed_cache.get(tok)
                if hit is not None:
                    self._seed_cache.move_to_end(tok)
                    indexes[i] = hit
                    continue
                if tok in need_owner:
                    shared.append((i, tok))
                    continue
                need_owner[tok] = i
            need.append(i)
        if need:
            for i, idx in zip(need, seed.batch_sorted_indexes(
                    [pairs[i].t for i in need])):
                indexes[i] = idx
                tok = getattr(pairs[i], "t_token", None)
                if tok is not None:
                    self._seed_cache[tok] = idx
                    while len(self._seed_cache) > self.seed_cache_max:
                        self._seed_cache.popitem(last=False)
        for i, tok in shared:
            indexes[i] = indexes[need_owner[tok]]
        return indexes

    def _groups(self, pairs, idxs) -> Dict[tuple, List[int]]:
        groups: Dict[tuple, List[int]] = defaultdict(list)
        for i in idxs:
            groups[(bucket_len(len(pairs[i].q), self.quant),
                    bucket_len(len(pairs[i].t), self.quant))].append(i)
        return groups

    def _pad_pair(self, pairs, idxs, key):
        """The wire layout of the screen and seed steps, on the device:
        (N, qmax+tmax) PAD-filled codes and (N, 2) int32 lengths (a padded
        tail is inert: every k-mer window touching PAD is bad)."""
        qmax, tmax = key
        big = np.full((len(idxs), qmax + tmax), banded.PAD, np.uint8)
        small = np.zeros((len(idxs), 2), np.int32)
        for z, i in enumerate(idxs):
            big[z, :qmax] = pad_to(pairs[i].q, qmax)
            big[z, qmax:] = pad_to(pairs[i].t, tmax)
            small[z] = len(pairs[i].q), len(pairs[i].t)
        return (torch.from_numpy(big).to(self.device),
                torch.from_numpy(small).to(self.device))

    def _screen_wave(self, pairs, idxs, results) -> int:
        """Stage 1: one batched screen per (qmax, tmax) group over idxs;
        rejected pairs get their final (False, empty) result.  Returns the
        number rejected."""
        triples: List = [None] * len(pairs)

        def dispatch(gidxs, key):
            _bump(self.counts, screen_steps=1)
            return sketch.screen_step(*key)(*self._pad_pair(pairs, gidxs,
                                                            key))

        def finish(gidxs, key, out):
            out = out.cpu()
            for z, i in enumerate(gidxs):
                triples[i] = tuple(int(v) for v in out[z])

        def host_one(i):
            return sketch.screen_host(pairs[i].q, pairs[i].t)

        _run_groups_recovering(self._groups(pairs, idxs), dispatch, finish,
                               host_one, triples, self.counts)
        rejected = 0
        for i in idxs:
            tr = triples[i]
            if not isinstance(tr, tuple):
                continue   # the screen failed for this pair: keep it alive
            pr = pairs[i]
            if sketch.reject_reason(*tr, len(pr.q), len(pr.t), pr.pct,
                                    self.params.band):
                results[i] = _REJECTED
                rejected += 1
        return rejected

    def _seed_wave(self, pairs, idxs, hits, results) -> None:
        """Stage 2's device half: one batched seed per (qmax, tmax) group;
        rows fold back into ``hits`` as the SeedHit-or-None the host path
        gives.  A pair whose seed failed on both rungs carries its
        Exception into ``results`` (its hole is quarantined)."""
        rows: List = [None] * len(pairs)

        def dispatch(gidxs, key):
            _bump(self.counts, seed_steps=1)
            return seed_device.seed_step(*key)(*self._pad_pair(pairs, gidxs,
                                                               key))

        def finish(gidxs, key, out):
            out = out.cpu()
            for z, i in enumerate(gidxs):
                rows[i] = [int(v) for v in out[z]]

        def host_one(i):
            hit = seed.seed_diagonal(pairs[i].q, pairs[i].t)
            if hit is None:
                return [0] * 8
            return [1, hit.diag, hit.votes, *(int(v) for v in hit.line), 0]

        _run_groups_recovering(self._groups(pairs, idxs), dispatch, finish,
                               host_one, rows, self.counts)
        for i in idxs:
            r = rows[i]
            if isinstance(r, Exception):
                results[i] = r
            elif r is not None:
                hits[i] = seed_device.hit_from_row(r)

    def run(self, pairs):
        """Satisfy all pair requests; results align index-for-index —
        (ok, MatchResult) for a PairRequest, a list of them for a
        PairBatch."""
        flat, spans = self._flatten(pairs)
        results = self._run_flat(flat)
        return [list(results[s:s + n]) if is_batch else results[s]
                for s, n, is_batch in spans]

    def _run_flat(self, pairs):
        results: List = [None] * len(pairs)
        lines: Dict[int, np.ndarray] = {}
        band = self.params.band

        # stage 1: the device screen, only for long pairs that will not
        # seed on the device (the seed's rows carry the same statistics,
        # so stage 3 filters those for free)
        screen_ids = [i for i, pr in enumerate(pairs)
                      if self._screens(pr) and not self._seeds_on_device(pr)]
        rejected = 0
        if screen_ids:
            rejected = self._screen_wave(pairs, screen_ids, results)

        # stage 2: seeding for the survivors, on the device for long
        # templates and by the cached host sort-join below that
        hits: Dict[int, object] = {}
        dev_ids = [i for i, pr in enumerate(pairs)
                   if results[i] is None and self._seeds_on_device(pr)]
        dev_set = set(dev_ids)
        host_ids = [i for i in range(len(pairs))
                    if results[i] is None and i not in dev_set]
        seed_idx = self._seed_indexes([pairs[i] for i in host_ids])
        for pos, i in enumerate(host_ids):
            hits[i] = seed.seed_diagonal(pairs[i].q, pairs[i].t,
                                         t_index=seed_idx.get(pos))
        if dev_ids:
            self._seed_wave(pairs, dev_ids, hits, results)

        # stage 3: the filter rule on the seed statistics for every
        # eligible pair not screened in stage 1, then the local fill
        screen_set = set(screen_ids)
        screened = len(screen_ids)
        fill_ids = []
        for i, pr in enumerate(pairs):
            if results[i] is not None:
                continue
            hit = hits.get(i)
            if hit is None:
                # no shared 13-mers: unalignable at >=60% identity
                results[i] = _REJECTED
                continue
            if (self.prefilter and i not in screen_set
                    and min(len(pr.q), len(pr.t)) >= sketch.SCREEN_MIN_QT):
                screened += 1
                if sketch.reject_from_hit(hit, len(pr.q), len(pr.t), pr.pct,
                                          band):
                    results[i] = _REJECTED
                    rejected += 1
                    continue
            if abs(hit.diag) > band // 4:
                lines[i] = np.asarray(hit.line, np.int32)
            else:
                # near-diagonal: the default corner-to-corner line
                lines[i] = np.array([0, 0, len(pr.q), len(pr.t)], np.int32)
            fill_ids.append(i)
        groups = self._groups(pairs, fill_ids)
        _bump(self.counts, pair_fills=len(groups), pairs=len(lines),
              pairs_seeded_device=len(dev_ids),
              pairs_seeded_host=len(host_ids), pairs_screened=screened,
              pairs_prefiltered=rejected)

        def dispatch(idxs, key):
            qmax, tmax = key
            big = np.full((len(idxs), qmax + tmax), banded.PAD, np.uint8)
            small = np.zeros((len(idxs), 6), np.int32)
            for z, i in enumerate(idxs):
                big[z, :qmax] = pad_to(pairs[i].q, qmax)
                big[z, qmax:] = pad_to(pairs[i].t, tmax)
                small[z, 0] = len(pairs[i].q)
                small[z, 1] = len(pairs[i].t)
                small[z, 2:6] = lines[i]
            return _pair_fill_packed(self.params, qmax, tmax,
                                     self.device)(big, small)

        def finish(idxs, key, res):
            res = res.cpu().numpy()
            for z, i in enumerate(idxs):
                score, qb, qe, tb, te, aln, mat = (int(v) for v in res[z])
                pr = pairs[i]
                # acceptance rule, main.c:280
                ok = (aln * 2 > min(len(pr.q), len(pr.t))
                      and mat * 100 >= aln * pr.pct)
                results[i] = (ok, MatchResult(ok, score, qb, qe, tb, te,
                                              aln, mat))

        def host_one(i):
            if self._host_aligner is None:
                self._host_aligner = HostAligner(self.params, self.quant,
                                                 self.device)
            pr = pairs[i]
            return self._host_aligner.strand_match(pr.q, pr.t, pr.pct)

        _run_groups_recovering(groups, dispatch, finish, host_one, results,
                               self.counts)
        return results


class BatchExecutor:
    """Serves RefineRequests (one window's whole refinement, the only
    request the production generators yield) and bare RoundRequests.

    Packed (``cfg.pass_packing``, the default): refine requests group by
    (qmax, tmax, iters), each group's (hole, pass) rows are laid into (R,
    qmax) slabs first-fit-decreasing by hole (pipeline/pack.py), and each
    slab is ONE device step (_refine_step_packed).  A slab's idxs are its
    HOLES, so the OOM rung bisects by hole and each half re-packs into the
    smaller covering slab.

    Bucketed (--pass-buckets, the A/B control): refine requests group by
    (P, qmax, _fused_tmax, iters), P being the request's pass bucket, and
    each group is ONE (Z, P) step (_refine_step) with its pad passes
    filled, walked and masked out of the vote; the OOM rung bisects the
    group's holes.  Bare RoundRequests always take the bucketed single
    round (_round_step), grouped by (P, qmax, tmax).

    Either way the per-request replay is refine_host (or the round) over
    the per-hole round, on the same device."""

    # OOM resplit ladder: three halvings before the per-request replay
    max_oom_resplits = 3
    oom_backoff_s = 0.05

    def __init__(self, cfg: CcsConfig, device="cuda",
                 counts: Optional[dict] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.counts = counts if counts is not None else {}
        self.len_quant = cfg.len_bucket_quant
        self._sm = StarMsa(cfg.align, cfg.max_ins_per_col,
                           cfg.len_bucket_quant, self.device,
                           cfg.banded_impl)
        self.slab_rows = pack_mod.pow2(max(1, cfg.slab_rows))
        self.slab_ladder = max(1, int(cfg.slab_shape_ladder))
        # one device: the JAX package's rule (pass_packing, and --mesh is
        # ignored on a single device) reduces to the flag
        self.packing = bool(cfg.pass_packing)

    def _bp_consts(self):
        cfg = self.cfg
        return (cfg.bp_window, cfg.bp_minwin, cfg.bp_rowrate,
                cfg.bp_colrate, cfg.bp_colrate_lowpass)

    def _stack_slab(self, reqs, idxs, qmax, tmax):
        """Pack the real pass-rows of the given requests into ONE slab:
        (R, qmax) rows + (H, tmax) per-hole drafts + the row->hole segment
        vector, rows in idxs order (the packing plan's placement order)."""
        rows = [int(reqs[i].row_mask.sum()) for i in idxs]
        R, H = pack_mod.slab_shape(rows, self.slab_rows,
                                   ladder=self.slab_ladder)
        qs = np.zeros((R, qmax), np.uint8)
        qlens = np.zeros((R,), np.int32)
        row_mask = np.zeros((R,), bool)
        seg = pack_mod.segment_ids(rows, R)
        # empty hole slots: 1-col no-op drafts (frozen from the start)
        ts = np.full((H, tmax), banded.PAD, np.uint8)
        ts[:, 0] = 0
        tlens = np.ones((H,), np.int32)
        r0 = 0
        for s, i in enumerate(idxs):
            req = reqs[i]
            m = req.row_mask
            n = rows[s]
            qs[r0:r0 + n] = req.qs[m]
            qlens[r0:r0 + n] = req.qlens[m]
            row_mask[r0:r0 + n] = True
            ts[s] = pad_to(req.draft, tmax)
            tlens[s] = len(req.draft)
            r0 += n
        return qs, qlens, row_mask, seg, ts, tlens

    def _stack_group(self, reqs, idxs, P, qmax, tmax):
        """Stack a bucketed group's requests into (Z, P) step inputs, Z =
        len(idxs): each request keeps its own P pass rows (pad passes
        included) and its draft padded to tmax.  Unlike the JAX package
        (_z_bucket), Z is not padded to a power of two: the port compiles
        nothing per shape."""
        Z = len(idxs)
        qs = np.zeros((Z, P, qmax), np.uint8)
        qlens = np.zeros((Z, P), np.int32)
        ts = np.full((Z, tmax), banded.PAD, np.uint8)
        tlens = np.ones((Z,), np.int32)
        row_mask = np.zeros((Z, P), bool)
        for z, i in enumerate(idxs):
            req = reqs[i]
            qs[z] = req.qs
            qlens[z] = req.qlens
            ts[z] = pad_to(req.draft, tmax)
            tlens[z] = len(req.draft)
            row_mask[z] = req.row_mask
        return qs, qlens, ts, tlens, row_mask

    def run(self, requests) -> list:
        """Satisfy all requests (RefineRequest, the production window
        protocol, and bare RoundRequest); results align index-for-index
        (RefineResult / RoundResult, or an Exception for a request whose
        replay failed)."""
        results: List[object] = [None] * len(requests)
        refine, rounds = [], []
        for i, r in enumerate(requests):
            if isinstance(r, RefineRequest):
                refine.append(i)
            elif isinstance(r, RoundRequest):
                rounds.append(i)
            else:
                raise TypeError(f"BatchExecutor serves RefineRequests and "
                                f"RoundRequests, got {type(r).__name__}")
        for kind, idxs in ((self._run_refine, refine),
                           (self._run_rounds, rounds)):
            if idxs:
                for i, res in zip(idxs, kind([requests[i] for i in idxs])):
                    results[i] = res
        return results

    def _run_rounds(self, requests: List[RoundRequest]) -> list:
        """Bare rounds, one bucketed (Z, P) step per (P, qmax, tmax)
        group."""
        cfg = self.cfg
        M = cfg.max_ins_per_col
        groups: Dict[tuple, List[int]] = defaultdict(list)
        for i, req in enumerate(requests):
            P, qmax = req.qs.shape
            groups[(P, qmax, bucket_len(len(req.draft), self.len_quant))
                   ].append(i)
        results: List[object] = [None] * len(requests)
        _bump(self.counts, round_groups=len(groups))
        pin = self.device.type == "cuda"

        def dispatch(idxs, key):
            P, qmax, tmax = key
            buf = _pack_args(self._stack_group(requests, idxs, P, qmax,
                                               tmax), pin=pin)
            step = _round_step(cfg.align, M, tmax, self._bp_consts(),
                               (P, qmax), cfg.banded_impl)
            _bump(self.counts, bucketed_dispatches=1)
            return step(buf.to(self.device, non_blocking=pin))

        def finish(idxs, key, out):
            cons, ins_base, ins_votes, ncov, nwin, bp, advance = \
                _unpack_round(out.cpu().numpy(), M, key[2])
            for z, i in enumerate(idxs):
                results[i] = RoundResult(
                    cons=cons[z], ins_base=ins_base[z],
                    ins_votes=ins_votes[z], ncov=ncov[z], nwin=nwin[z],
                    tlen=len(requests[i].draft), bp=int(bp[z]),
                    advance=advance[z])

        def host_one(i):
            req = requests[i]
            return self._sm.round(req.qs, req.qlens, req.row_mask, req.draft)

        _run_groups_recovering(groups, dispatch, finish, host_one, results,
                               self.counts, self.max_oom_resplits,
                               self.oom_backoff_s)
        return results

    def _run_refine(self, requests: List[RefineRequest]) -> list:
        """Whole-window refinement: packed slabs, or under --pass-buckets
        one bucketed (Z, P) step per (P, qmax, _fused_tmax, iters) group.
        A hole whose draft outgrows the group's tmax is replayed exactly
        on the per-hole path (refine_host)."""
        if self.packing:
            return self._run_refine_packed(requests)
        cfg = self.cfg
        M = cfg.max_ins_per_col
        groups: Dict[tuple, List[int]] = defaultdict(list)
        for i, req in enumerate(requests):
            P, qmax = req.qs.shape
            groups[(P, qmax, _fused_tmax(len(req.draft), self.len_quant),
                    req.iters)].append(i)
        results: List[object] = [None] * len(requests)
        _bump(self.counts, windows=len(requests), bucketed_groups=len(groups))
        pin = self.device.type == "cuda"

        def host_one(i):
            req = requests[i]
            return refine_host(self._sm.round, req.qs, req.qlens,
                               req.row_mask, req.draft, req.iters)

        def dispatch(idxs, key):
            P, qmax, tmax, iters = key
            buf = _pack_args(self._stack_group(requests, idxs, P, qmax,
                                               tmax), pin=pin)
            step = _refine_step(cfg.align, M, tmax, iters,
                                self._bp_consts(), (P, qmax),
                                cfg.banded_impl)
            _bump(self.counts, bucketed_dispatches=1)
            return step(buf.to(self.device, non_blocking=pin))

        def finish(idxs, key, out):
            (cons, ins_base, ins_votes, ncov, nwin, bp, advance, dlen,
             ovf) = _unpack_refine(out.cpu().numpy(), M, key[2])
            for z, i in enumerate(idxs):
                if ovf[z]:
                    _bump(self.counts, refine_overflows=1)
                    _host_replay_all([i], host_one, results, self.counts)
                    continue
                results[i] = RefineResult(rr=RoundResult(
                    cons=cons[z], ins_base=ins_base[z],
                    ins_votes=ins_votes[z], ncov=ncov[z], nwin=nwin[z],
                    tlen=int(dlen[z]), bp=int(bp[z]), advance=advance[z]))

        _run_groups_recovering(groups, dispatch, finish, host_one, results,
                               self.counts, self.max_oom_resplits,
                               self.oom_backoff_s)
        return results

    def _run_refine_packed(self, requests: List[RefineRequest]) -> list:
        """The packed branch of _run_refine."""
        cfg = self.cfg
        M = cfg.max_ins_per_col
        nrows = [int(r.row_mask.sum()) for r in requests]
        results: List[object] = [None] * len(requests)
        _bump(self.counts, windows=len(requests))

        def host_one(i):
            req = requests[i]
            return refine_host(self._sm.round, req.qs, req.qlens,
                               req.row_mask, req.draft, req.iters)

        shape_groups: Dict[tuple, List[int]] = defaultdict(list)
        for i, req in enumerate(requests):
            if nrows[i] == 0:
                # no live pass-rows (the windowed driver never makes one):
                # nothing to pack, the per-hole path is its spec
                _host_replay_all([i], host_one, results, self.counts)
                continue
            tmax = _fused_tmax(len(req.draft), self.len_quant)
            shape_groups[(req.qs.shape[1], tmax, req.iters)].append(i)

        groups: Dict[tuple, List[int]] = {}
        for key, idxs in shape_groups.items():
            for s_no, slab in enumerate(pack_mod.plan_slabs(
                    [nrows[i] for i in idxs], self.slab_rows)):
                groups[key + (s_no,)] = [idxs[j] for j in slab]
        _bump(self.counts, slabs=len(groups))
        pin = self.device.type == "cuda"

        def dispatch(idxs, key):
            qmax, tmax, iters, _ = key
            args = self._stack_slab(requests, idxs, qmax, tmax)
            R, H = args[0].shape[0], args[4].shape[0]
            big, small = _pack_slab_args(args, pin=pin)
            step = _refine_step_packed(cfg.align, M, tmax, iters, H,
                                       self._bp_consts(), (R, qmax),
                                       cfg.banded_impl)
            return step(big.to(self.device, non_blocking=pin),
                        small.to(self.device, non_blocking=pin))

        def finish(idxs, key, out):
            _, tmax, _, _ = key
            R, H = pack_mod.slab_shape([nrows[i] for i in idxs],
                                       self.slab_rows,
                                       ladder=self.slab_ladder)
            (cons, ins_base, ins_votes, ncov, nwin, bp, advance, dlen,
             ovf) = _unpack_slab_refine(out.cpu().numpy(), M, tmax, H, R)
            r0 = 0
            for s, i in enumerate(idxs):
                req = requests[i]
                rows = slice(r0, r0 + nrows[i])
                r0 += nrows[i]
                if ovf[s]:
                    _bump(self.counts, refine_overflows=1)
                    _host_replay_all([i], host_one, results, self.counts)
                    continue
                # row advances back into the request's (P,) pass order;
                # masked pass rows consumed nothing
                adv = np.zeros(req.qs.shape[0], np.int32)
                adv[req.row_mask] = advance[rows]
                results[i] = RefineResult(rr=RoundResult(
                    cons=cons[s], ins_base=ins_base[s],
                    ins_votes=ins_votes[s], ncov=ncov[s], nwin=nwin[s],
                    tlen=int(dlen[s]), bp=int(bp[s]), advance=adv))

        _run_groups_recovering(groups, dispatch, finish, host_one, results,
                               self.counts, self.max_oom_resplits,
                               self.oom_backoff_s)
        return results


# ---- the driver -------------------------------------------------------------

@dataclasses.dataclass
class _Hole:
    idx: int
    zmw: object
    gen: object = None         # consensus generator (None => skipped)
    req: object = None         # pending PairRequest | PairBatch | RefineRequest
    done: bool = False
    cns: Optional[tuple] = None  # (seq_bytes, qual_bytes|None)
    err: Optional[Exception] = None


def _finish(result):
    """Generator result -> (seq_bytes, qual|None) or None (skipped)."""
    return enc.to_record(result)


def _start_hole(hole: _Hole, cfg: CcsConfig) -> None:
    """Start the combined prep+consensus generator (first step only)."""
    try:
        hole.gen = full_gen_for_zmw(hole.zmw, cfg)
        hole.req = next(hole.gen)
    except StopIteration as e:
        # skipped (<3 passes -> None) or consensus without device work
        hole.done, hole.cns = True, _finish(e.value)
    except Exception as e:  # quarantine: one bad hole must not kill the run
        hole.done, hole.err = True, e


def _advance_hole(hole: _Hole, result) -> None:
    """Feed the matching result (MatchResult / RefineResult) back in."""
    try:
        hole.req = hole.gen.send(result)
    except StopIteration as e:
        hole.done, hole.req, hole.cns = True, None, _finish(e.value)
    except Exception as e:
        hole.done, hole.req, hole.err = True, None, e


def _feed_hole(hole: _Hole, result) -> None:
    """Route an executor result back into a hole's generator — unless it is
    an Exception (a failed per-request replay), which quarantines the hole,
    not the run.  A PairBatch result (a list) quarantines on its first
    embedded Exception the same way."""
    if isinstance(result, list):
        exc = next((r for r in result if isinstance(r, Exception)), None)
        if exc is not None:
            result = exc
    if isinstance(result, Exception):
        hole.done, hole.req, hole.err = True, None, result
        try:
            hole.gen.close()
        except Exception:
            pass
    else:
        _advance_hole(hole, result)


def _grow_window(window: int, cap: int, growth: int) -> int:
    """One step of the reference's adaptive chunk policy scaled to the
    admission window (main.c:686-691: start at cap/growth^2, multiply by
    growth until the cap)."""
    return min(window * max(2, int(growth)), cap)


def drive_batched(stream, writer, cfg: CcsConfig, device,
                  counts: dict, inflight: Optional[int] = None) -> None:
    """The batched scheduler over an open ZMW stream and writer.

    Admits holes into a window, runs one pair sweep and one refine sweep
    over every pending request per loop, and writes finished holes in
    input order.  ``inflight`` pins the admission window; None (or <= 0)
    selects the adaptive window: it starts at cfg.zmw_microbatch /
    chunk_growth^2 and grows by chunk_growth per filled admission round up
    to cfg.zmw_microbatch.  Holes in flight plus holes waiting for ordered
    emission stay within 4x the cap.

    Counters go into ``counts`` ('in', 'out', 'failed', 'windows', ...).
    A kernel or card fault raises cuda_ext.KernelError out of here."""
    explicit_window = inflight is not None and int(inflight) > 0
    cap = max(1, int(inflight) if explicit_window
              else int(cfg.zmw_microbatch))
    growth = max(2, int(cfg.chunk_growth))
    window = cap if explicit_window else max(1, cap // (growth * growth))
    executor = BatchExecutor(cfg, device, counts)
    pair_executor = PairExecutor(cfg.align, quant=cfg.len_bucket_quant,
                                 device=device, counts=counts,
                                 prefilter=cfg.prefilter,
                                 seed_device_min_t=cfg.seed_device_min_t)
    active: List[_Hole] = []
    finished: Dict[int, _Hole] = {}
    next_idx = 0       # next hole index to admit
    next_emit = 0      # next hole index to write
    exhausted = False

    def emit_ready():
        nonlocal next_emit
        while next_emit in finished:
            h = finished.pop(next_emit)
            if h.err is not None:
                counts["failed"] += 1
                print(f"[ccsx-tpu-torch] hole {h.zmw.movie}/{h.zmw.hole} "
                      f"failed: {h.err}", file=sys.stderr)
            elif h.cns is not None and h.cns[0]:
                writer.put(f"{h.zmw.movie}/{h.zmw.hole}/ccs", *h.cns)
                counts["out"] += 1
            next_emit += 1

    while True:
        while (not exhausted and len(active) < window
               and next_idx - next_emit < 4 * cap):
            try:
                z = next(stream)
            except StopIteration:
                exhausted = True
                break
            counts["in"] += 1
            h = _Hole(idx=next_idx, zmw=z)
            next_idx += 1
            _start_hole(h, cfg)
            if h.done:
                finished[h.idx] = h
            else:
                active.append(h)
        admitted_full = len(active) >= window
        emit_ready()
        if not active:
            if exhausted:
                break
            continue
        # one batched sweep over every pending request, split by kind
        is_pair = [isinstance(h.req, (prep_mod.PairRequest,
                                      prep_mod.PairBatch)) for h in active]
        pair_holes = [h for h, p in zip(active, is_pair) if p]
        round_holes = [h for h, p in zip(active, is_pair) if not p]
        if pair_holes:
            for h, r in zip(pair_holes,
                            pair_executor.run([h.req for h in pair_holes])):
                _feed_hole(h, r)
        if round_holes:
            for h, rr in zip(round_holes,
                             executor.run([h.req for h in round_holes])):
                _feed_hole(h, rr)
        still: List[_Hole] = []
        for h in active:
            if h.done:
                finished[h.idx] = h
            else:
                still.append(h)
        active = still
        emit_ready()
        if not explicit_window and admitted_full and window < cap:
            window = _grow_window(window, cap, growth)

