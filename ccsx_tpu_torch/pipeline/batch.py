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

This is the JAX package's pipeline/batch.py, with the same slab plan and
groups, the same per-hole freeze/fixpoint/overflow rules and so the same
output bytes; with more than one device, its fused multi-device packed
dispatch and its (data, pass) mesh (--mesh D,P) over logical devices
(parallel/mesh.py), each a card and a stream of its own.  JAX runs the refine loop as a device ``while_loop``, one compiled
program per canonical slab shape.  Here, on the card, each refine step at
one shape is one CUDA graph of exactly iters + 1 rounds with no host read
(pipeline/graphs.py): a shape's first slab runs the rounds eagerly, its
second captures the graph (or the warmup plane, pipeline/warmup.py,
captures it ahead of the first), and every later slab replays it; on the
CPU the step runs eagerly, a loop of at most iters + 1 rounds that reads
one bool per round.  The JAX package pads a bucketed group's Z to a
power of two (_z_bucket) to bound its compiles; the port does not, so a
bucketed group captures one graph per distinct Z.

Failures (classify_failure): a CUDA out-of-memory error drops the refine
programs and bisects the slab by hole and retries the halves (capped depth,
backoff); a kernel or card fault,
or a kernel wrapper refusing its tensors, ends the run
(``cuda_ext.KernelError``, rc 1 from the caller), never replayed or
quarantined; any other error replays each request of the group through the
per-hole round on the same device (counted as ``failed_steps`` and
``host_fallbacks``, which the run reports even without -v), and a failure
there quarantines that one hole.  The resilience plane
(pipeline/resilience.py, one Resilience a run, shared by both executors)
bounds each step's dispatch and its device-to-host read with
``--dispatch-deadline``: an expired call is abandoned on its thread and
its group replays per request (the ``hang`` class, booked as
``device_hangs`` and the degraded mark); hangs and the OOM ladder's bottom
strike the circuit breaker, and an open breaker sends whole groups to the
per-request replay, which launches the same kernels eagerly.

Recording (utils/trace.py, utils/metrics.py): the JAX package's spans at the
JAX package's places, with its names and group keys — a device span around
each device step (``sketch_screen``, ``seed_device``, ``pair_fill``,
``round``, ``refine``, ``refine_packed``; forced only under --trace), a
``materialize`` span around each device-to-host read, ``host_replay`` spans
and ``recover`` instants on the ladder, and the driver's ``ingest_hole``,
``prep_hole``, ``pair_sweep``, ``refine_sweep`` and ``write_record`` spans
under the matching stage timers.  The port's own spans name the rest of
the driver thread's phases, one a sweep or a dispatch, never one a hole:
``admit`` (taking holes from the prep plane, its blocked wait inside),
``emit`` (writing the finished holes in order, ``write_record`` inside),
and inside ``refine_sweep`` ``plan`` (grouping and the slab plan),
``slab_pack`` (stacking and staging a slab, one a dispatch), ``unpack``
(routing a slab's results, one a dispatch) and ``hole_step`` (the
generators' vote epilogue and next-window draft, one a sweep); a CUDA
graph build is a ``graph_capture`` span (pipeline/graphs.py).  An open
in-memory capture (utils/capture.py) keeps them all.
"""

from __future__ import annotations

import dataclasses
import functools
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
from ccsx_tpu_torch.parallel import mesh as mesh_mod
from ccsx_tpu_torch.pipeline import graphs
from ccsx_tpu_torch.pipeline import pack as pack_mod
from ccsx_tpu_torch.pipeline import resilience as resil_mod
from ccsx_tpu_torch.utils import device as device_mod
from ccsx_tpu_torch.utils import faultinject, trace
from ccsx_tpu_torch.utils.journal import Journal
from ccsx_tpu_torch.utils.metrics import check_failure_budget
from ccsx_tpu_torch.utils.run_metrics import RunMetrics


# ---- failure taxonomy and recovery (shared by both executors) ------------

def classify_failure(exc: BaseException) -> str:
    """'hang' | 'oom' | 'fatal' | 'data' for an exception from a device step.

    'hang' is a dispatch deadline's expiry (resilience.DeadlineExpired):
    the call was abandoned, so there is nothing to retry — a wedged card
    would only burn another deadline — and the group goes straight to the
    per-request replay (and strikes the circuit breaker).  'oom'
    (torch.cuda.OutOfMemoryError) is transient: the group is bisected and
    retried.  'fatal' is a kernel that did not build or launch, a wrapper
    that refused its tensors (cuda_ext.RefusedInputs), or a CUDA runtime
    error (cuda_ext.is_device_fault): every later step would hit it too, so
    the run ends.  'data' is a fault in the requests' own data: each
    request is replayed on the per-hole path, so the blast radius is one
    quarantined hole."""
    if isinstance(exc, resil_mod.DeadlineExpired):
        return "hang"
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


def _replay(i, host_one, results, **span_args) -> None:
    """Replay request i on the per-hole path, in a ``host_replay`` span; a
    failure there becomes its result (an Exception the driver quarantines
    per hole).  A device fault during the replay still ends the run."""
    try:
        with trace.span("host_replay", cat="recover", **span_args):
            results[i] = host_one(i)
    except Exception as e:
        if classify_failure(e) == "fatal":
            raise _fatal(e) from e
        results[i] = e


def _host_replay_all(idxs, host_one, results, metrics, group,
                     reason) -> None:
    """The ladder bottom, and an open breaker's route: replay each request
    on the per-hole path."""
    for i in idxs:
        metrics.bump(host_fallbacks=1)
        _replay(i, host_one, results, group=group, reason=reason)


def _bounded(resil, label_str, phase, fn):
    """Deadline-bound ``fn`` through the run's Resilience (a plain call when
    deadlines are off or no Resilience is wired)."""
    if resil is None or not resil.enabled:
        return fn()
    return resil.call(fn, label_str, phase)


def _out_shape_tag(out) -> str:
    """Shape signature of a step's output: the materialize span's key for
    the watchdog's first-of-shape grace (as in the JAX package)."""
    return "x".join(str(d) for d in out.shape)


def _read(out) -> np.ndarray:
    """A step's output on the host: a tensor, or a mesh step's outputs on
    several logical devices (parallel/mesh.Placed, each read on its own
    stream)."""
    if isinstance(out, mesh_mod.Placed):
        return out.read()
    return out.cpu().numpy()


def _materialize(out, group: str, n: int, resil=None) -> np.ndarray:
    """The device-to-host read of a step's output, in a watchdog-visible
    device span (attribute=False: a wait, never in the group table).  An
    untraced step's span closes once its launches are queued, so a hung
    kernel surfaces here, where the host blocks; with a dispatch deadline
    the wait itself is bounded (``resil``)."""
    with trace.device_span("materialize", group=group,
                           shape=_out_shape_tag(out), attribute=False, n=n):
        return _bounded(resil, group, "materialize", lambda: _read(out))


def _run_group_sync(idxs, key, dispatch, finish, host_one, results, metrics,
                    depth, max_resplits, backoff_s, label=str, resil=None,
                    probe=False) -> None:
    """Dispatch and finish one (sub)group, recovering from failures.
    ``probe``: this group carries the breaker's half-open probe token — its
    success or failure (and only its) settles the probe."""
    try:
        out = _bounded(resil, label(key), "dispatch",
                       lambda: dispatch(idxs, key))
        finish(idxs, key, _materialize(out, label(key), len(idxs), resil))
        if probe and resil is not None:
            resil.breaker.probe_succeeded()
    except Exception as e:
        _recover_group(e, idxs, key, dispatch, finish, host_one, results,
                       metrics, depth, max_resplits, backoff_s, label,
                       resil=resil, probe=probe)


def _recover_group(exc, idxs, key, dispatch, finish, host_one, results,
                   metrics, depth, max_resplits, backoff_s,
                   label=str, resil=None, probe=False) -> None:
    """The recovery ladder for one failed group.

    fatal -> re-raised as cuda_ext.KernelError: the run ends (no strike:
             the breaker never routes around a kernel that cannot launch)
    hang  -> (a dispatch deadline abandoned the call) no retry: books
             device_hangs and the degraded mark, strikes the breaker, and
             replays each request on the per-hole path
    oom   -> drop the refine programs (graphs.clear), then bisect idxs
             (each half re-packs into a smaller covering slab) with
             exponential backoff, at most max_resplits deep; the bottom
             strikes the breaker and replays per request
    data  -> replay each request on the per-hole path; never a strike (a
             bad hole says nothing about the card), but the probe's token
             is released when this group carried it
    """
    kind = classify_failure(exc)
    trace.instant("recover", cat="recover", kind=kind, group=label(key),
                  n=len(idxs), depth=depth)
    if kind == "fatal":
        raise _fatal(exc) from exc
    if kind == "hang" and resil is not None:
        resil.note_hang(label(key), exc, probe=probe)
    if kind == "oom":
        # the refine programs' graphs and pool, and the allocator's cache,
        # before anything is retried
        graphs.clear()
    if kind == "oom" and depth < max_resplits and len(idxs) > 1:
        metrics.bump(oom_resplits=1)
        print(f"[ccsx-tpu-torch] device OOM on a {len(idxs)}-request group "
              f"{key}: resplitting (depth {depth + 1}): {exc}",
              file=sys.stderr)
        time.sleep(backoff_s * (2 ** depth))
        mid = (len(idxs) + 1) // 2
        for part in (idxs[:mid], idxs[mid:]):
            _run_group_sync(part, key, dispatch, finish, host_one, results,
                            metrics, depth + 1, max_resplits, backoff_s,
                            label, resil=resil, probe=probe)
        return
    if kind == "oom" and resil is not None:
        # the bottom of the ladder (depth cap or a single request): a
        # strike against the card, unlike a recoverable resplit
        resil.breaker.strike("oom", label(key), probe=probe)
    if kind == "data" and resil is not None and probe:
        resil.breaker.settle_probe()
    metrics.bump(failed_steps=1)
    print(f"[ccsx-tpu-torch] device step failed ({kind}) for a "
          f"{len(idxs)}-request group {key}; replaying per request: {exc}",
          file=sys.stderr)
    _host_replay_all(idxs, host_one, results, metrics, label(key), kind)


def _run_groups_recovering(groups, dispatch, finish, host_one, results,
                           metrics, max_resplits=3, backoff_s=0.05,
                           label=str, resil=None) -> None:
    """Dispatch every group's device work before finishing any (launches
    are asynchronous, so one group's device work overlaps the previous
    group's host side); a failure at either phase drops that one group
    into the recovery ladder.  ``label`` maps a group key to its trace
    group (the dispatch span's, without a slab ordinal).

    Resilience (pipeline/resilience.py, ``resil``): an OPEN circuit
    breaker routes whole groups to the per-request replay without a
    batched step (one probe group per --breaker-probe-s when half-open);
    a --dispatch-deadline bounds both the dispatch and the materialize
    wait, abandoning a wedged call into the ladder's ``hang`` class."""
    _OPEN = object()   # the breaker refused this group's dispatch
    pending = []
    for key, idxs in groups.items():
        mode = resil.admit() if resil is not None else "closed"
        if mode == "host":
            pending.append((idxs, key, _OPEN, None, False))
            continue
        probe = mode == "probe"
        try:
            out = _bounded(resil, label(key), "dispatch",
                           lambda k=key, i=idxs: dispatch(i, k))
            pending.append((idxs, key, None, out, probe))
        except Exception as e:
            pending.append((idxs, key, e, None, probe))
    for idxs, key, exc, out, probe in pending:
        if exc is _OPEN:
            trace.instant("recover", cat="recover", kind="breaker_open",
                          group=label(key), n=len(idxs))
            _host_replay_all(idxs, host_one, results, metrics, label(key),
                             "breaker_open")
            continue
        try:
            if exc is not None:
                raise exc
            finish(idxs, key, _materialize(out, label(key), len(idxs),
                                           resil))
            # only THE probe's own completion settles the breaker
            if probe and resil is not None:
                resil.breaker.probe_succeeded()
        except Exception as e:
            _recover_group(e, idxs, key, dispatch, finish, host_one,
                           results, metrics, 0, max_resplits, backoff_s,
                           label, resil=resil, probe=probe)


def _fused_tmax(tlen: int, quant: int) -> int:
    """Draft capacity for the packed refine step: one geometric bucket above
    the request's own, so the speculative rounds' liberal inserts stay on
    the device in the common case.  A draft outgrowing even that is flagged
    by the step and replayed exactly on the per-hole path (refine_host)."""
    b = bucket_len(tlen, quant)
    return bucket_len(b + 1, quant)


# ---- the packed refine step -----------------------------------------------

def _keep(fixed, old, new):
    """``new`` where ``fixed`` is False, else ``old``; ``fixed`` covers the
    leading axes."""
    return torch.where(fixed.view(fixed.shape + (1,) * (new.dim()
                                                       - fixed.dim())),
                       old, new)


class _Rows:
    """The row-shaped outputs of _refine_loop (match, aligned, ins_cnt,
    lead_ins) over ``shape`` rows on ``device``: (R,) rows of a packed
    slab, or (Z, P) of a bucketed group; ``of_holes(fixed)`` maps the
    holes' frozen flags onto the rows' leading axes."""

    def __init__(self, shape: tuple, of_holes, device):
        self.shape, self.of_holes, self.device = shape, of_holes, device

    def zeros(self, tmax: int) -> tuple:
        def z(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        return (z(*self.shape, tmax, dtype=torch.bool),    # match
                z(*self.shape, tmax, dtype=torch.uint8),   # aligned
                z(*self.shape, tmax, dtype=torch.int32),   # ins_cnt
                z(*self.shape, dtype=torch.int32))         # lead_ins

    def keep(self, fixed, old: tuple, new: tuple) -> tuple:
        fr = self.of_holes(fixed)
        return tuple(_keep(fr, o, n) for o, n in zip(old, new))


class _ShardRows:
    """_Rows over one data shard of a (data, pass) mesh: each pass entry
    keeps its own rows, (Zd, Pb) on its device, so each of the four outputs
    is a list over the entries; ``gather`` joins them on the lead after the
    loop (the breakpoint scan needs all of a hole's rows)."""

    def __init__(self, shard, blocks):
        self.shard = shard
        self.rows = [_Rows(b[0].shape[:2], lambda f: f, e.device)
                     for e, b in zip(shard, blocks)]

    def zeros(self, tmax: int) -> tuple:
        per = []
        for e, r in zip(self.shard, self.rows):
            with mesh_mod.scope(e):
                per.append(r.zeros(tmax))
        return tuple(list(x) for x in zip(*per))

    def keep(self, fixed, old: tuple, new: tuple) -> tuple:
        lead = self.shard[0]
        per = []
        for k, (e, r) in enumerate(zip(self.shard, self.rows)):
            with mesh_mod.scope(e):
                per.append(r.keep(mesh_mod.send(fixed, lead, e),
                                  tuple(x[k] for x in old),
                                  tuple(x[k] for x in new)))
        return tuple(list(x) for x in zip(*per))

    def gather(self, outs: tuple) -> tuple:
        lead = self.shard[0]
        return tuple(torch.cat([mesh_mod.send(x, e, lead)
                                for e, x in zip(self.shard, parts)], dim=1)
                     for parts in outs)


def _refine_loop(one_round, mat, iters: int, draft, dlen, fixed, rows,
                 max_ins: int, device_only: bool = False):
    """The refinement loop both refine cores run, over H holes (slots).

    ``one_round(draft, dlen)`` gives the 9 round outputs: five hole-shaped
    (H, ...) and four row-shaped, which ``rows`` (a _Rows, or a mesh
    shard's _ShardRows) makes, freezes and keeps.  A hole whose
    speculative draft stops changing is frozen (re-rounds on a fixed draft
    are no-ops) and keeps its LAST live round's outputs; a hole whose draft
    would outgrow tmax is frozen and flagged (``ovf``) for an exact host
    replay; the round at it == iters is the mandatory final round; holes
    ``fixed`` at the start (no real rows) never change.  At most iters + 1
    rounds, one bool read per round (whether every hole is frozen).

    ``device_only``: exactly iters + 1 rounds and no host read, the form a
    CUDA graph captures (pipeline/graphs.py).  Its bytes are the early-exit
    loop's: once a hole is frozen the ``torch.where`` below keeps its
    outputs and ``grow`` keeps its draft, so the rounds after every hole
    froze change nothing.  Returns (outs, dlen, ovf)."""
    dev = draft.device
    H, tmax = draft.shape

    def z(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    outs = (z(H, tmax, dtype=torch.uint8),              # cons
            z(H, tmax, max_ins, dtype=torch.uint8),     # ins_base
            z(H, tmax, max_ins, dtype=torch.int32),     # ins_votes
            z(H, tmax, dtype=torch.int32),              # ncov
            z(H, tmax, dtype=torch.int32)               # nwin
            ) + rows.zeros(tmax)
    ovf = torch.zeros(H, dtype=torch.bool, device=dev)
    dlen = dlen.to(torch.int32)
    it = 0
    while True:
        new = one_round(draft, dlen)
        outs = tuple(_keep(fixed, o, n) for o, n in zip(outs[:5], new[:5])
                     ) + rows.keep(fixed, outs[5:], new[5:])
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
        if not device_only and bool(fixed.all()):
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
                        impl: str = "", device_only: bool = False):
    """The whole-window refinement loop (_refine_loop) over ONE packed slab.

    core(qs (R, qmax) uint8, qlens (R,) int32, row_mask (R,) bool, seg (R,)
    int, ts (H, tmax) uint8, tlens (H,) int32) -> (cons, ins_base,
    ins_votes, ncov, nwin, bp, advance, dlen, ovf), H = nseg, as the JAX
    package's ``_refine_core_packed`` returns them.  A frozen hole keeps
    its row-shaped outputs through the segment vector; empty hole slots
    (no real rows) start frozen.  ``device_only`` as _refine_loop's."""
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
            iters, ts, tlens, nrows == 0,
            _Rows((qs.shape[0],), lambda f: f.index_select(0, seg),
                  qs.device), max_ins, device_only)
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


def _slab_wire_specs(R: int, qmax: int, H: int, tmax: int) -> list:
    """(shape, dtype) of _pack_slab_args's two buffers."""
    return [((R * qmax + H * tmax,), torch.uint8),
            ((3 * R + H,), torch.int32)]


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
                        pack: tuple, impl: str = "",
                        device_only: bool = False):
    """The slab step at pack=(R, qmax): the two wire buffers (already on the
    device) in, ONE uint8 buffer out — the hole-shaped outputs, then the
    int32 (bp, dlen, ovf, advance) as bytes — so the result comes back in
    one copy (_unpack_slab_refine splits it).  ``device_only`` as
    _refine_loop's (the form a CUDA graph captures)."""
    R, qmax = pack
    core = _refine_core_packed(params, max_ins, tmax, iters, nseg,
                               bp_consts, impl, device_only)

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
        aligned, ins_cnt, ins_b, lead_ins = mesh_mod.block_rows(
            fill, qs, qlens, draft, dlen, tmax, max_ins)
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
                 bp_consts: tuple, impl: str = "", device_only: bool = False):
    """A window's whole refinement loop (_refine_loop) over a bucketed
    group, with the packed core's rules per hole; holes without a real pass
    start frozen.

    core(qs, qlens, ts, tlens, row_mask) (the shapes of _round_core) ->
    (cons, ins_base, ins_votes, ncov, nwin, bp, advance, dlen, ovf), as
    the JAX package's ``_refine_step`` core returns them.  ``device_only``
    as _refine_loop's."""
    one_round = _round_body(params, max_ins, tmax, impl)
    bp_advance = bp_mod.make_bp_advance(tmax, *bp_consts)
    mat = msa.make_materializer(tmax, tmax, max_ins)

    def core(qs, qlens, ts, tlens, row_mask):
        outs, dlen, ovf = _refine_loop(
            lambda d, dl: one_round(qs, qlens, row_mask, d, dl), mat, iters,
            ts, tlens, ~row_mask.any(dim=1),
            _Rows(qs.shape[:2], lambda f: f, qs.device), max_ins,
            device_only)
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
                 bp_consts: tuple, pack: tuple, impl: str = "",
                 device_only: bool = False):
    """The bucketed refinement step (_refine_core) at pack=(P, qmax), as
    _round_step; its output also carries dlen and ovf (_unpack_refine)."""
    core = _refine_core(params, max_ins, tmax, iters, bp_consts, impl,
                        device_only)
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


def _mesh_step(mesh, params: AlignParams, max_ins: int, tmax: int,
               iters: int, bp_consts: tuple, impl: str, args,
               refine: bool, device_only: bool) -> "mesh_mod.Placed":
    """A bucketed group's step over a (data, pass) mesh (--mesh D,P): the
    counterpart of the JAX package's GSPMD-sharded ``_refine_step`` /
    ``_round_step``, run eagerly (no CUDA graph).

    ``args`` are the host (qs, qlens, ts, tlens, row_mask) of Z holes, Z a
    multiple of the data dimension D.  Data shard d takes holes [d·Z/D,
    (d+1)·Z/D); its pass entries split the P passes when the pass dimension
    divides P, else its first entry takes them all (the pass axis
    replicated).  Each shard runs _refine_loop on its first entry (the
    lead), whose rounds are parallel/mesh.shard_round: every entry fills
    and walks its block on its own stream and the vote counts are summed on
    the lead.  Each entry keeps and freezes its own rows through the loop;
    the breakpoint scan runs on the lead over the rows gathered once after
    it.  A refine step (``refine``) freezes holes without a real pass from
    the start and runs ``iters`` speculative rounds; a bare round is the
    loop's final round alone.  The shards' outputs are _refine_step's or
    _round_step's rows, joined by the read."""
    qs, qlens, ts, tlens, row_mask = args
    D, pass_dim = mesh.shape
    Z, P = qs.shape[:2]
    Pe = mesh_mod.split_passes(P, pass_dim)
    Zd, Pb = Z // D, P // Pe
    fill = global_fill(params, impl)
    mat = msa.make_materializer(tmax, tmax, max_ins)
    bp_advance = bp_mod.make_bp_advance(tmax, *bp_consts)

    def round_of(shard, blocks):
        def one(draft, dlen):
            holes, per = mesh_mod.shard_round(shard, blocks, draft, dlen,
                                              fill, tmax, max_ins)
            return holes + tuple(list(x) for x in zip(*per))
        return one

    parts, leads = [], []
    for d in range(D):
        shard = list(mesh.entries[d, :Pe])
        lead = shard[0]
        hs = slice(d * Zd, (d + 1) * Zd)
        blocks = mesh_mod.place_blocks(shard, [
            (qs[hs, p * Pb:(p + 1) * Pb], qlens[hs, p * Pb:(p + 1) * Pb],
             row_mask[hs, p * Pb:(p + 1) * Pb]) for p in range(Pe)])
        draft, dlen, rm = mesh_mod.place_blocks(
            [lead], [(ts[hs], tlens[hs], row_mask[hs])])[0]
        with mesh_mod.scope(lead):
            fixed = ~rm.any(dim=1) if refine else torch.zeros_like(rm[:, 0])
            rows = _ShardRows(shard, blocks)
            outs, dlen, ovf = _refine_loop(
                round_of(shard, blocks), mat, iters if refine else 0,
                draft, dlen, fixed, rows, max_ins, device_only)
            cons, ins_base, ins_votes, ncov, nwin = outs[:5]
            match, aligned, ins_cnt, lead_ins = rows.gather(outs[5:])
            bp, advance = bp_advance(match, cons, aligned, ins_cnt,
                                     lead_ins, rm, dlen)
            parts.append(_pack_out(
                (cons, ins_base, ins_votes.to(torch.uint8),
                 ncov.to(torch.uint8), nwin.to(torch.uint8)),
                (bp, advance, dlen, ovf) if refine else (bp, advance)))
        leads.append(lead)
    return mesh_mod.Placed(parts, leads, np.concatenate)


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
                 device="cuda", metrics: Optional[RunMetrics] = None,
                 prefilter: bool = True, seed_device_min_t: int = 16384,
                 resil=None):
        self.params = params
        self.quant = quant
        self.device = torch.device(device)
        self.metrics = metrics if metrics is not None else RunMetrics()
        # the run's Resilience (pipeline/resilience.py), shared with the
        # BatchExecutor: pair fills strike the refine steps' breaker
        self._resil = resil
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
        groups = self._groups(pairs, idxs)

        def label(key):
            return f"sketch:q{key[0]}:t{key[1]}"

        def dispatch(gidxs, key):
            args = self._pad_pair(pairs, gidxs, key)
            faultinject.fire("device_oom")
            self.metrics.bump(screen_steps=1)
            with trace.device_span("sketch_screen", group=label(key),
                                   shape=f"N{len(gidxs)}",
                                   n=len(gidxs)) as sp:
                faultinject.fire("stall")
                faultinject.fire("device_hang")
                return sp.force(sketch.screen_step(*key)(*args))

        def finish(gidxs, key, out):
            for z, i in enumerate(gidxs):
                triples[i] = tuple(int(v) for v in out[z])

        def host_one(i):
            return sketch.screen_host(pairs[i].q, pairs[i].t)

        self.metrics.bump(device_dispatches=len(groups))
        _run_groups_recovering(groups, dispatch, finish, host_one, triples,
                               self.metrics, label=label,
                               resil=self._resil)
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
        groups = self._groups(pairs, idxs)

        def label(key):
            return f"seed:q{key[0]}:t{key[1]}"

        def dispatch(gidxs, key):
            args = self._pad_pair(pairs, gidxs, key)
            faultinject.fire("device_oom")
            self.metrics.bump(seed_steps=1)
            with trace.device_span("seed_device", group=label(key),
                                   shape=f"N{len(gidxs)}",
                                   n=len(gidxs)) as sp:
                faultinject.fire("stall")
                faultinject.fire("device_hang")
                return sp.force(seed_device.seed_step(*key)(*args))

        def finish(gidxs, key, out):
            for z, i in enumerate(gidxs):
                rows[i] = [int(v) for v in out[z]]

        def host_one(i):
            hit = seed.seed_diagonal(pairs[i].q, pairs[i].t)
            if hit is None:
                return [0] * 8
            return [1, hit.diag, hit.votes, *(int(v) for v in hit.line), 0]

        self.metrics.bump(device_dispatches=len(groups))
        _run_groups_recovering(groups, dispatch, finish, host_one, rows,
                               self.metrics, label=label,
                               resil=self._resil)
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
            with trace.span("prefilter", cat="prep", n=len(screen_ids)):
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
        # dp_cells_padded counts the N rows dispatched; the JAX package pads
        # N to a power of two (_z_bucket), the port does not
        padded = real = 0
        for (qmax, tmax), idxs in groups.items():
            padded += len(idxs) * qmax * band
            real += band * sum(len(pairs[i].q) for i in idxs)
        self.metrics.bump(pair_fills=len(groups), pair_alignments=len(lines),
                          device_dispatches=len(groups),
                          pairs_seeded_device=len(dev_ids),
                          pairs_seeded_host=len(host_ids),
                          pairs_screened=screened,
                          pairs_prefiltered=rejected,
                          dp_cells_padded=padded, dp_cells_real=real)

        def label(key):
            return f"pair:q{key[0]}:t{key[1]}"

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
            faultinject.fire("device_oom")
            step = _pair_fill_packed(self.params, qmax, tmax, self.device)
            N = len(idxs)
            with trace.device_span("pair_fill", group=label(key),
                                   cells=N * qmax * band, shape=f"N{N}",
                                   n=N) as sp:
                faultinject.fire("stall")
                faultinject.fire("device_hang")
                return sp.force(step(big, small))

        def finish(idxs, key, res):
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
                               self.metrics, label=label,
                               resil=self._resil)
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
    the per-hole round, on the same device.

    More than one device (``devices``, default utils/device.local_devices;
    the JAX package's rules): packed, each WAVE of a group carries D
    consecutive slabs of its plan at the wave's largest canonical height
    and slab j runs on device j's refine program and stream (the fused
    dispatch, one span and one dispatch a wave); under --mesh D,P the
    bucketed groups run over a (data, pass) mesh instead (_mesh_step:
    holes split over data, passes over pass), packing off.  A single
    device ignores --mesh.  A device may be listed more than once: each
    entry is a logical device with its own stream (parallel/mesh.py).

    Each refine step goes through the program cache (graphs.dispatch: on
    the card a shape's first slab runs eagerly, its second captures the
    shape's CUDA graph, the rest replay it), or its program is built ahead
    of its first dispatch by the warmup plane (``warmup``, a
    WarmupCompiler): ``warm_refine`` predicts each packed group's
    canonical slab heights at admission, ``_warm_sweep_shapes`` submits a
    sweep's exact shapes before its dispatches, and each dispatch waits
    for its shape's build first (``_warm_wait``).  Bare rounds run
    eagerly."""

    # OOM resplit ladder: three halvings before the per-request replay
    max_oom_resplits = 3
    oom_backoff_s = 0.05

    def __init__(self, cfg: CcsConfig, device="cuda",
                 metrics: Optional[RunMetrics] = None, warmup=None,
                 resil=None, devices=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.metrics = metrics if metrics is not None else RunMetrics()
        # the run's Resilience (pipeline/resilience.py): the dispatch
        # deadline and the circuit breaker; None = neither
        self._resil = resil
        self.len_quant = cfg.len_bucket_quant
        # the JAX package's arm name, for the trace groups' :b<impl> and
        # banded_dispatches, so both packages' group tables line up:
        # 'scan' (the default) and 'pallas' launch the band-local kernel
        # (csrc/banded_fill.cu), 'rotband' the rotating-band kernel
        # (csrc/banded_rotband.cu)
        self.bimpl = cfg.banded_impl or "scan"
        self._sm = StarMsa(cfg.align, cfg.max_ins_per_col,
                           cfg.len_bucket_quant, self.device,
                           cfg.banded_impl)
        self.slab_rows = pack_mod.pow2(max(1, cfg.slab_rows))
        self.slab_ladder = max(1, int(cfg.slab_shape_ladder))
        # this host's devices only: the ranks of a sharded run share
        # nothing, so each one's mesh spans its own cards
        self._devices = (list(devices) if devices is not None
                         else device_mod.local_devices(self.device))
        n_dev = len(self._devices)
        # the JAX package's rule: an explicit --mesh selects the bucketed
        # (Z, P) layout (packed slab rows cross hole boundaries, which the
        # (data, pass) split cannot express); a single device ignores
        # --mesh, so packing stays on there
        self.packing = bool(cfg.pass_packing) and (
            cfg.mesh_shape is None or n_dev == 1)
        self._slab_mesh = None
        self._mesh = None
        if self.packing and n_dev > 1:
            self._slab_mesh = mesh_mod.build_slab_mesh(self._devices)
        if cfg.pass_packing and cfg.mesh_shape is not None and n_dev > 1:
            print("[ccsx-tpu-torch] pass packing disabled under --mesh "
                  "(bucketed (Z, P) grouping carries the shardings)",
                  file=sys.stderr)
        if n_dev > 1 and not self.packing:
            # (data, pass) mesh: holes split over 'data', each hole's
            # passes over 'pass' when the pass bucket divides; a 1-tuple
            # means pure data parallelism; extra devices idle
            shape = self.validate_mesh(cfg.mesh_shape, n_dev)
            self._mesh = mesh_mod.build_mesh(
                shape, devices=self._devices[:int(np.prod(shape))])
            self._data_dim, self._pass_dim = shape
            if (self._pass_dim > 1
                    and all(b % self._pass_dim for b in cfg.pass_buckets)):
                print(f"[ccsx-tpu-torch] mesh pass dim {self._pass_dim} "
                      f"divides no pass bucket {tuple(cfg.pass_buckets)}: "
                      "pass axis will be replicated (no pass parallelism)",
                      file=sys.stderr)
        elif cfg.mesh_shape is not None:
            print("[ccsx-tpu-torch] --mesh ignored: single device visible",
                  file=sys.stderr)
        # the warmup plane (pipeline/warmup.py); None without --warmup
        self._warmup = warmup
        self._shape_seen: set = set()  # distinct packed (R, q, t, i) shapes
        # warm_refine's prediction per (qmax, tmax, iters) group: (rows
        # accumulated, predicted R, its warm key), each hole counted once
        # per group (_group_holes)
        self._group_pred: Dict[tuple, tuple] = {}
        self._group_holes: Dict[tuple, set] = {}
        # what the steps' closures take from cfg, in every program key
        # (with the step's factory, which a caller may replace)
        self._cfg_key = graphs.config_key(cfg, self.device)

    @staticmethod
    def normalize_mesh_shape(shape, n_dev: int):
        if shape is None:
            return (n_dev, 1)
        shape = tuple(int(x) for x in shape)
        if len(shape) == 1:
            shape = (shape[0], 1)
        if len(shape) != 2:
            raise ValueError(f"mesh_shape must be (data,) or (data, pass), "
                             f"got {shape}")
        if min(shape) < 1:
            raise ValueError(f"mesh dims must be >= 1: {shape}")
        return shape

    @classmethod
    def validate_mesh(cls, mesh_shape, n_dev: int):
        """Normalize and check a mesh shape; ValueError on a bad one.  The
        one validation point: __init__ and mesh_precheck (before any output
        file opens) call it.  A single device ignores the mesh, so only
        n_dev > 1 can be too few."""
        shape = cls.normalize_mesh_shape(mesh_shape, n_dev)
        need = int(np.prod(shape))
        if n_dev > 1 and need > n_dev:
            raise ValueError(
                f"mesh {shape} needs {need} devices, host has {n_dev}")
        return shape

    def _round_z(self, n: int) -> int:
        """A bucketed group's Z: its holes (the port pads no power of two),
        rounded up to a multiple of the mesh's data dimension; the pad
        holes have no real pass, so a refine step freezes them at once."""
        if self._mesh is None:
            return n
        return -(-n // self._data_dim) * self._data_dim

    def _count_cells(self, reqs, idxs, P, qmax, Z, iters: int = 1):
        """Padding accounting of a bucketed group (metrics.dp_cells_*):
        real DP fill cells (true qlen of real pass-rows) against dispatched
        cells (the Z x P x qmax x band x iters block), and the round-only
        counters in cell units, as the JAX package's _count_cells."""
        band = self.cfg.align.band
        padded = Z * P * qmax * band * iters
        real = band * iters * int(
            sum(int(reqs[i].qlens[reqs[i].row_mask].sum()) for i in idxs))
        rows_real = int(sum(int(reqs[i].row_mask.sum()) for i in idxs))
        scale = qmax * band * iters
        self.metrics.bump(dp_cells_padded=padded, dp_cells_real=real,
                          dp_round_cells_padded=padded,
                          dp_round_cells_real=real,
                          dp_rowcells_real=rows_real * scale,
                          dp_rowcells_cap=len(idxs) * P * scale)

    def _count_cells_packed_fused(self, reqs, idxs, qmax: int, iters: int,
                                  R: int, n_slabs: int, n_slots: int):
        """Padding accounting of one fused wave (n_slabs real slabs at
        height R over n_slots device slots), as the JAX package's
        _count_cells_packed_fused: dispatched cells count the real slabs
        only, the idle slots show in fused_slot_fill."""
        band = self.cfg.align.band
        scale = qmax * band * iters
        rows_real = int(sum(int(reqs[i].row_mask.sum()) for i in idxs))
        real = band * iters * int(
            sum(int(reqs[i].qlens[reqs[i].row_mask].sum()) for i in idxs))
        padded = n_slabs * R * scale
        self.metrics.bump(dp_cells_padded=padded, dp_cells_real=real,
                          dp_round_cells_padded=padded,
                          dp_round_cells_real=real,
                          dp_rowcells_real=rows_real * scale,
                          dp_rowcells_cap=n_slabs * R * scale,
                          dp_rows_real=rows_real,
                          dp_rows_dispatched=n_slabs * R,
                          packed_dispatches=1, packed_holes=len(idxs),
                          fused_waves=1, fused_slabs_real=n_slabs,
                          fused_slots=n_slots)

    def _count_cells_packed(self, reqs, idxs, qmax: int, R: int,
                            iters: int):
        """Padding accounting of one packed slab (no Z axis: its z_fill is
        1 and the row fill carries the story), as the JAX package's
        _count_cells_packed."""
        band = self.cfg.align.band
        scale = qmax * band * iters
        rows_real = int(sum(int(reqs[i].row_mask.sum()) for i in idxs))
        real = band * iters * int(
            sum(int(reqs[i].qlens[reqs[i].row_mask].sum()) for i in idxs))
        self.metrics.bump(dp_cells_padded=R * scale, dp_cells_real=real,
                          dp_round_cells_padded=R * scale,
                          dp_round_cells_real=real,
                          dp_rowcells_real=rows_real * scale,
                          dp_rowcells_cap=R * scale,
                          dp_rows_real=rows_real, dp_rows_dispatched=R,
                          packed_dispatches=1, packed_holes=len(idxs))

    def _bp_consts(self):
        cfg = self.cfg
        return (cfg.bp_window, cfg.bp_minwin, cfg.bp_rowrate,
                cfg.bp_colrate, cfg.bp_colrate_lowpass)

    # ---- the refine programs (pipeline/graphs.py) and their warmup
    # ---- (pipeline/warmup.py): predict and capture the canonical packed
    # ---- programs concurrently with ingest/prep

    def _warm_key(self, qmax, tmax, iters, R, H):
        # a fused executor's builds are its D lanes' programs
        dstack = len(self._devices) if self._slab_mesh is not None else 1
        return ("refine_packed", qmax, tmax, iters, R, H, self.bimpl, dstack)

    def _packed_spec(self, qmax, tmax, iters, R, H, lane=0) -> tuple:
        """(key, step factory, input specs) of the packed refine step at
        one slab shape (the device-only loop on the card), for
        graphs.program and graphs.dispatch; ``lane`` > 0 is a fused wave's
        logical device (its own programs, pool and stream)."""
        cfg = self.cfg
        cuda = self.device.type == "cuda"
        return (self._warm_key(qmax, tmax, iters, R, H) + self._cfg_key
                + (_refine_step_packed,) + ((lane,) if lane else ()),
                lambda: _refine_step_packed(
                    cfg.align, cfg.max_ins_per_col, tmax, iters, H,
                    self._bp_consts(), (R, qmax), cfg.banded_impl,
                    device_only=cuda),
                _slab_wire_specs(R, qmax, H, tmax))

    def _packed_program(self, qmax, tmax, iters, R, H) -> graphs.Program:
        """The packed refine step's program at one slab shape, built (and
        primed) on first request: the warmup plane's."""
        return graphs.program(*self._packed_spec(qmax, tmax, iters, R, H),
                              self.device)

    def _bucketed_spec(self, P, qmax, tmax, iters, Z) -> tuple:
        """As _packed_spec, for the bucketed refine step at one (P, qmax,
        tmax, iters, Z) group (the JAX package's warm_refine does not
        predict bucketed groups either)."""
        cfg = self.cfg
        cuda = self.device.type == "cuda"
        width = P * qmax + tmax + 4 * (2 * P + 1)    # _pack_args's row
        return (("refine", P, qmax, tmax, iters, Z, self.bimpl)
                + self._cfg_key + (_refine_step,),
                lambda: _refine_step(cfg.align, cfg.max_ins_per_col, tmax,
                                     iters, self._bp_consts(), (P, qmax),
                                     cfg.banded_impl, device_only=cuda),
                [((Z, width), torch.uint8)])

    def _bucketed_program(self, P, qmax, tmax, iters, Z) -> graphs.Program:
        return graphs.program(*self._bucketed_spec(P, qmax, tmax, iters, Z),
                              self.device)

    def _warm_wait(self, key) -> None:
        """Dispatch-side sync: wait for this shape's warmup, queued or
        running (WarmupCompiler.promote: a queued one jumps the queue).
        The JAX package's dispatch claims a queued warmup back and
        compiles inline; here the dispatch would run the shape eagerly
        and capture at its next slab, and a plane that runs at all owns
        every capture it predicted.  The builder's finally guarantees
        the wait ends."""
        if self._warmup is not None:
            self._warmup.promote(key)

    def _note_shape(self, R, qmax, tmax, iters) -> None:
        key = (R, qmax, tmax, iters)
        if key not in self._shape_seen:
            self._shape_seen.add(key)
            self.metrics.distinct_slab_shapes = len(self._shape_seen)

    def _submit_warm(self, qmax, tmax, iters, R, urgent=False) -> tuple:
        H = max(1, R // pack_mod.SEG_DIV)
        key = self._warm_key(qmax, tmax, iters, R, H)
        self._warmup.submit(key, functools.partial(
            self._warm_build, qmax, tmax, iters, R, H), urgent=urgent)
        return key

    def warm_refine(self, req: RefineRequest, hole_id=None) -> None:
        """Queue the capture of the program this request's (qmax, tmax,
        iters) group is predicted to need, the moment prep yields the
        request, so captures overlap ingest/prep instead of stalling the
        group's first dispatch.

        The predicted R is the smallest canonical height covering the
        group's ACCUMULATED predicted rows (capped at the budget, the
        steady-state shape); when accumulation pushes the prediction up a
        height, the stale queued warm is cancelled (WarmupCompiler.claim).
        Each hole counts once per group (the driver re-warms every active
        hole after every sweep).  A group that fills its row budget will
        dribble through the lower canonical heights at its end, so those
        are queued too.  Under the fused multi-device dispatch a build is
        every logical device's program of the shape (_warm_build).  A
        no-op without a warmup compiler and under --pass-buckets (its Z is
        the sweep's, unknowable at admission)."""
        if self._warmup is None or not self.packing:
            return
        qmax = req.qs.shape[1]
        tmax = _fused_tmax(len(req.draft), self.len_quant)
        gk = (qmax, tmax, req.iters)
        rows = max(int(req.row_mask.sum()), pack_mod.SEG_DIV)
        acc, old_r, old_key = self._group_pred.get(gk, (0, None, None))
        if hole_id is not None:
            seen = self._group_holes.setdefault(gk, set())
            if hole_id in seen:
                return
            seen.add(hole_id)
        acc = min(acc + rows, self.slab_rows)
        heights = pack_mod.canonical_heights(self.slab_rows,
                                             self.slab_ladder)
        R = self.slab_rows
        for h in heights:
            if h >= acc:
                R = h
            else:
                break
        key = old_key
        if R != old_r:
            if old_key is not None:
                self._warmup.claim(old_key)  # cancel the stale warm
            key = self._submit_warm(qmax, tmax, req.iters, R)
        if acc >= self.slab_rows:
            for h in heights:
                if h != R:
                    self._submit_warm(qmax, tmax, req.iters, h)
        self._group_pred[gk] = (acc, R, key)

    def _warm_sweep_shapes(self, shapes) -> None:
        """Sweep-time exact warming: a sweep's slab shapes are known before
        its dispatches, so any not yet built is submitted ``urgent`` (no
        debounce) and captured while earlier slabs dispatch; a shape whose
        capture has not started when its own dispatch arrives jumps the
        queue and is waited for (_warm_wait)."""
        if self._warmup is None:
            return
        for qmax, tmax, iters, R in sorted(shapes):
            self._submit_warm(qmax, tmax, iters, R, urgent=True)

    def _warm_build(self, qmax, tmax, iters, R, H) -> None:
        """Warmup-thread builder: build the program (on its all-zero slab:
        every segment starts frozen) and replay it once, waited for.  The
        warmup=True span carries the dispatch span's group and shape, so
        it books the shape's one compile and the first real dispatch books
        as execute.  Under the fused dispatch it builds and warms the
        shape's program on every logical device, each on its own stream
        and in its own lane (a wave's slab j runs entry j's)."""
        fused = self._slab_mesh is not None
        entries = self._slab_mesh.flat if fused else []
        with trace.device_span(  # lint: ok[span-force] warm() synchronises
                "warmup", group=f"packed:q{qmax}:t{tmax}:i{iters}"
                                f":b{self.bimpl}",
                shape=(f"D{len(entries)}:" if fused else "") + f"R{R}:S{H}",
                warmup=True):
            if not fused:
                self._packed_program(qmax, tmax, iters, R, H).warm()
            for e in entries:
                with mesh_mod.scope(e):
                    graphs.program(*self._packed_spec(
                        qmax, tmax, iters, R, H, lane=e.index + 1),
                        e.device, lane=e.index + 1).warm()

    def _stack_slab(self, reqs, idxs, qmax, tmax, shape=None):
        """Pack the real pass-rows of the given requests into ONE slab:
        (R, qmax) rows + (H, tmax) per-hole drafts + the row->hole segment
        vector, rows in idxs order (the packing plan's placement order).
        ``shape`` forces (R, H): a fused wave stacks every slab at the
        wave's height."""
        rows = [int(reqs[i].row_mask.sum()) for i in idxs]
        R, H = shape if shape is not None else pack_mod.slab_shape(
            rows, self.slab_rows, ladder=self.slab_ladder)
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

    def _stack_group(self, reqs, idxs, P, qmax, tmax, Z=None):
        """Stack a bucketed group's requests into (Z, P) step inputs, Z =
        len(idxs) unless given (a mesh's _round_z; the pad holes have no
        pass): each request keeps its own P pass rows (pad passes
        included) and its draft padded to tmax.  Unlike the JAX package
        (_z_bucket), Z is not padded to a power of two: the port compiles
        nothing per shape."""
        Z = len(idxs) if Z is None else Z
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
        group (over the (data, pass) mesh under --mesh)."""
        cfg = self.cfg
        M = cfg.max_ins_per_col
        groups: Dict[tuple, List[int]] = defaultdict(list)
        for i, req in enumerate(requests):
            P, qmax = req.qs.shape
            groups[(P, qmax, bucket_len(len(req.draft), self.len_quant))
                   ].append(i)
        results: List[object] = [None] * len(requests)
        # bare rounds count as dispatches only ('windows' counts refines)
        self.metrics.bump(round_groups=len(groups),
                          device_dispatches=len(groups))
        for (P, qmax, _), idxs in groups.items():
            self._count_cells(requests, idxs, P, qmax,
                              self._round_z(len(idxs)))
        pin = self.device.type == "cuda"

        def label(key):
            return f"round:P{key[0]}:q{key[1]}:t{key[2]}:b{self.bimpl}"

        def dispatch(idxs, key):
            P, qmax, tmax = key
            Z = self._round_z(len(idxs))
            args = self._stack_group(requests, idxs, P, qmax, tmax, Z)
            faultinject.fire("device_oom")
            self.metrics.bump(bucketed_dispatches=1)
            self.metrics.bump_banded(self.bimpl)
            with trace.device_span(
                    "round", group=label(key),
                    cells=Z * P * qmax * cfg.align.band, shape=f"Z{Z}",
                    n=len(idxs), Z=Z) as sp:
                faultinject.fire("stall")
                faultinject.fire("device_hang")
                if self._mesh is not None:
                    return sp.force(_mesh_step(
                        self._mesh, cfg.align, M, tmax, 0,
                        self._bp_consts(), cfg.banded_impl, args,
                        refine=False, device_only=pin))
                step = _round_step(cfg.align, M, tmax, self._bp_consts(),
                                   (P, qmax), cfg.banded_impl)
                buf = _pack_args(args, pin=pin)
                return sp.force(step(buf.to(self.device, non_blocking=pin)))

        def finish(idxs, key, out):
            cons, ins_base, ins_votes, ncov, nwin, bp, advance = \
                _unpack_round(out, M, key[2])
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
                               self.metrics, self.max_oom_resplits,
                               self.oom_backoff_s, label, resil=self._resil)
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
        self.metrics.bump(windows=len(requests), bucketed_groups=len(groups),
                          device_dispatches=len(groups))
        for (P, qmax, _, iters), idxs in groups.items():
            self._count_cells(requests, idxs, P, qmax,
                              self._round_z(len(idxs)), iters)
        pin = self.device.type == "cuda"

        def label(key):
            return (f"refine:P{key[0]}:q{key[1]}:t{key[2]}:i{key[3]}"
                    f":b{self.bimpl}")

        def host_one(i):
            req = requests[i]
            return refine_host(self._sm.round, req.qs, req.qlens,
                               req.row_mask, req.draft, req.iters)

        def dispatch(idxs, key):
            P, qmax, tmax, iters = key
            Z = self._round_z(len(idxs))
            args = self._stack_group(requests, idxs, P, qmax, tmax, Z)
            faultinject.fire("device_oom")
            self.metrics.bump(bucketed_dispatches=1)
            self.metrics.bump_banded(self.bimpl)
            with trace.device_span(
                    "refine", group=label(key),
                    cells=Z * P * qmax * cfg.align.band * iters,
                    shape=f"Z{Z}", n=len(idxs), Z=Z) as sp:
                faultinject.fire("stall")
                faultinject.fire("device_hang")
                if self._mesh is not None:
                    # eager on the mesh: one loop per data shard, each on
                    # its lead entry's stream
                    return sp.force(_mesh_step(
                        self._mesh, cfg.align, M, tmax, iters,
                        self._bp_consts(), cfg.banded_impl, args,
                        refine=True, device_only=pin))
                buf = _pack_args(args, pin=pin)
                return sp.force(graphs.dispatch(
                    *self._bucketed_spec(P, qmax, tmax, iters, Z),
                    self.device, buf))

        def finish(idxs, key, out):
            (cons, ins_base, ins_votes, ncov, nwin, bp, advance, dlen,
             ovf) = _unpack_refine(out, M, key[2])
            for z, i in enumerate(idxs):
                if ovf[z]:
                    self.metrics.bump(refine_overflows=1)
                    _replay(i, host_one, results, reason="refine_overflow")
                    continue
                results[i] = RefineResult(rr=RoundResult(
                    cons=cons[z], ins_base=ins_base[z],
                    ins_votes=ins_votes[z], ncov=ncov[z], nwin=nwin[z],
                    tlen=int(dlen[z]), bp=int(bp[z]), advance=advance[z]))

        _run_groups_recovering(groups, dispatch, finish, host_one, results,
                               self.metrics, self.max_oom_resplits,
                               self.oom_backoff_s, label, resil=self._resil)
        return results

    def _run_refine_packed(self, requests: List[RefineRequest]) -> list:
        """The packed branch of _run_refine: one step a slab, or with more
        than one device one fused dispatch a wave of D slabs (slab j on
        logical device j % D, its own refine programs and stream)."""
        cfg = self.cfg
        M = cfg.max_ins_per_col
        results: List[object] = [None] * len(requests)
        self.metrics.bump(windows=len(requests))

        def host_one(i):
            req = requests[i]
            return refine_host(self._sm.round, req.qs, req.qlens,
                               req.row_mask, req.draft, req.iters)

        fused = self._slab_mesh is not None
        D = len(self._devices)

        def plan_wave(idxs):
            """(plan, R, H) of a wave's holes, derived again by dispatch
            and finish, so OOM-bisected halves stay self-consistent: every
            slab of a wave at the wave's largest canonical height."""
            rows = [nrows[i] for i in idxs]
            plan = pack_mod.plan_slabs(rows, self.slab_rows)
            R = max(pack_mod.slab_shape([rows[j] for j in s],
                                        self.slab_rows,
                                        ladder=self.slab_ladder)[0]
                    for s in plan)
            return plan, R, max(1, R // pack_mod.SEG_DIV)

        # the sweep's grouping and slab plan, in one span
        with trace.span("plan", cat="compute", n=len(requests)):
            nrows = [int(r.row_mask.sum()) for r in requests]
            shape_groups: Dict[tuple, List[int]] = defaultdict(list)
            for i, req in enumerate(requests):
                if nrows[i] == 0:
                    # no live pass-rows (the windowed driver never makes
                    # one): nothing to pack, the per-hole path is its spec
                    self.metrics.bump(host_fallbacks=1)
                    _replay(i, host_one, results, reason="no_rows")
                    continue
                tmax = _fused_tmax(len(req.draft), self.len_quant)
                shape_groups[(req.qs.shape[1], tmax, req.iters)].append(i)

            groups: Dict[tuple, List[int]] = {}
            sweep_shapes = set()
            n_slabs = 0
            for key, idxs in shape_groups.items():
                slabs = pack_mod.plan_slabs([nrows[i] for i in idxs],
                                            self.slab_rows)
                n_slabs += len(slabs)
                if fused:
                    for w in range(0, len(slabs), D):
                        chunk = slabs[w:w + D]
                        wave = [idxs[j] for s in chunk for j in s]
                        groups[key + (w // D,)] = wave
                        _, R, _ = plan_wave(wave)
                        sweep_shapes.add(key + (R,))
                        self._count_cells_packed_fused(
                            requests, wave, key[0], key[2], R, len(chunk),
                            D)
                    continue
                for s_no, slab in enumerate(slabs):
                    sl_idxs = [idxs[j] for j in slab]
                    groups[key + (s_no,)] = sl_idxs
                    R, _ = pack_mod.slab_shape([nrows[i] for i in sl_idxs],
                                               self.slab_rows,
                                               ladder=self.slab_ladder)
                    sweep_shapes.add(key + (R,))
                    self._count_cells_packed(requests, sl_idxs, key[0], R,
                                             key[2])
            self._warm_sweep_shapes(sweep_shapes)
            self.metrics.bump(slabs=n_slabs, device_dispatches=len(groups))
        pin = self.device.type == "cuda"

        def label(key):
            # the shape group, without the slab or wave ordinal key[3]
            return f"packed:q{key[0]}:t{key[1]}:i{key[2]}:b{self.bimpl}"

        def dispatch(idxs, key):
            qmax, tmax, iters, _ = key
            faultinject.fire("device_oom")
            if fused:
                return dispatch_wave(idxs, key)
            with trace.span("slab_pack", cat="compute", n=len(idxs)):
                args = self._stack_slab(requests, idxs, qmax, tmax)
                R, H = args[0].shape[0], args[4].shape[0]
                big, small = _pack_slab_args(args, pin=pin)
            self._warm_wait(self._warm_key(qmax, tmax, iters, R, H))
            self._note_shape(R, qmax, tmax, iters)
            self.metrics.bump_banded(self.bimpl)
            with trace.device_span(
                    "refine_packed", group=label(key),
                    cells=R * qmax * cfg.align.band * iters,
                    shape=f"R{R}:S{H}",
                    plan={"slab": key[3], "rows": R,
                          "holes": len(idxs)}) as sp:
                faultinject.fire("stall")
                faultinject.fire("device_hang")
                return sp.force(graphs.dispatch(
                    *self._packed_spec(qmax, tmax, iters, R, H),
                    self.device, big, small))

        def dispatch_wave(idxs, key):
            qmax, tmax, iters, _ = key
            plan, R, H = plan_wave(idxs)
            # an OOM re-plan may hold more than D slabs: K a device then
            # (the span's shape, as the JAX package's stacked dimension)
            K = -(-len(plan) // D)
            with trace.span("slab_pack", cat="compute", n=len(idxs)):
                slabs = [_pack_slab_args(self._stack_slab(
                    requests, [idxs[j] for j in s], qmax, tmax,
                    shape=(R, H)), pin=pin) for s in plan]
            self._note_shape(R, qmax, tmax, iters)
            self.metrics.bump_banded(self.bimpl)
            entries = self._slab_mesh.flat
            self._warm_wait(self._warm_key(qmax, tmax, iters, R, H))
            with trace.device_span(
                    "refine_packed", group=label(key),
                    cells=len(plan) * R * qmax * cfg.align.band * iters,
                    shape=f"D{K * D}:R{R}:S{H}",
                    plan={"wave": key[3], "slabs": len(plan), "chips": D,
                          "rows": R, "holes": len(idxs)}) as sp:
                faultinject.fire("stall")
                faultinject.fire("device_hang")
                parts, used = [], []
                for j, (big, small) in enumerate(slabs):
                    # a tail wave leaves its last devices idle: no dummy
                    # slab is launched
                    e = entries[j % D]
                    with mesh_mod.scope(e):
                        parts.append(graphs.dispatch(
                            *self._packed_spec(qmax, tmax, iters, R, H,
                                               lane=e.index + 1),
                            e.device, big, small, lane=e.index + 1))
                    used.append(e)
                return sp.force(mesh_mod.Placed(parts, used))

        def finish_slab(sl_idxs, tmax, out, R, H):
            (cons, ins_base, ins_votes, ncov, nwin, bp, advance, dlen,
             ovf) = _unpack_slab_refine(out, M, tmax, H, R)
            r0 = 0
            for s, i in enumerate(sl_idxs):
                req = requests[i]
                rows = slice(r0, r0 + nrows[i])
                r0 += nrows[i]
                if ovf[s]:
                    self.metrics.bump(refine_overflows=1)
                    _replay(i, host_one, results, reason="refine_overflow")
                    continue
                # row advances back into the request's (P,) pass order;
                # masked pass rows consumed nothing
                adv = np.zeros(req.qs.shape[0], np.int32)
                adv[req.row_mask] = advance[rows]
                results[i] = RefineResult(rr=RoundResult(
                    cons=cons[s], ins_base=ins_base[s],
                    ins_votes=ins_votes[s], ncov=ncov[s], nwin=nwin[s],
                    tlen=int(dlen[s]), bp=int(bp[s]), advance=adv))

        def finish(idxs, key, out):
            tmax = key[1]
            with trace.span("unpack", cat="compute", n=len(idxs)):
                if not fused:
                    R, H = pack_mod.slab_shape([nrows[i] for i in idxs],
                                               self.slab_rows,
                                               ladder=self.slab_ladder)
                    finish_slab(idxs, tmax, out, R, H)
                    return
                plan, R, H = plan_wave(idxs)
                for s, o in zip(plan, out):
                    finish_slab([idxs[j] for j in s], tmax, o, R, H)

        _run_groups_recovering(groups, dispatch, finish, host_one, results,
                               self.metrics, self.max_oom_resplits,
                               self.oom_backoff_s, label, resil=self._resil)
        return results


# ---- the driver -------------------------------------------------------------

@dataclasses.dataclass
class _Hole:
    idx: int
    zmw: object
    gen: object = None         # consensus generator (None => skipped)
    req: object = None         # pending PairRequest | PairBatch | RefineRequest
    done: bool = False
    resumed: bool = False      # written by an earlier run: skip, no journal
    cns: Optional[tuple] = None  # (seq_bytes, qual_bytes|None)
    err: Optional[Exception] = None


def _finish(result):
    """Generator result -> (seq_bytes, qual|None) or None (skipped)."""
    return enc.to_record(result)


def _start_hole(hole: _Hole, cfg: CcsConfig) -> None:
    """Start the combined prep+consensus generator (first step only)."""
    try:
        faultinject.fire("compute")
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
                  metrics: RunMetrics, journal: Journal,
                  inflight: Optional[int] = None, admission=None,
                  warm=None, devices=None) -> None:
    """The batched scheduler over an open ZMW stream and writer.

    Admits holes into a window, runs one pair sweep and one refine sweep
    over every pending request per loop, and writes finished holes in
    input order.  ``inflight`` pins the admission window; None (or <= 0)
    selects the adaptive window: it starts at cfg.zmw_microbatch /
    chunk_growth^2 and grows by chunk_growth per filled admission round up
    to cfg.zmw_microbatch.  Holes in flight plus holes waiting for ordered
    emission stay within 4x the cap.

    Host prep runs on the background prep plane (pipeline/prep_pool.py)
    unless cfg.prep_threads == 0: ingest, the orientation walk and its
    pair alignments happen on pool threads concurrently with this loop's
    refine sweeps, and the driver only pays ``t_prep_blocked`` when it has
    nothing dispatchable.  Output bytes, ordered emission and the journal
    invariant are the same either way (tests/test_torch_prep_pool.py).

    With cfg.warmup_compile (the port's CLI sets it on the card only with
    --warmup: no run measured so far had the plane paying for itself), a
    WarmupCompiler (pipeline/warmup.py) captures each packed group's
    predicted refine programs on a background thread: every hole is warmed
    at admission and again after each sweep (its next window may fall in
    another group), as the JAX driver does.

    A writer with ``put_at(idx, name, seq, qual)`` (a sharded rank's)
    gets each record with its hole's index in ``stream``; others get
    ``put``.

    ``devices`` are the refine executor's logical devices (default: this
    host's, utils/device.local_devices); the strand walk's pair fills run
    on ``device`` alone, as the JAX package's PairExecutor is not sharded.

    Under the serving plane (pipeline/serve.py) a job passes the server's
    ``warm`` (a WarmupCompiler that lives as long as the server: used, not
    closed here) and its ``admission`` handle on the server's fair window
    (serve.JobAdmission): a slot is acquired for each admitted hole and
    released when the hole finishes computing (before emission), so jobs
    running at once split the device window instead of stacking windows;
    whatever the exit path, the job's slots are given back at the end.

    Counters, stage timers and progress events go into ``metrics``; the
    spans into the installed tracer (the caller's, utils/trace.py).  The
    first ``journal.holes_done`` holes were written by an earlier run: they
    are marked done at admission and launch nothing; every other retired
    hole advances the journal.  The caller's stream stops at a drain
    (run.guarded_stream), and in-flight holes then finish.  A kernel or
    card fault raises cuda_ext.KernelError out of here (from the pool's
    threads too, at the driver's next poll), and a count-form
    --max-failed-holes exceeded at a failed hole raises
    FailureBudgetExceeded."""
    from ccsx_tpu_torch.pipeline.prep_pool import (PrepPool,
                                                   resolve_prep_threads)

    explicit_window = inflight is not None and int(inflight) > 0
    cap = max(1, int(inflight) if explicit_window
              else int(cfg.zmw_microbatch))
    growth = max(2, int(cfg.chunk_growth))
    window = cap if explicit_window else max(1, cap // (growth * growth))
    # with the prep pool, a hole is written only once the stream has been
    # read the first window past it (PrepPool.emit_ok): a stream error
    # then leaves the same holes written in every run, none of them when
    # it falls in the first window, as on the inline path
    emit_lead = window
    n_prep = resolve_prep_threads(cfg)
    # the warmup plane: as soon as prep yields a hole's first
    # RefineRequest, its group's canonical programs are captured on this
    # background thread, concurrently with ingest/prep (a server's plane
    # outlives the job: never closed here)
    own_warm = warm is None
    if warm is None and cfg.warmup_compile:
        from ccsx_tpu_torch.pipeline.warmup import WarmupCompiler

        warm = WarmupCompiler()
    # one dispatch deadline and circuit breaker (pipeline/resilience.py)
    # for both executors and the prep pool's pump, so pair fills and
    # refine steps strike one breaker; a served job builds its own from its
    # config, so a tenant that wedges the card trips only its own
    resil = resil_mod.Resilience(cfg, metrics=metrics)
    executor = BatchExecutor(cfg, device, metrics, warmup=warm, resil=resil,
                             devices=devices)
    pair_executor = PairExecutor(cfg.align, quant=cfg.len_bucket_quant,
                                 device=device, metrics=metrics,
                                 prefilter=cfg.prefilter,
                                 seed_device_min_t=cfg.seed_device_min_t,
                                 resil=resil)

    def warm_hole(h) -> None:
        if warm is not None and isinstance(h.req, RefineRequest):
            executor.warm_refine(h.req, hole_id=h.idx)
    resume = journal.holes_done
    # a sharded rank's writer (parallel/distributed.ShardWriter) takes each
    # record with its hole's index in this stream, the merge's key
    put_at = getattr(writer, "put_at", None)
    active: List[_Hole] = []
    finished: Dict[int, _Hole] = {}
    next_idx = 0       # next hole index to admit (inline prep)
    next_emit = 0      # next hole index to write
    exhausted = False
    pool = None        # PrepPool, constructed inside the try below

    def emit_ready():
        """Write the finished holes that are next in input order, in one
        ``emit`` span."""
        if next_emit in finished:
            with trace.span("emit", cat="write"):
                write_ready()

    def write_ready():
        nonlocal next_emit
        while next_emit in finished:
            if pool is not None and not pool.emit_ok(next_emit, emit_lead):
                break
            h = finished.pop(next_emit)
            if h.resumed:
                next_emit += 1
                if pool is not None:
                    pool.release()
                continue
            wrote = False
            if h.err is not None:
                metrics.holes_failed += 1
                print(f"[ccsx-tpu-torch] hole {h.zmw.movie}/{h.zmw.hole} "
                      f"failed: {h.err}", file=sys.stderr)
                # a count budget aborts here, a fraction at end of run
                check_failure_budget(metrics, cfg)
            elif h.cns is not None and h.cns[0]:
                name = f"{h.zmw.movie}/{h.zmw.hole}/ccs"
                with metrics.timer("write"), \
                        trace.span("write_record", cat="write"):
                    if put_at is not None:
                        put_at(h.idx, name, *h.cns)
                    else:
                        writer.put(name, *h.cns)
                metrics.holes_out += 1
                wrote = True
            # flush-before-cursor + write fault point + advance
            journal.retire(writer, wrote, metrics)
            # rank_death: a hard kill at a retirement point, leaving a
            # valid journal and durable records behind; sigterm: a real
            # signal at the same point, the drain made deterministic
            faultinject.fire("rank_death")
            faultinject.fire("sigterm")
            metrics.tick()
            next_emit += 1
            if pool is not None:
                pool.release()  # free one slot of ingest-ahead budget

    adm = admission

    def admit(h):
        if h.done:
            finished[h.idx] = h
            if adm is not None:
                adm.release()  # never computed: free the slot at once
        else:
            warm_hole(h)
            active.append(h)

    try:
        if n_prep > 0:
            # the overlapped prep plane: ingest and the orientation walk
            # move to background threads (constructed after the caller's
            # tracer, so its spans record, and inside the try, so its
            # threads cannot outlive the finally)
            pool = PrepPool(stream, cfg, pair_executor, metrics,
                            threads=n_prep, max_outstanding=4 * cap,
                            resume=resume)
        while True:
            if pool is not None:
                # drain whatever prep has finished, up to the window —
                # never blocking here: with device work pending, the
                # sweep must run while prep keeps working in background
                with trace.span("admit", cat="host"):
                    while len(active) < window:
                        if adm is not None and not adm.try_acquire():
                            break  # at fair share; sweep what we hold
                        h = pool.poll()
                        if h is None:
                            if adm is not None:
                                adm.release()  # nothing arrived for it
                            break
                        admit(h)
            else:
                # inline prep (--prep-threads 0): admit up to the window
                denied = False
                with trace.span("admit", cat="host"):
                    while (not exhausted and len(active) < window
                           and next_idx - next_emit < 4 * cap):
                        if adm is not None and not adm.try_acquire():
                            denied = True
                            break  # at fair share; sweep what we hold
                        try:
                            with metrics.timer("ingest"), \
                                    trace.span("ingest_hole", cat="ingest"):
                                z = next(stream)
                                faultinject.fire("ingest")
                        except StopIteration:
                            if adm is not None:
                                adm.release()
                            exhausted = True
                            break
                        metrics.holes_in += 1
                        h = _Hole(idx=next_idx, zmw=z)
                        next_idx += 1
                        if metrics.holes_in <= resume:
                            h.done = h.resumed = True
                        else:
                            # inline prep is all critical path: its own
                            # stage and blocked
                            with metrics.timer("prep"), \
                                    metrics.timer("prep_blocked"), \
                                    trace.span("prep_hole", cat="prep",
                                               hole=str(z.hole)):
                                _start_hole(h, cfg)
                        admit(h)
            admitted_full = len(active) >= window
            emit_ready()
            if not active:
                if pool is None:
                    if exhausted:
                        break
                    if denied:
                        # no slot and nothing in flight: wait for a
                        # sibling job's release instead of spinning
                        adm.wait(0.2)
                    continue
                if pool.drained():
                    # the stream's end opens the emission gate: write
                    # the rest, or raise its error
                    emit_ready()
                    pool.emit_ok(next_emit, emit_lead)
                    break
                # nothing dispatchable: the driver is blocked on prep.
                # Accumulate while prep keeps delivering (sweeping the
                # first hole the instant it appears would fragment the
                # sweep into near-empty slabs); the moment prep pauses
                # with work in hand, or the window fills, sweep it
                with trace.span("admit", cat="host"):
                    while len(active) < window and not pool.drained():
                        if adm is not None and not adm.try_acquire():
                            # at fair share while another job wants the
                            # window: wait on the admission condition (a
                            # release anywhere re-checks), not on the pool
                            adm.wait(0.05 if active else 0.2)
                            emit_ready()
                            if active:
                                break
                            metrics.heartbeat()
                            continue
                        # only the wait itself books as blocked — emission
                        # has its own stage
                        with metrics.timer("prep_blocked"):
                            h = pool.get(timeout=0.05 if active else 1.0)
                        # emit as we accumulate: instantly-done holes
                        # (resumed/skipped) must retire here to keep releasing
                        # ingest budget, or a done stretch longer than the 4x
                        # bound live-locks against the pool
                        emit_ready()
                        if h is None:
                            if adm is not None:
                                adm.release()
                            if active:
                                break
                            metrics.heartbeat()
                            continue
                        admit(h)
                # a window filled while blocked still earns growth
                admitted_full = len(active) >= window
                metrics.heartbeat()
                if not active:
                    continue
            # one batched sweep over every pending request, split by kind
            is_pair = [isinstance(h.req, (prep_mod.PairRequest,
                                          prep_mod.PairBatch))
                       for h in active]
            pair_holes = [h for h, p in zip(active, is_pair) if p]
            round_holes = [h for h, p in zip(active, is_pair) if not p]
            if pair_holes:
                # inline prep only in practice (the pool finishes the walk
                # before handing a hole over); it blocks the driver
                with metrics.timer("prep"), metrics.timer("prep_blocked"), \
                        trace.span("pair_sweep", cat="prep",
                                   n=len(pair_holes)):
                    for h, r in zip(pair_holes, pair_executor.run(
                            [h.req for h in pair_holes])):
                        _feed_hole(h, r)
            if round_holes:
                with metrics.timer("compute"), \
                        trace.span("refine_sweep", cat="compute",
                                   n=len(round_holes)):
                    results = executor.run([h.req for h in round_holes])
                    # the generators' vote epilogue and next-window draft
                    with trace.span("hole_step", cat="compute",
                                    n=len(round_holes)):
                        for h, rr in zip(round_holes, results):
                            _feed_hole(h, rr)
            still: List[_Hole] = []
            for h in active:
                if h.done:
                    finished[h.idx] = h
                    if adm is not None:
                        # finished computing: free the slot before
                        # emission (which can lag on an out-of-order tail)
                        # so a sibling job's denied admission unblocks now
                        adm.release()
                else:
                    # a sweep can grow a hole's draft into a fresh (qmax,
                    # tmax) group: predict its next window's shapes
                    warm_hole(h)
                    still.append(h)
            active = still
            emit_ready()
            if not explicit_window and admitted_full and window < cap:
                window = _grow_window(window, cap, growth)
            # interval-driven progress events while nothing has retired yet
            metrics.heartbeat()
    finally:
        # give back this job's admission slots whatever the exit path: a
        # failed job must not strand capacity the fair window still counts
        # against its share
        if adm is not None:
            adm.reset()
        # stop the prep plane before the caller closes the tracer (its
        # workers and pump write prep spans and metrics): an error path
        # may leave holes in prep — dropped, the caller's rc says why
        if pool is not None:
            pool.close()
        # then the warmup thread (queued captures dropped, a running one
        # finishes), before the caller closes the tracer: no warmup span
        # outlives the trace file
        if warm is not None and own_warm:
            warm.close()


def mesh_precheck(cfg: CcsConfig, device) -> int:
    """0 when cfg.mesh_shape is feasible (or unset) on this host's devices
    for ``device``; 1 after an "invalid --mesh" message.  run.run_pipeline
    calls it for every batched run, a sharded rank's and a fleet range's
    included, before any output file opens."""
    if cfg.mesh_shape is None:
        return 0
    try:
        BatchExecutor.validate_mesh(cfg.mesh_shape,
                                    len(device_mod.local_devices(device)))
    except ValueError as e:
        print(f"Error: invalid --mesh: {e}", file=sys.stderr)
        return 1
    return 0
