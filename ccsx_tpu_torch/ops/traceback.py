"""Traceback walk: move matrix -> star-MSA projection.

Converts the packed move bytes of the global fill into the
template-anchored projection the column vote consumes:

  aligned[j]   query code aligned to template column j (0-3), 4 = deletion
  ins_cnt[j]   number of query bases inserted after template column j
  ins_b[j, r]  the last ``max_ins`` inserted bases after column j, in
               forward order, left-justified (PAD=5 elsewhere)
  lead_ins     query bases consumed before template column 0

The walk goes cell by cell from (qlen, tlen) back to (0, 0), the JAX
package's ``make_projector_reference`` (its default projector), with qlen
clamped to [0, qmax] and tlen to [0, tmax].  On CUDA tensors ``project``
launches csrc/traceback_walk.cu (a row-level chain over a shared-memory
ring of move rows; its source note says how it stays exact); on CPU
tensors it runs ``project_plain``, the same walk in Python.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ccsx_tpu_torch.ops import cuda_ext
from ccsx_tpu_torch.ops.banded import EBIT_EXT, FBIT_EXT, MOVE_UP

GAP = 4
PAD = 5

_H, _E, _F = 0, 1, 2


def _walk_one(mv, of, q, qlen, tlen, max_ins, aligned, ins_cnt, ins_b):
    """One pass's walk into its (tmax,) / (tmax+1,) / (tmax+1, R) rows;
    slot s+1 of ins_* holds the insertions after column s, slot 0 the
    leading ones (right-aligned here, left-justified by the caller)."""
    qmax, B = mv.shape
    i, j, state = qlen, tlen, _H
    while i > 0 or j > 0:
        row = min(max(i - 1, 0), qmax - 1)
        lane = min(max(j - int(of[row]), 0), B - 1)
        m = int(mv[row, lane])
        if j == 0 and i > 0:
            op = 1
        elif i == 0 and j > 0:
            op = 2
        elif state == _E:
            op = 1
        elif state == _F:
            op = 2
        else:
            choice = m & 3
            op = 0 if choice == 0 else (1 if choice == MOVE_UP else 2)
        if op == 0:
            aligned[j - 1] = q[i - 1]
            i, j, state = i - 1, j - 1, _H
        elif op == 1:
            # one query base inserted after column j-1 (slot j; 0 = leading)
            pos = max_ins - 1 - ins_cnt[j]
            if pos >= 0:
                ins_b[j, pos] = q[i - 1]
            ins_cnt[j] += 1
            state = _E if (m & EBIT_EXT) or j == 0 else _H
            i -= 1
        else:
            aligned[j - 1] = GAP
            state = _F if (m & FBIT_EXT) or i == 0 else _H
            j -= 1


def project_plain(moves: torch.Tensor, offs: torch.Tensor, qs: torch.Tensor,
                  qlens: torch.Tensor, tlens: torch.Tensor, tmax: int,
                  max_ins: int = 4):
    """The walk over a batch of passes (plain version, on the host), with
    each qlen clamped to [0, qmax] and each tlen to [0, tmax].  Returns (aligned (P, tmax) uint8, ins_cnt (P, tmax) int32,
    ins_b (P, tmax, max_ins) uint8, lead_ins (P,) int32) on moves' device."""
    mv = moves.cpu().numpy()
    of = offs.cpu().numpy()
    q = qs.cpu().numpy()
    ql = qlens.cpu().numpy()
    tl = tlens.cpu().numpy()
    P = mv.shape[0]
    aligned = np.full((P, tmax), PAD, np.uint8)
    ins_cnt = np.zeros((P, tmax + 1), np.int32)
    ins_b = np.full((P, tmax + 1, max_ins), PAD, np.uint8)
    qmax = mv.shape[1]
    for p in range(P):
        _walk_one(mv[p], of[p], q[p], min(max(int(ql[p]), 0), qmax),
                  min(max(int(tl[p]), 0), tmax), max_ins,
                  aligned[p], ins_cnt[p], ins_b[p])
    # left-justify the right-aligned insertion cells
    used = np.minimum(ins_cnt, max_ins)
    cols = np.arange(max_ins)[None, None, :] + (max_ins - used)[:, :, None]
    ins_b = np.take_along_axis(ins_b, np.clip(cols, 0, max_ins - 1), axis=2)
    ins_b = np.where(np.arange(max_ins)[None, None, :] < used[:, :, None],
                     ins_b, PAD).astype(np.uint8)
    dev = moves.device
    return (torch.from_numpy(aligned).to(dev),
            torch.from_numpy(np.ascontiguousarray(ins_cnt[:, 1:])).to(dev),
            torch.from_numpy(np.ascontiguousarray(ins_b[:, 1:])).to(dev),
            torch.from_numpy(ins_cnt[:, 0].copy()).to(dev))


def _lib():
    lib = cuda_ext.library("traceback_walk")
    if not getattr(lib, "_ccsx_bound", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.ccsx_traceback_walk.argtypes = [
            P, P, P, I, P, P, I, I, P, P, P, P, I, P]
        lib.ccsx_traceback_walk.restype = I
        lib.ccsx_traceback_walk_variant.argtypes = [
            P, P, P, I, P, P, I, I, P, P, P, P, I, I, I, I, P]
        lib.ccsx_traceback_walk_variant.restype = I
        lib._ccsx_bound = True
    return lib


def project(moves: torch.Tensor, offs: torch.Tensor, qs: torch.Tensor,
            qlens: torch.Tensor, tlens: torch.Tensor, tmax: int,
            max_ins: int = 4):
    """The walk over a batch of passes: the kernel on CUDA tensors, the
    plain version on CPU tensors.  Same outputs as ``project_plain``.  Both
    clamp qlens to [0, qmax] and tlens to [0, tmax]; they are not read back
    to be checked."""
    if moves.device.type == "cpu":
        return project_plain(moves, offs, qs, qlens, tlens, tmax, max_ins)
    what = "traceback walk"
    cuda_ext.require_cuda(what, moves, offs, qs, qlens, tlens)
    P, qmax, B = moves.shape
    if (moves.dtype != torch.uint8 or qs.dtype != torch.uint8
            or offs.dtype != torch.int32 or qlens.dtype != torch.int32
            or tlens.dtype != torch.int32):
        raise cuda_ext.RefusedInputs(
            f"{what}: expected uint8 moves/qs and int32 offs/qlens/tlens")
    if (B != 128 or qmax < 1 or offs.shape != (P, qmax) or qs.shape != (P, qmax)
            or qlens.shape != (P,) or tlens.shape != (P,)):
        raise cuda_ext.RefusedInputs(
            f"{what}: expected moves (P, qmax, 128), offs and qs (P, qmax), "
            "qlens and tlens (P,)")
    if not all(x.is_contiguous() for x in (moves, offs, qs, qlens, tlens)):
        raise cuda_ext.RefusedInputs(f"{what}: inputs must be contiguous")
    if not 1 <= max_ins <= 16:
        raise cuda_ext.RefusedInputs(
            f"{what}: max_ins must be in [1, 16]")
    dev = moves.device
    aligned = torch.empty((P, tmax), dtype=torch.uint8, device=dev)
    ins_cnt = torch.empty((P, tmax), dtype=torch.int32, device=dev)
    ins_b = torch.empty((P, tmax, max_ins), dtype=torch.uint8, device=dev)
    lead = torch.empty((P,), dtype=torch.int32, device=dev)
    if P:
        lib = _lib()
        # the launcher's lazy shared-memory attribute (`static bool attr`,
        # csrc/traceback_walk.cu) is set without a lock.  In the batched
        # driver the walk launches from the refine programs' builds
        # (pipeline/graphs.py: one build at a time, on the driver or the
        # warmup thread; the priming run sets the attribute before any
        # capture) and from the driver thread's per-request replays, whose
        # first launch can meet a build's only with the attribute's same
        # value; the prep pool's pump launches only the local fill and the
        # seed and screen steps
        with torch.cuda.device(dev):
            rc = lib.ccsx_traceback_walk(
                moves.data_ptr(), offs.data_ptr(), qs.data_ptr(), qmax,
                qlens.data_ptr(), tlens.data_ptr(), tmax, max_ins,
                aligned.data_ptr(), ins_cnt.data_ptr(), ins_b.data_ptr(),
                lead.data_ptr(), P, cuda_ext.stream_ptr(dev))
        cuda_ext.check(lib, rc, what)
        cuda_ext.count("traceback_walk")
    return aligned, ins_cnt, ins_b, lead


def launch_variant(moves: torch.Tensor, offs: torch.Tensor, qs: torch.Tensor,
                   qlens: torch.Tensor, tlens: torch.Tensor, tmax: int,
                   max_ins: int, rows: int, stages: int, threads: int):
    """One launch of the walk kernel with a chosen ring (``rows`` per stage,
    32 or 64; ``stages``, 2, 4 or 8; ``threads`` per block, 96 or 128), for
    timing the launch choice on CUDA tensors that ``project`` takes.  It
    counts no launch (it is no part of the main path) and returns the
    outputs."""
    P, qmax, _ = moves.shape
    dev = moves.device
    out = (torch.empty((P, tmax), dtype=torch.uint8, device=dev),
           torch.empty((P, tmax), dtype=torch.int32, device=dev),
           torch.empty((P, tmax, max_ins), dtype=torch.uint8, device=dev),
           torch.empty((P,), dtype=torch.int32, device=dev))
    lib = _lib()
    rc = lib.ccsx_traceback_walk_variant(
        moves.data_ptr(), offs.data_ptr(), qs.data_ptr(), qmax,
        qlens.data_ptr(), tlens.data_ptr(), tmax, max_ins,
        *(x.data_ptr() for x in out), P, rows, stages, threads,
        cuda_ext.stream_ptr(dev))
    cuda_ext.check(lib, rc, "traceback walk")
    return out
