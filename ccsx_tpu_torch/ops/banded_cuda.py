"""Wrappers of the hand-written banded DP fill kernels (csrc/banded_fill.cu).

``batched_align_global_moves`` replaces the JAX package's Pallas kernel
(ops/banded_pallas.py ``_kernel_g``, through its ``_batched_align_impl``);
``batched_align_local`` has no Pallas original (its reference is the lax
scan of ops/banded.py in local mode).  On CPU tensors each takes its plain
PyTorch version in ops/banded.py; on CUDA tensors it launches its kernel or
raises.  The kernels hold band 128 and maxshift 4 (the defaults every
caller uses) and have no cap on the query length.

The lengths stay on the card: a wrapper does not read them back to check
them (that would stall every round).  Each kernel clamps a length to
[0, its padded width], so no input reads or writes out of bounds; callers
keep the lengths in range (``StarMsa.round`` checks them on the host).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.ops import banded, cuda_ext

BAND = 128
MAXSHIFT = 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = cuda_ext.library("banded_fill")
    if not getattr(lib, "_ccsx_bound", False):
        lib.ccsx_banded_global.argtypes = [
            _P, _I, _P, _P, _L, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P]
        lib.ccsx_banded_global.restype = _I
        lib.ccsx_banded_local.argtypes = [
            _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _P]
        lib.ccsx_banded_local.restype = _I
        lib.ccsx_banded_global_warps.argtypes = [
            _P, _I, _P, _P, _L, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P]
        lib.ccsx_banded_global_warps.restype = _I
        lib.ccsx_banded_local_warps.argtypes = [
            _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P]
        lib.ccsx_banded_local_warps.restype = _I
        lib._ccsx_bound = True
    return lib


def validate(what, qs, qlens, ts, tlens, band, maxshift):
    """Refuse (cuda_ext.RefusedInputs) what the fill kernels cannot take."""
    refuse = cuda_ext.RefusedInputs
    if (band or BAND) != BAND or maxshift != MAXSHIFT:
        raise refuse(f"{what}: the kernel holds band={BAND}, "
                     f"maxshift={MAXSHIFT}")
    if qs.dtype != torch.uint8 or ts.dtype != torch.uint8:
        raise refuse(f"{what}: qs and ts must be uint8")
    if qlens.dtype != torch.int32 or tlens.dtype != torch.int32:
        raise refuse(f"{what}: qlens and tlens must be int32")
    cuda_ext.require_cuda(what, qs, qlens, ts, tlens)
    n = qs.shape[0]
    if (qs.dim() != 2 or ts.dim() != 2 or ts.shape[0] != n
            or qlens.shape != (n,) or tlens.shape != (n,)):
        raise refuse(f"{what}: expected qs (n, qmax), ts (n, tmax), "
                     "qlens (n,), tlens (n,)")
    if not qs.is_contiguous() or not qlens.is_contiguous() \
            or not tlens.is_contiguous():
        raise refuse(f"{what}: qs, qlens, tlens must be contiguous")


def batched_align_global_moves(qs: torch.Tensor, qlens: torch.Tensor,
                               ts: torch.Tensor, tlens: torch.Tensor,
                               params: AlignParams = AlignParams(),
                               band: Optional[int] = None, maxshift: int = 4):
    """Global fill with move bytes: (score (n,) int32, moves (n, qmax, 128)
    uint8, offs (n, qmax) int32).  ``ts`` may broadcast one template over
    the batch (stride 0 on its first dimension)."""
    if qs.device.type == "cpu":
        res, moves, offs = banded.banded_global_moves(
            qs, qlens, ts, tlens, params, band, maxshift)
        return res.score, moves, offs
    what = "banded global fill"
    validate(what, qs, qlens, ts, tlens, band, maxshift)
    n, qmax = qs.shape
    dev = qs.device
    moves = torch.empty((n, qmax, BAND), dtype=torch.uint8, device=dev)
    offs = torch.empty((n, qmax), dtype=torch.int32, device=dev)
    score = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.ccsx_banded_global(
                qs.data_ptr(), qmax, qlens.data_ptr(), ts.data_ptr(),
                ts.stride(0), ts.shape[1], tlens.data_ptr(),
                params.match, params.mismatch, params.gap_open,
                params.gap_extend,
                moves.data_ptr(), offs.data_ptr(), score.data_ptr(), n,
                cuda_ext.stream_ptr(dev))
        cuda_ext.check(lib, rc, what)
        cuda_ext.count("banded_global")
    return score, moves, offs


def batched_align_local(qs: torch.Tensor, qlens: torch.Tensor,
                        ts: torch.Tensor, tlens: torch.Tensor,
                        lines: Optional[torch.Tensor] = None,
                        params: AlignParams = AlignParams(),
                        band: Optional[int] = None,
                        maxshift: int = 4) -> banded.BandedResult:
    """Local fill with path statistics: the seven BandedResult fields,
    each (n,) int32.  ``lines`` (n, 4) int32, None for the corners."""
    if qs.device.type == "cpu":
        return banded.banded_local(qs, qlens, ts, tlens, lines, params,
                                   band, maxshift)
    what = "banded local fill"
    validate(what, qs, qlens, ts, tlens, band, maxshift)
    if not ts.is_contiguous():
        raise cuda_ext.RefusedInputs(f"{what}: ts must be contiguous")
    if lines is None:
        lines = banded.corner_lines(qlens, tlens)
    if (lines.dtype != torch.int32 or lines.shape != (qs.shape[0], 4)
            or not lines.is_contiguous()):
        raise cuda_ext.RefusedInputs(
            f"{what}: lines must be contiguous (n, 4) int32")
    cuda_ext.require_cuda(what, qs, lines)
    n, qmax = qs.shape
    out = torch.empty((7, n), dtype=torch.int32, device=qs.device)
    if n:
        lib = _lib()
        with torch.cuda.device(qs.device):
            rc = lib.ccsx_banded_local(
                qs.data_ptr(), qmax, qlens.data_ptr(), ts.data_ptr(),
                ts.shape[1], tlens.data_ptr(), lines.data_ptr(),
                params.match, params.mismatch, params.gap_open,
                params.gap_extend,
                out.data_ptr(), n, cuda_ext.stream_ptr(qs.device))
        cuda_ext.check(lib, rc, what)
        cuda_ext.count("banded_local")
    return banded.BandedResult(*out.unbind(0))


def launch_variant(qs: torch.Tensor, qlens: torch.Tensor, ts: torch.Tensor,
                   tlens: torch.Tensor, warps: int,
                   lines: Optional[torch.Tensor] = None,
                   params: AlignParams = AlignParams()):
    """One launch of a fill kernel with ``warps`` problems per block: the
    global fill when ``lines`` is None, else the local fill.  For timing the
    kernels' launch choice on CUDA tensors the wrappers above have checked;
    it counts no launch (it is no part of the main path) and returns the
    output buffers."""
    n, qmax = qs.shape
    dev = qs.device
    p = (params.match, params.mismatch, params.gap_open, params.gap_extend)
    lib = _lib()
    if lines is None:
        what = "banded global fill"
        out = (torch.empty((n,), dtype=torch.int32, device=dev),
               torch.empty((n, qmax, BAND), dtype=torch.uint8, device=dev),
               torch.empty((n, qmax), dtype=torch.int32, device=dev))
        rc = lib.ccsx_banded_global_warps(
            qs.data_ptr(), qmax, qlens.data_ptr(), ts.data_ptr(),
            ts.stride(0), ts.shape[1], tlens.data_ptr(), *p,
            out[1].data_ptr(), out[2].data_ptr(), out[0].data_ptr(), n, warps,
            cuda_ext.stream_ptr(dev))
    else:
        what = "banded local fill"
        out = torch.empty((7, n), dtype=torch.int32, device=dev)
        rc = lib.ccsx_banded_local_warps(
            qs.data_ptr(), qmax, qlens.data_ptr(), ts.data_ptr(), ts.shape[1],
            tlens.data_ptr(), lines.data_ptr(), *p, out.data_ptr(), n, warps,
            cuda_ext.stream_ptr(dev))
    cuda_ext.check(lib, rc, what)
    return out
