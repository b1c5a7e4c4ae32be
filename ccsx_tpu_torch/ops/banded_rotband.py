"""The rotating-band global fill: plain PyTorch version and the wrapper of
its hand-written kernel (csrc/banded_rotband.cu).

Same function as ops/banded_cuda.batched_align_global_moves (score, move
bytes in the band-local layout, band offsets; bit-identical to it), in the
JAX package's second layout (ops/banded_rotband.py ``_kernel_rot``): lane k
holds the template column j with j = k (mod B) for the whole fill, so the
carried H and E never move when the band advances.  With ``OFF`` the row's
band offset and ``d`` its advance over the previous row:

  krel = (k - OFF) & (B-1)     lane k's position inside the band
  j    = OFF + krel            the column lane k holds at this row

* the vertical predecessor (H_up, E_up) is the lane's own previous value,
  NEG where krel >= B - d (the lane was just recycled for a new column);
* the diagonal predecessor is lane k-1's previous H (cyclic), NEG where
  krel > B - d or (krel == 0 and d == 0);
* the horizontal gap F is a max-plus prefix scan in krel order, exclusive
  by one (NEG at krel 0);
* the move byte of lane k belongs to band position krel: writing it there
  un-rotates the moves into the band-local layout every consumer reads;
* the final score is column tlen's H, in lane tlen & (B-1), masked by
  reachability (0 <= tlen - OFF < B).

The kernel (csrc/banded_rotband.cu) runs one warp per problem: its lane L
keeps the H and E of lanes k = 4L..4L+3 above in registers, where they
never move; F is an in-lane prefix in krel order plus a shuffle scan of the
lane totals in band order; the template word and the move row change
layout with two shuffles and one byte permute each, the move row stored as
one coalesced 128-byte row.

``batched_align_global_moves`` takes the plain version for CPU tensors,
launches the kernel for CUDA tensors and raises for any other device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.ops import banded, banded_cuda, cuda_ext
from ccsx_tpu_torch.ops.banded import (
    EBIT_EXT, FBIT_EXT, MOVE_DIAG, MOVE_LEFT, MOVE_UP, NEG)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def rotband_global_moves(qs: torch.Tensor, qlens: torch.Tensor,
                         ts: torch.Tensor, tlens: torch.Tensor,
                         params: AlignParams = AlignParams(),
                         band: Optional[int] = None, maxshift: int = 4):
    """The plain version: a row loop over the rotated (n, B) carry with
    ``torch.roll`` and the krel masks, then the un-rotate gather.

    qs (n, qmax) uint8, qlens (n,), ts (n, tmax) uint8, tlens (n,).
    Returns (score (n,) int32, moves (n, qmax, B) uint8, offs (n, qmax)
    int32); moves of rows beyond a problem's qlen are zero and its offsets
    there stay at the last live row's."""
    banded._check(qs, qlens, ts, tlens)
    B = band if band is not None else params.band
    if B & (B - 1):
        raise ValueError(f"the rotating band needs a power-of-two band, "
                         f"got {B}")
    M, X = params.match, params.mismatch
    O, E = params.gap_open, params.gap_extend
    n, qmax = qs.shape
    dev = qs.device
    bd = banded._Band(qs, ts, B, maxshift)
    k = bd.k
    qlen = qlens.long()
    tlen = tlens.long()
    tlen32 = tlens.to(torch.int32)[:, None]
    tcap = torch.clamp(tlen - B + 1, min=0)
    line = (torch.zeros_like(qlen), torch.zeros_like(qlen), qlen, tlen)

    def roll1(x):
        return torch.roll(x, 1, dims=1)       # out[:, k] = x[:, k-1], cyclic

    # row 0 (OFF = 0, so lane k holds column k)
    H = torch.where(k[None, :] <= tlen32,
                    torch.where(k == 0, 0, O + E * k)[None, :].expand(n, B),
                    NEG).to(torch.int32)
    Ev = torch.full((n, B), NEG, dtype=torch.int32, device=dev)
    off_prev = torch.zeros(n, dtype=torch.int64, device=dev)
    rot = torch.zeros((n, qmax, B), dtype=torch.uint8, device=dev)
    offs = torch.zeros((n, qmax), dtype=torch.int32, device=dev)
    rows = int(qlen.max()) if n else 0
    for i in range(1, rows + 1):
        live = i <= qlen
        off = banded._offset(i, off_prev, qlen, tcap, line, B, maxshift,
                             local=False)
        d = (off - off_prev).to(torch.int32)[:, None]
        krel = (k[None, :] - off.to(torch.int32)[:, None]) & (B - 1)
        j = off.to(torch.int32)[:, None] + krel
        tb = torch.gather(bd.tpad, 1, j.long())
        qi = bd.q[:, i - 1][:, None]
        sub = torch.where((qi == tb) & (qi < 4) & (tb < 4), M, X)

        up_bad = krel >= B - d
        diag_bad = (krel > B - d) | ((krel == 0) & (d == 0))
        H_up = torch.where(up_bad, NEG, H)
        E_up = torch.where(up_bad, NEG, Ev)
        Hd_diag = torch.where(diag_bad, NEG, roll1(H))

        e_ext = E_up + E
        e_open = H_up + (O + E)
        e_is_open = e_open >= e_ext
        Enew = torch.maximum(e_ext, e_open)
        diag_term = Hd_diag + sub
        d_wins = diag_term >= Enew
        Hd = torch.maximum(diag_term, Enew)
        at0 = j == 0
        Hd = torch.where(at0, O + E * i, Hd)
        Enew = torch.where(at0, O + E * i, Enew)
        invalid = j > tlen32
        Hd = torch.where(invalid, NEG, Hd)
        Enew = torch.where(invalid, NEG, Enew)

        # F: Hillis-Steele max scan in krel order (roll by step, NEG where
        # krel < step), then exclusive by one
        v = Hd + O - E * krel
        step = 1
        while step < B:
            v = torch.maximum(v, torch.where(krel < step, NEG,
                                             torch.roll(v, step, dims=1)))
            step *= 2
        F = torch.where(krel < 1, NEG, roll1(v)) + E * krel
        hd_wins = Hd >= F
        Hnew = torch.maximum(Hd, F)

        choice = torch.where(hd_wins & d_wins, MOVE_DIAG,
                             torch.where(hd_wins, MOVE_UP, MOVE_LEFT))
        ebit = torch.where(e_is_open, 0, EBIT_EXT)
        H_left = torch.where(krel < 1, NEG, roll1(Hnew))
        fbit = torch.where(F == H_left + (O + E), 0, FBIT_EXT)
        mv = (choice | ebit | fbit).to(torch.uint8)

        lv = live[:, None]
        rot[:, i - 1] = torch.where(lv, mv, 0)
        off_prev = torch.where(live, off, off_prev)
        offs[:, i - 1] = off_prev.to(torch.int32)
        H = torch.where(lv, Hnew, H)
        Ev = torch.where(lv, Enew, Ev)
    if rows < qmax:
        offs[:, rows:] = off_prev.to(torch.int32)[:, None]

    # un-rotate: band position kk of row i is column offs[i] + kk, which
    # lives in lane (offs[i] + kk) & (B-1)
    idx = (offs[:, :, None].long() + bd.k64[None, None, :]) & (B - 1)
    moves = torch.gather(rot, 2, idx)
    laneT = tlen - off_prev
    reachable = (laneT >= 0) & (laneT < B)
    score = torch.where(reachable,
                        torch.gather(H, 1, (tlen & (B - 1))[:, None])[:, 0],
                        NEG)
    return score.to(torch.int32), moves, offs


def _lib():
    lib = cuda_ext.library("banded_rotband")
    if not getattr(lib, "_ccsx_bound", False):
        lib.ccsx_banded_rotband.argtypes = [
            _P, _I, _P, _P, _L, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P]
        lib.ccsx_banded_rotband.restype = _I
        lib._ccsx_bound = True
    return lib


def batched_align_global_moves(qs: torch.Tensor, qlens: torch.Tensor,
                               ts: torch.Tensor, tlens: torch.Tensor,
                               params: AlignParams = AlignParams(),
                               band: Optional[int] = None, maxshift: int = 4):
    """Global fill with move bytes in the rotating-band layout: (score (n,)
    int32, moves (n, qmax, 128) uint8, offs (n, qmax) int32), the same
    values as ops/banded_cuda's.  ``ts`` may broadcast one template over
    the batch (stride 0 on its first dimension).  The kernel clamps the
    lengths to the padded widths; they are not read back."""
    if qs.device.type == "cpu":
        return rotband_global_moves(qs, qlens, ts, tlens, params, band,
                                    maxshift)
    what = "rotating-band global fill"
    banded_cuda.validate(what, qs, qlens, ts, tlens, band, maxshift)
    n, qmax = qs.shape
    dev = qs.device
    B = banded_cuda.BAND
    moves = torch.empty((n, qmax, B), dtype=torch.uint8, device=dev)
    offs = torch.empty((n, qmax), dtype=torch.int32, device=dev)
    score = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.ccsx_banded_rotband(
                qs.data_ptr(), qmax, qlens.data_ptr(), ts.data_ptr(),
                ts.stride(0), ts.shape[1], tlens.data_ptr(),
                params.match, params.mismatch, params.gap_open,
                params.gap_extend,
                moves.data_ptr(), offs.data_ptr(), score.data_ptr(), n,
                cuda_ext.stream_ptr(dev))
        cuda_ext.check(lib, rc, what)
        cuda_ext.count("banded_rotband")
    return score, moves, offs
