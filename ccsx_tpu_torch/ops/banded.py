"""Banded affine-gap DP fill: the plain PyTorch version.

This is the port's spec for the two modes the per-hole path runs, and the
version that CPU tensors take (ops/banded_cuda.py launches the hand-written
kernels for CUDA tensors and holds them against these functions):

* ``banded_global_moves`` — global mode with one packed move byte per cell
  and the slim carry (the JAX package's ``banded_align(mode='global',
  with_moves=True, with_stats=False)``, what every consensus round runs);
* ``banded_local`` — local mode with the path statistics carried through
  the recurrence and an optional nominal line per pair (``banded_align(
  mode='local', line=...)``, what the strand walk's pair checks run).

Both are a loop over query rows, vectorized over batch x band.  Every
quantity is an integer and the arithmetic is int32 like the reference, so
the results are bit-identical to it: the NEG/PAD sentinels, the move-byte
layout, the tie rules (E opens on >=, diag wins on >=, the F prefix scan
keeps the right operand on ties, Hd wins over F on >=) and the band-offset
recurrence with its clip order are all the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ccsx_tpu_torch.config import AlignParams

NEG = -(2 ** 28)
PAD = 5

# move byte layout (global mode): bits 0-1 = H choice (0 diag, 1 E/up, 2 F/left)
# bit 2 = E reached by gap-extend (else gap-open); bit 3 = same for F.
MOVE_DIAG, MOVE_UP, MOVE_LEFT = 0, 1, 2
EBIT_EXT = 4
FBIT_EXT = 8


class BandedResult(NamedTuple):
    score: torch.Tensor
    qb: torch.Tensor
    qe: torch.Tensor
    tb: torch.Tensor
    te: torch.Tensor
    aln: torch.Tensor
    mat: torch.Tensor


def line_interp(ip, span, denom):
    """Exact ``floor(ip * span / denom)`` in int64 (the reference builds the
    same value from 8-bit limbs because it has no int64)."""
    return torch.div(torch.as_tensor(ip).long() * torch.as_tensor(span).long(),
                     torch.as_tensor(denom).long(), rounding_mode="floor")


def corner_lines(qlens: torch.Tensor, tlens: torch.Tensor) -> torch.Tensor:
    """(n, 4) default nominal lines (0, 0, qlen, tlen): what banded_align
    uses when no line is given."""
    z = torch.zeros_like(qlens, dtype=torch.int32)
    return torch.stack([z, z, qlens.int(), tlens.int()], dim=1)


def _offset(i, off_prev, qlen, tcap, line, band, maxshift, local):
    """Band offset of row i (int64, all (n,)): the nominal line, a coverage
    floor in global mode, monotone, at most maxshift per row, capped at
    tcap — with jnp.clip's min(max(x, lo), hi) order even when lo > hi."""
    li0, lj0, li1, lj1 = line
    nom = lj0 + line_interp(i - li0, lj1 - lj0, torch.clamp(li1 - li0, min=1))
    desired = nom - band // 2
    if local:
        lo = torch.zeros_like(desired)
    else:
        lo = torch.clamp(tcap - (qlen - i) * maxshift, min=0)
    hi = torch.minimum(off_prev + maxshift, tcap)
    off = torch.minimum(torch.maximum(torch.maximum(desired, lo), off_prev), hi)
    return torch.maximum(off, off_prev)


def _check(qs, qlens, ts, tlens):
    if qs.dim() != 2 or ts.dim() != 2:
        raise ValueError("qs and ts must be (n, qmax) and (n, tmax)")
    n = qs.shape[0]
    if ts.shape[0] != n or qlens.shape != (n,) or tlens.shape != (n,):
        raise ValueError("batch dimensions of qs, qlens, ts, tlens differ")
    if n and (int(qlens.max()) > qs.shape[1] or int(tlens.max()) > ts.shape[1]):
        raise ValueError("a length exceeds its padded width")


class _Band:
    """Per-call constants and the shifted views of the previous row."""

    def __init__(self, qs, ts, band, maxshift):
        self.n = qs.shape[0]
        self.B = band
        self.maxshift = maxshift
        dev = qs.device
        self.k = torch.arange(band, dtype=torch.int32, device=dev)
        self.k64 = self.k.long()
        self.q = qs.to(torch.int32)
        # tpad[:, off + k] == t[off + k - 1] (the base entering column j = off + k)
        self.tpad = torch.cat([
            torch.full((self.n, 1), PAD, dtype=torch.int32, device=dev),
            ts.to(torch.int32),
            torch.full((self.n, band + maxshift), PAD, dtype=torch.int32,
                       device=dev)], dim=1)
        self.negcol = torch.full((self.n, 1), NEG, dtype=torch.int32, device=dev)
        self.negtail = torch.full((self.n, maxshift), NEG, dtype=torch.int32,
                                  device=dev)

    def tband(self, off):
        return torch.gather(self.tpad, 1, off[:, None] + self.k64[None, :])

    def shifted(self, row, d, ofs):
        """[NEG, row, NEG*maxshift][d + ofs + k]: the diagonal (ofs 0) and
        vertical (ofs 1) predecessors after a band shift of d."""
        padded = torch.cat([self.negcol, row, self.negtail], dim=1)
        return torch.gather(padded, 1, (d + ofs)[:, None] + self.k64[None, :])

    def shift_right(self, x, fill):
        col = self.negcol if fill == NEG else torch.full_like(self.negcol, fill)
        return torch.cat([col, x[:, :-1]], dim=1)


def banded_global_moves(qs: torch.Tensor, qlens: torch.Tensor,
                        ts: torch.Tensor, tlens: torch.Tensor,
                        params: AlignParams = AlignParams(),
                        band: Optional[int] = None, maxshift: int = 4):
    """Global fill with move bytes over a batch (plain PyTorch).

    qs (n, qmax) uint8, qlens (n,), ts (n, tmax) uint8, tlens (n,).
    Returns (BandedResult, moves (n, qmax, B) uint8, offs (n, qmax) int32);
    the result's mat/aln are zero (slim carry) and moves of rows beyond a
    problem's qlen are zero.
    """
    _check(qs, qlens, ts, tlens)
    B = band if band is not None else params.band
    M, X = params.match, params.mismatch
    O, E = params.gap_open, params.gap_extend
    n, qmax = qs.shape
    dev = qs.device
    bd = _Band(qs, ts, B, maxshift)
    k = bd.k
    qlen = qlens.long()
    tlen = tlens.long()
    tlen32 = tlens.to(torch.int32)[:, None]
    tcap = torch.clamp(tlen - B + 1, min=0)
    line = (torch.zeros_like(qlen), torch.zeros_like(qlen), qlen, tlen)

    H = torch.where(k[None, :] <= tlen32,
                    torch.where(k == 0, 0, O + E * k)[None, :].expand(n, B),
                    NEG).to(torch.int32)
    Ev = torch.full((n, B), NEG, dtype=torch.int32, device=dev)
    off_prev = torch.zeros(n, dtype=torch.int64, device=dev)
    moves = torch.zeros((n, qmax, B), dtype=torch.uint8, device=dev)
    offs = torch.zeros((n, qmax), dtype=torch.int32, device=dev)
    rows = int(qlen.max()) if n else 0
    for i in range(1, rows + 1):
        live = i <= qlen
        off = _offset(i, off_prev, qlen, tcap, line, B, maxshift, local=False)
        d = off - off_prev
        j = off[:, None].to(torch.int32) + k[None, :]
        tb = bd.tband(off)
        qi = bd.q[:, i - 1][:, None]
        sub = torch.where((qi == tb) & (qi < 4) & (tb < 4), M, X)

        Hd_diag = bd.shifted(H, d, 0)
        H_up = bd.shifted(H, d, 1)
        E_up = bd.shifted(Ev, d, 1)
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

        v = Hd + O - E * k
        cum = torch.cummax(v, dim=1).values
        F = bd.shift_right(cum, NEG) + E * k
        hd_wins = Hd >= F
        Hnew = torch.maximum(Hd, F)

        choice = torch.where(hd_wins & d_wins, MOVE_DIAG,
                             torch.where(hd_wins, MOVE_UP, MOVE_LEFT))
        ebit = torch.where(e_is_open, 0, EBIT_EXT)
        H_left = bd.shift_right(Hnew, NEG)
        fbit = torch.where(F == H_left + (O + E), 0, FBIT_EXT)
        mv = (choice | ebit | fbit).to(torch.uint8)

        lv = live[:, None]
        moves[:, i - 1] = torch.where(lv, mv, 0)
        off_prev = torch.where(live, off, off_prev)
        offs[:, i - 1] = off_prev.to(torch.int32)
        H = torch.where(lv, Hnew, H)
        Ev = torch.where(lv, Enew, Ev)
    if rows < qmax:
        offs[:, rows:] = off_prev.to(torch.int32)[:, None]

    laneT = tlen - off_prev
    reachable = (laneT >= 0) & (laneT < B)
    lane = torch.clamp(laneT, 0, B - 1)
    score = torch.where(reachable,
                        torch.gather(H, 1, lane[:, None])[:, 0], NEG)
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    res = BandedResult(score=score.to(torch.int32), qb=zero,
                       qe=qlens.to(torch.int32), tb=zero,
                       te=tlens.to(torch.int32), aln=zero, mat=zero)
    return res, moves, offs


def banded_local(qs: torch.Tensor, qlens: torch.Tensor, ts: torch.Tensor,
                 tlens: torch.Tensor, lines: Optional[torch.Tensor] = None,
                 params: AlignParams = AlignParams(),
                 band: Optional[int] = None, maxshift: int = 4) -> BandedResult:
    """Local fill with path statistics over a batch (plain PyTorch).

    ``lines`` (n, 4) int32 holds each pair's nominal line (i0, j0, i1, j1);
    None means the corners (0, 0, qlen, tlen), as banded_align's default.
    Returns the seven BandedResult fields, each (n,) int32: the best cell's
    score, its query/template span [qb, qe) x [tb, te), and the path's
    columns (aln) and matches (mat).
    """
    _check(qs, qlens, ts, tlens)
    B = band if band is not None else params.band
    M, X = params.match, params.mismatch
    O, E = params.gap_open, params.gap_extend
    n, qmax = qs.shape
    dev = qs.device
    bd = _Band(qs, ts, B, maxshift)
    k = bd.k
    qlen = qlens.long()
    tlen = tlens.long()
    tlen32 = tlens.to(torch.int32)[:, None]
    tcap = torch.clamp(tlen - B + 1, min=0)
    if lines is None:
        lines = corner_lines(qlens, tlens)
    ln = lines.long()
    line = (ln[:, 0], ln[:, 1], ln[:, 2], ln[:, 3])

    def full(v):
        return torch.full((n, B), v, dtype=torch.int32, device=dev)

    kk = k[None, :].expand(n, B).contiguous()
    H = torch.where(kk <= tlen32, 0, NEG).to(torch.int32)
    Ev = full(NEG)
    mat, aln, qb, tb = full(0), full(0), full(0), kk
    Emat, Ealn, Eqb, Etb = mat, aln, qb, tb
    off_prev = torch.zeros(n, dtype=torch.int64, device=dev)
    z = torch.zeros(n, dtype=torch.int32, device=dev)
    # best tracker: (score, qe, mat, aln, qb, tb, te)
    best = [torch.full((n,), NEG, dtype=torch.int32, device=dev),
            z, z, z, z, z, z]
    rows = int(qlen.max()) if n else 0
    for i in range(1, rows + 1):
        live = i <= qlen
        off = _offset(i, off_prev, qlen, tcap, line, B, maxshift, local=True)
        d = off - off_prev
        j = off[:, None].to(torch.int32) + k[None, :]
        tband = bd.tband(off)
        qi = bd.q[:, i - 1][:, None]
        ismatch = (qi == tband) & (qi < 4) & (tband < 4)
        sub = torch.where(ismatch, M, X)

        Hd_diag = bd.shifted(H, d, 0)
        H_up = bd.shifted(H, d, 1)
        E_up = bd.shifted(Ev, d, 1)
        mat_diag, aln_diag = bd.shifted(mat, d, 0), bd.shifted(aln, d, 0)
        mat_up, aln_up = bd.shifted(mat, d, 1), bd.shifted(aln, d, 1)
        Emat_up, Ealn_up = bd.shifted(Emat, d, 1), bd.shifted(Ealn, d, 1)
        qb_diag, tb_diag = bd.shifted(qb, d, 0), bd.shifted(tb, d, 0)
        qb_up, tb_up = bd.shifted(qb, d, 1), bd.shifted(tb, d, 1)
        Eqb_up, Etb_up = bd.shifted(Eqb, d, 1), bd.shifted(Etb, d, 1)

        # E (vertical: consume a query base, gap in the template)
        e_ext = E_up + E
        e_open = H_up + (O + E)
        e_is_open = e_open >= e_ext
        Enew = torch.maximum(e_ext, e_open)
        nEmat = torch.where(e_is_open, mat_up, Emat_up)
        nEaln = torch.where(e_is_open, aln_up, Ealn_up) + 1
        nEqb = torch.where(e_is_open, qb_up, Eqb_up)
        nEtb = torch.where(e_is_open, tb_up, Etb_up)

        # Hd = best of diag / E
        diag_term = Hd_diag + sub
        d_wins = diag_term >= Enew
        Hd = torch.maximum(diag_term, Enew)
        Hmat = torch.where(d_wins, mat_diag + ismatch.to(torch.int32), nEmat)
        Haln = torch.where(d_wins, aln_diag, nEaln - 1) + 1
        Hqb = torch.where(d_wins, qb_diag, nEqb)
        Htb = torch.where(d_wins, tb_diag, nEtb)

        invalid = j > tlen32
        Hd = torch.where(invalid, NEG, Hd)
        Enew = torch.where(invalid, NEG, Enew)

        # F (horizontal): prefix max of v carrying the stats of the lane it
        # came from, ties to the right; the key v*256 + k makes cummax pick
        # the last maximal lane
        v = Hd + O - E * k
        key = torch.cummax(v.long() * 256 + bd.k64[None, :], dim=1).values
        src = key & 255
        F = bd.shift_right((key >> 8).to(torch.int32), NEG) + E * k
        Fmat = bd.shift_right(torch.gather(Hmat, 1, src), 0)
        Faln = bd.shift_right(torch.gather(Haln - k, 1, src), 0) + k
        Fqb = bd.shift_right(torch.gather(Hqb, 1, src), 0)
        Ftb = bd.shift_right(torch.gather(Htb, 1, src), 0)

        hd_wins = Hd >= F
        Hnew = torch.maximum(Hd, F)
        mat_new = torch.where(hd_wins, Hmat, Fmat)
        aln_new = torch.where(hd_wins, Haln, Faln)
        qb_new = torch.where(hd_wins, Hqb, Fqb)
        tb_new = torch.where(hd_wins, Htb, Ftb)

        clamp = Hnew < 0
        Hnew = torch.where(clamp, 0, Hnew)
        mat_new = torch.where(clamp, 0, mat_new)
        aln_new = torch.where(clamp, 0, aln_new)
        qb_new = torch.where(clamp, i, qb_new)
        tb_new = torch.where(clamp, j, tb_new)
        Hnew = torch.where(invalid, NEG, Hnew)

        # per-row best: the first maximal lane; a row replaces the best
        # only on a strict improvement
        lane = torch.argmax(Hnew, dim=1, keepdim=True)
        val = torch.where(live, torch.gather(Hnew, 1, lane)[:, 0], NEG)
        cand = (val, torch.full_like(val, i),
                torch.gather(mat_new, 1, lane)[:, 0],
                torch.gather(aln_new, 1, lane)[:, 0],
                torch.gather(qb_new, 1, lane)[:, 0],
                torch.gather(tb_new, 1, lane)[:, 0],
                (off + lane[:, 0]).to(torch.int32))
        take = val > best[0]
        best = [torch.where(take, c, b) for c, b in zip(cand, best)]

        lv = live[:, None]
        H = torch.where(lv, Hnew, H)
        Ev = torch.where(lv, Enew, Ev)
        mat = torch.where(lv, mat_new, mat)
        aln = torch.where(lv, aln_new, aln)
        qb = torch.where(lv, qb_new, qb)
        tb = torch.where(lv, tb_new, tb)
        Emat = torch.where(lv, nEmat, Emat)
        Ealn = torch.where(lv, nEaln, Ealn)
        Eqb = torch.where(lv, nEqb, Eqb)
        Etb = torch.where(lv, nEtb, Etb)
        off_prev = torch.where(live, off, off_prev)

    s, qe, bmat, baln, bqb, btb, te = (x.to(torch.int32) for x in best)
    return BandedResult(score=s, qb=bqb, qe=qe, tb=btb, te=te, aln=baln,
                        mat=bmat)
