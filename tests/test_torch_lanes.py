"""The warp decomposition of the banded fill kernels, emulated in NumPy.

csrc/banded_fill.cu runs each problem on one warp: lane L owns band cells
4L..4L+3 and keeps the previous row's carry in registers.  This file
emulates that decomposition lane by lane and holds it against the plain
fills of ops/banded.py (themselves held against the JAX package in
test_torch_banded.py) on tie-heavy inputs, so the kernels' arithmetic is
settled on the CPU:

* the shifted carry: the band advances by d in 0..4, so the diagonal and
  up operands of cell 4L+c are previous-row cells 4L+c+d-1 and 4L+c+d,
  read from the lane's own registers, lane L+1's (shuffle down) or lane
  L-1's last (shuffle up), NEG outside the band;
* the F scan in two levels: a serial scan of the lane's four cells, a
  5-step shuffle scan of the lane totals, the exclusive shift; in local
  mode over (value, cell) pairs with the later cell winning ties, and the
  winner's Hd-side statistics fetched from its owner lane;
* the local fill's best cell: strict ``>`` per lane in cell and row order,
  then a butterfly reduction on (value, row, cell);
* the band offsets: lane l steps one row in 32 along the nominal line
  without a division (quotient and remainder), and each row clips its
  lane's value in 32 bits, against the reference's recurrence.

The inputs are ``synth.fill_tie_cases``, which the card's tests and
chip_smoke.py also run through the kernels.

Every output is an integer or a byte: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.ops import banded
from ccsx_tpu_torch.utils import synth

LANES, PER, BAND, MAXSHIFT = 32, 4, 128, 4
NEG = banded.NEG
PAD = banded.PAD
IDENT = -(2 ** 31)      # identity of the max scan (lane 0's exclusive prefix)
LANE = np.arange(LANES)
K = (PER * LANE[:, None] + np.arange(PER)[None, :])   # (32, 4) cell index


# ---- warp primitives over (32, ...) per-lane arrays ----

def shfl_up(x, s):
    """__shfl_up_sync: lanes below s keep their own value."""
    out = x.copy()
    out[s:] = x[:-s]
    return out


def shfl_down1(x, fill):
    """__shfl_down_sync by one, lane 31's result replaced by ``fill``."""
    out = np.empty_like(x)
    out[:-1] = x[1:]
    out[-1] = fill
    return out


def shfl_xor(x, s):
    return x[LANE ^ s]


# ---- the band offsets, stepped without a division ----

class LineStep:
    """lj0 + floor((i - li0) * span / denom) for i = first, first + stride,
    ...: one floor division at the start, then a quotient and a
    non-negative remainder stepped by (floor(stride * span / denom),
    stride * span mod denom)."""

    def __init__(self, li0, lj0, li1, lj1, first=1, stride=1):
        self.denom = max(li1 - li0, 1)
        span = lj1 - lj0
        self.dq, self.dr = divmod(stride * span, self.denom)
        self.q, self.r = divmod((first - li0) * span, self.denom)
        self.lj0 = lj0

    def nominal(self):
        return self.lj0 + self.q

    def step(self):
        self.q += self.dq
        self.r += self.dr
        if self.r >= self.denom:
            self.r -= self.denom
            self.q += 1


def offsets(qlen, tlen, line, local):
    """The kernels' band offsets: lane l steps row base + l's nominal line
    32 rows at a time, raises it to global mode's coverage floor and clamps
    it to [-1, tcap + maxshift] (where the clip cannot change), and each row
    clips its lane's value in 32 bits: min(max(x, off_prev), min(off_prev +
    maxshift, tcap)), the reference's min(max(max(x, lo), off_prev), hi)
    since off_prev <= tcap."""
    tcap = max(tlen - BAND + 1, 0)
    lanes = [LineStep(*line, first=1 + l, stride=32) for l in range(LANES)]
    out, off = [], 0
    for base in range(1, qlen + 1, LANES):
        z = []
        for l, ls in enumerate(lanes):
            x = ls.nominal() - BAND // 2
            if not local:
                x = max(x, tcap - (qlen - base - l) * MAXSHIFT)
            z.append(min(max(x, -1), tcap + MAXSHIFT))
            ls.step()
        for x in z[:qlen + 1 - base]:
            off = min(max(x, off), min(off + MAXSHIFT, tcap))
            out.append(off)
    return out


def reference_offsets(qlen, tlen, line, local):
    """The reference's recurrence row by row (ops/banded._offset)."""
    tcap = max(tlen - BAND + 1, 0)
    li0, lj0, li1, lj1 = line
    out, off = [], 0
    for i in range(1, qlen + 1):
        nom = lj0 + ((i - li0) * (lj1 - lj0)) // max(li1 - li0, 1)
        lo = 0 if local else max(tcap - (qlen - i) * MAXSHIFT, 0)
        hi = min(off + MAXSHIFT, tcap)
        off = max(min(max(max(nom - BAND // 2, lo), off), hi), off)
        out.append(off)
    return out


# ---- the shifted carry ----

def neighbours(r):
    """(the next lane's four registers, the previous lane's last one)."""
    pv = shfl_up(r[:, 3], 1)
    pv[0] = NEG
    return shfl_down1(r, NEG), pv


def view(r, d, ofs):
    """Previous-row cell 4L + c + d + ofs - 1 of every lane: ofs 0 is the
    diagonal operand, ofs 1 the up operand."""
    nx, pv = neighbours(r)
    w = np.concatenate([r, nx], axis=1)
    out = np.empty_like(r)
    for c in range(PER):
        m = c + d + ofs - 1
        out[:, c] = pv if m < 0 else w[:, m]
    return out


def template_words(t, tmax, off):
    """(32, 4) template bases entering columns off + 4L + c (PAD outside
    1..tmax), as the kernel's per-lane 32-bit word holds them."""
    j = off + K
    ok = (j >= 1) & (j <= tmax)
    return np.where(ok, t[np.clip(j - 1, 0, tmax - 1)], PAD)


# ---- the F scans ----

def f_scan_values(v):
    """Exclusive max prefix of v over the band: (32, 4) cum[k - 1], with
    cell 0 NEG (the reference's shift_right fill)."""
    p = np.maximum.accumulate(v, axis=1)            # in-lane serial scan
    S = p[:, 3].copy()
    for s in (1, 2, 4, 8, 16):
        S = np.maximum(S, shfl_up(S, s))
    X = shfl_up(S, 1)
    X[0] = IDENT
    cx = np.empty_like(v)
    cx[:, 0] = X
    cx[0, 0] = NEG
    cx[:, 1:] = np.maximum(X[:, None], p[:, :-1])
    return cx


def combine(av, ai, bv, bi):
    """(a earlier, b later): the later wins ties."""
    take = bv >= av
    return np.where(take, bv, av), np.where(take, bi, ai)


def f_scan_pairs(v):
    """Exclusive prefix of (value, cell) with ties to the later cell:
    (cx value, cx cell, came-from-another-lane) per cell; cell 0 of lane 0
    gets (NEG, -1)."""
    pv, pi = v.copy(), K.copy()
    for c in range(1, PER):                         # in-lane serial scan
        pv[:, c], pi[:, c] = combine(pv[:, c - 1], pi[:, c - 1],
                                     v[:, c], pi[:, c])
    Sv, Si = pv[:, 3].copy(), pi[:, 3].copy()
    for s in (1, 2, 4, 8, 16):
        Sv, Si = combine(shfl_up(Sv, s), shfl_up(Si, s), Sv, Si)
    Xv, Xi = shfl_up(Sv, 1), shfl_up(Si, 1)
    Xv[0] = IDENT
    cv, ci = np.empty_like(v), np.empty_like(v)
    cv[:, 0], ci[:, 0] = Xv, Xi
    cv[:, 1:], ci[:, 1:] = combine(Xv[:, None], Xi[:, None],
                                   pv[:, :-1], pi[:, :-1])
    cv[0, 0], ci[0, 0] = NEG, -1
    return cv, ci, Xi


def fetch(stat, Xi, ci):
    """The F-side statistic of every cell: own-lane cells from registers,
    the exclusive prefix's cell from its owner lane (lane Xi >> 2, register
    Xi & 3: one shuffle of each register, or a warp-private buffer)."""
    xs = stat[Xi >> 2, Xi & 3]
    own = stat[LANE[:, None], np.clip(ci, 0, BAND - 1) & 3]
    cross = ci < PER * LANE[:, None]
    return np.where(cross, xs[:, None], own)


# ---- the two fills, one problem at a time ----

def emulate_global(q, qlen, t, tmax, tlen, p: AlignParams):
    M, X, O, E = p.match, p.mismatch, p.gap_open, p.gap_extend
    H = np.where(K <= tlen, np.where(K == 0, 0, O + E * K), NEG)
    Ev = np.full_like(H, NEG)
    offs = offsets(qlen, tlen, (0, 0, qlen, tlen), local=False)
    moves, off_prev = [], 0
    for i in range(1, qlen + 1):
        off = offs[i - 1]
        d = off - off_prev
        j = off + K
        tb = template_words(t, tmax, off)
        qi = int(q[i - 1])
        sub = np.where((tb == qi) & (qi < 4), M, X)
        e_ext = view(Ev, d, 1) + E
        e_open = view(H, d, 1) + O + E
        e_is_open = e_open >= e_ext
        En = np.where(e_is_open, e_open, e_ext)
        diag = view(H, d, 0) + sub
        d_wins = diag >= En
        Hd = np.where(d_wins, diag, En)
        Hd = np.where(j == 0, O + E * i, Hd)
        En = np.where(j == 0, O + E * i, En)
        Hd = np.where(j > tlen, NEG, Hd)
        En = np.where(j > tlen, NEG, En)
        F = f_scan_values(Hd + O - E * K) + E * K
        hd_wins = Hd >= F
        Hn = np.where(hd_wins, Hd, F)
        H_left = np.concatenate([shfl_up(Hn[:, 3], 1)[:, None], Hn[:, :-1]],
                                axis=1)
        H_left[0, 0] = NEG
        choice = np.where(hd_wins & d_wins, 0, np.where(hd_wins, 1, 2))
        mv = (choice | np.where(e_is_open, 0, 4)
              | np.where(F == H_left + O + E, 0, 8))
        moves.append(mv.reshape(-1))
        H, Ev, off_prev = Hn, En, off
    laneT = tlen - off_prev
    score = int(H[laneT >> 2, laneT & 3]) if 0 <= laneT < BAND else NEG
    return score, np.array(moves, np.uint8).reshape(qlen, BAND), offs


def emulate_local(q, qlen, t, tmax, tlen, line, p: AlignParams):
    M, X, O, E = p.match, p.mismatch, p.gap_open, p.gap_extend
    z = np.zeros_like(K)
    H = np.where(K <= tlen, 0, NEG)
    Ev = np.full_like(H, NEG)
    mat, aln, qb, tb = z, z, z, K.copy()
    Emat, Ealn, Eqb, Etb = z, z, z, K.copy()
    best = dict(v=np.full(LANES, NEG), qe=np.zeros(LANES, int),
                k=np.zeros(LANES, int), mat=np.zeros(LANES, int),
                aln=np.zeros(LANES, int), qb=np.zeros(LANES, int),
                tb=np.zeros(LANES, int), te=np.zeros(LANES, int))
    offs = offsets(qlen, tlen, line, local=True)
    off_prev = 0
    for i in range(1, qlen + 1):
        off = offs[i - 1]
        d = off - off_prev
        j = off + K
        tband = template_words(t, tmax, off)
        qi = int(q[i - 1])
        ism = ((tband == qi) & (qi < 4)).astype(int)
        sub = np.where(ism == 1, M, X)
        e_ext = view(Ev, d, 1) + E
        e_open = view(H, d, 1) + O + E
        eo = e_open >= e_ext
        En = np.where(eo, e_open, e_ext)
        nEmat = np.where(eo, view(mat, d, 1), view(Emat, d, 1))
        nEaln = np.where(eo, view(aln, d, 1), view(Ealn, d, 1)) + 1
        nEqb = np.where(eo, view(qb, d, 1), view(Eqb, d, 1))
        nEtb = np.where(eo, view(tb, d, 1), view(Etb, d, 1))
        diag = view(H, d, 0) + sub
        dw = diag >= En
        Hd = np.where(dw, diag, En)
        Hmat = np.where(dw, view(mat, d, 0) + ism, nEmat)
        Haln = np.where(dw, view(aln, d, 0), nEaln - 1) + 1
        Hqb = np.where(dw, view(qb, d, 0), nEqb)
        Htb = np.where(dw, view(tb, d, 0), nEtb)
        invalid = j > tlen
        Hd = np.where(invalid, NEG, Hd)
        En = np.where(invalid, NEG, En)

        cv, ci, Xi = f_scan_pairs(Hd + O - E * K)
        F = cv + E * K
        first = ci < 0                               # cell 0 of lane 0
        Fmat = np.where(first, 0, fetch(Hmat, Xi, ci))
        Faln = np.where(first, 0, fetch(Haln - K, Xi, ci) + K)
        Fqb = np.where(first, 0, fetch(Hqb, Xi, ci))
        Ftb = np.where(first, 0, fetch(Htb, Xi, ci))

        hw = Hd >= F
        Hn = np.where(hw, Hd, F)
        mat_n = np.where(hw, Hmat, Fmat)
        aln_n = np.where(hw, Haln, Faln)
        qb_n = np.where(hw, Hqb, Fqb)
        tb_n = np.where(hw, Htb, Ftb)
        clamp = Hn < 0
        Hn = np.where(clamp, 0, Hn)
        mat_n = np.where(clamp, 0, mat_n)
        aln_n = np.where(clamp, 0, aln_n)
        qb_n = np.where(clamp, i, qb_n)
        tb_n = np.where(clamp, j, tb_n)
        Hn = np.where(invalid, NEG, Hn)

        for c in range(PER):                 # strict > in cell order
            take = Hn[:, c] > best["v"]
            for key, val in (("v", Hn[:, c]), ("qe", i), ("k", K[:, c]),
                             ("mat", mat_n[:, c]), ("aln", aln_n[:, c]),
                             ("qb", qb_n[:, c]), ("tb", tb_n[:, c]),
                             ("te", j[:, c])):
                best[key] = np.where(take, val, best[key])

        H, Ev, mat, aln, qb, tb = Hn, En, mat_n, aln_n, qb_n, tb_n
        Emat, Ealn, Eqb, Etb = nEmat, nEaln, nEqb, nEtb
        off_prev = off

    # butterfly reduction on (value, row, cell): largest value, then the
    # earliest row, then the lowest cell
    rv, rq, rk = best["v"].copy(), best["qe"].copy(), best["k"].copy()
    for s in (16, 8, 4, 2, 1):
        ov, oq, ok = shfl_xor(rv, s), shfl_xor(rq, s), shfl_xor(rk, s)
        better = (ov > rv) | ((ov == rv) & ((oq < rq) | ((oq == rq) & (ok < rk))))
        rv, rq, rk = (np.where(better, ov, rv), np.where(better, oq, rq),
                      np.where(better, ok, rk))
    assert (rv == rv[0]).all() and (rk == rk[0]).all()
    if rv[0] <= NEG:
        return (NEG, 0, 0, 0, 0, 0, 0)
    w = rk[0] >> 2
    return tuple(int(best[f][w]) for f in
                 ("v", "qb", "qe", "tb", "te", "aln", "mat"))


@pytest.fixture(scope="module")
def ties():
    return synth.fill_tie_cases(np.random.default_rng(31))


def test_global_lanes_match_plain(ties):
    qs, qlens, ts, tlens, _ = ties
    res, moves, offs = banded.banded_global_moves(
        *(torch.from_numpy(x) for x in (qs, qlens, ts, tlens)))
    for k in range(len(qs)):
        score, mv, off = emulate_global(qs[k], int(qlens[k]), ts[k],
                                        ts.shape[1], int(tlens[k]),
                                        AlignParams())
        assert score == int(res.score[k]), k
        np.testing.assert_array_equal(mv, moves[k, :qlens[k]].numpy(),
                                      err_msg=f"problem {k}")
        np.testing.assert_array_equal(off, offs[k, :qlens[k]].numpy(),
                                      err_msg=f"problem {k}")


@pytest.mark.parametrize("seeded", [False, True])
def test_local_lanes_match_plain(ties, seeded):
    qs, qlens, ts, tlens, lines = ties
    if not seeded:
        lines = np.stack([np.zeros_like(qlens), np.zeros_like(qlens), qlens,
                          tlens], axis=1)
    want = banded.banded_local(
        *(torch.from_numpy(x) for x in (qs, qlens, ts, tlens, lines)))
    for k in range(len(qs)):
        got = emulate_local(qs[k], int(qlens[k]), ts[k], ts.shape[1],
                            int(tlens[k]), tuple(int(x) for x in lines[k]),
                            AlignParams())
        assert got == tuple(int(f[k]) for f in want), (k, got)


@pytest.mark.parametrize("stride", [1, 32])
def test_line_step_matches_floor_interpolation(stride):
    """The division-free stepping against the exact floor interpolation,
    over lines with li0 > 1 (negative numerators), falling lines and
    degenerate ones (li1 <= li0, denominator 1)."""
    rng = np.random.default_rng(5)
    for _ in range(300):
        li0 = int(rng.integers(-50, 400))
        li1 = li0 + int(rng.integers(-5, 600))
        lj0 = int(rng.integers(-100, 500))
        lj1 = lj0 + int(rng.integers(-300, 3000))
        first = int(rng.integers(1, 33))
        ls = LineStep(li0, lj0, li1, lj1, first, stride)
        i = first + stride * np.arange(300)
        want = lj0 + banded.line_interp(torch.from_numpy(i - li0), lj1 - lj0,
                                        max(li1 - li0, 1)).numpy()
        got = []
        for _ in i:
            got.append(ls.nominal())
            ls.step()
        np.testing.assert_array_equal(got, want)


def test_chunked_offsets_match_reference_recurrence():
    """The 32-row chunks of clip inputs and the 32-bit clip against the
    reference's row-by-row recurrence, both modes, on random and seeded
    lines, with templates shorter and longer than the band."""
    rng = np.random.default_rng(8)
    for _ in range(200):
        qlen = int(rng.integers(0, 300))
        tlen = int(rng.integers(0, 500))
        li0 = int(rng.integers(-20, 120))
        line = (li0, int(rng.integers(-50, 300)),
                li0 + int(rng.integers(-5, 400)), int(rng.integers(-50, 800)))
        for local in (False, True):
            ln = line if local else (0, 0, qlen, tlen)
            assert offsets(qlen, tlen, ln, local) == \
                reference_offsets(qlen, tlen, ln, local), (qlen, tlen, ln)
