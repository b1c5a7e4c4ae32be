"""The warp layout of the rotating-band fill kernel, emulated in NumPy.

csrc/banded_rotband.cu runs each problem on one warp: lane L owns residues
4L..4L+3 (template columns j = 4L + c mod 128, its cells c) and keeps their
H and E in registers, which never move.  This file emulates that layout
lane by lane, as the kernel computes it, and holds it bit for bit against
the plain rotating-band fill (ops/banded_rotband.py, itself held against
the JAX package's Pallas kernel in test_torch_rotband.py) and the plain
band-local fill (ops/banded.py):

* the band starts at residue k0 = OFF & 127, in lane Ls = k0 >> 2 at cell
  cs = k0 & 3; lr = (L - Ls) & 31 is a lane's place in band order, and
  the split lane (lr 0) holds the band's head (cells c >= cs) and, when
  cs > 0, its tail (cells c < cs, krel 128 - cs .. 127);
* the up operand is the cell's own register, the diagonal one register
  c - 1 or lane L - 1's register 3; d enters only the masks;
* F as a cyclic two-level scan: the in-lane prefix in krel order (the
  split lane restarted at cs), the lane totals shuffled into band order
  (lane r takes lane Ls + r's) and scanned there with shuffles up, and
  one shuffle from band lane lr - 1 for the exclusive values, which the
  split lane's tail takes unmasked (band lane 31's: all of the band
  before the tail);
* the byte permutes: the template match word from band order to residue
  order (bytes 4 + c - cs of words lr - 1 and lr), and the move word back
  (bytes cs + b of lanes Ls + w and Ls + w + 1), with each move byte's F
  bit finished in the next row and band position 0's a constant.

The inputs are ``synth.fill_tie_cases`` and ``synth.rotband_cases``, whose
band offsets walk through every (OFF % 4, d) pair; the card's tests and
chip_smoke.py run both through the kernel.

Every output is an integer or a byte: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.ops import banded, banded_rotband
from ccsx_tpu_torch.utils import synth

from test_torch_lanes import (IDENT, LANE, LANES, NEG, PER, offsets, shfl_up,
                              template_words)

MASK = 127
C = np.arange(PER)


# ---- words of four bytes, one a lane ----

def pack(b):
    """(32, 4) bytes -> (32,) little-endian uint32 words."""
    b = b.astype(np.uint64) & 0xff
    return (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24))


def unpack(w):
    w = w.astype(np.uint64)
    return np.stack([(w >> (8 * c)) & 0xff for c in range(PER)], axis=1)


def byte_perm(lo, hi, sel):
    """__byte_perm(lo, hi, sel): byte n of the result is byte
    (sel >> 4n) & 7 of the eight bytes hi:lo (lo's bytes are 0..3)."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    out = np.zeros_like(v)
    for n in range(PER):
        b = np.uint64(8 * ((sel >> (4 * n)) & 7))
        out |= ((v >> b) & np.uint64(0xff)) << np.uint64(8 * n)
    return out


def shfl(x, src):
    """__shfl_sync from a per-lane source lane."""
    return x[np.asarray(src) & 31]


# ---- one problem ----

def emulate_rotband(q, qlen, t, tmax, tlen, p: AlignParams):
    """(score, moves (qlen, 128) uint8 in band order, offsets) of one
    problem, computed lane by lane in the kernel's layout."""
    M, X, O, E = p.match, p.mismatch, p.gap_open, p.gap_extend
    K = PER * LANE[:, None] + C[None, :]              # residue of each cell
    H = np.where(K <= tlen, np.where(K == 0, 0, O + E * K), NEG)
    Ev = np.full_like(H, NEG)
    F = np.zeros_like(H)
    part = np.zeros(LANES, np.uint64)
    f0 = 0 if O + E == 0 else 8
    offs = offsets(qlen, tlen, (0, 0, qlen, tlen), local=False)

    def move_word(pv, off_p):
        """The previous row's move word: F bits in residue order, then band
        word `lane`, band position 0's F bit the constant."""
        H_left = np.concatenate([pv[:, None], H[:, :-1]], axis=1)
        fb = np.where(F == H_left + O + E, 0, 8)
        w = part | pack(fb)
        k0 = off_p & MASK
        src = (k0 >> 2) + LANE
        band = byte_perm(shfl(w, src), shfl(w, src + 1),
                         0x3210 + (k0 & 3) * 0x1111)
        band[0] = (band[0] & ~np.uint64(8)) | np.uint64(f0)
        return band

    words, off_prev = [], 0
    for i in range(1, qlen + 1):
        off = offs[i - 1]
        d = off - off_prev
        qi = int(q[i - 1])
        # the match word: band order in lane w, then residue order
        tb = template_words(t, tmax, off)
        eq_band = pack(np.where((tb == qi) & (qi < 4), 0xff, 0))
        k0 = off & MASK
        cs = k0 & 3
        lr = (LANE - (k0 >> 2)) & 31
        eq = byte_perm(shfl(eq_band, lr - 1), shfl(eq_band, lr),
                       0x7654 - cs * 0x1111)
        ism = (unpack(eq) & 1).astype(bool)
        pv = shfl(H[:, 3], LANE - 1)
        if i > 1:
            words.append(move_word(pv, off_prev))

        rc = np.where(lr == 0, cs, PER)[:, None]      # the cell at krel 0
        kr = ((PER * LANE - k0) & MASK)[:, None] + C[None, :] & MASK
        up_ok = kr <= MASK - d
        dg_ok = (kr + d - 1 >= 0) & (kr + d - 1 <= MASK)
        H_up = np.where(up_ok, H, NEG)
        E_up = np.where(up_ok, Ev, NEG)
        H_dg = np.where(dg_ok, np.concatenate([pv[:, None], H[:, :-1]],
                                              axis=1), NEG)
        e_ext = E_up + E
        e_open = H_up + O + E
        eo = e_open >= e_ext
        En = np.where(eo, e_open, e_ext)
        diag = H_dg + np.where(ism, M, X)
        dw = diag >= En
        Hd = np.where(dw, diag, En)
        pre = np.where(dw, 0, 1) | np.where(eo, 0, 4)
        if off == 0:                                  # column 0: residue 0
            Hd[0, 0] = En[0, 0] = O + E * i
        if tlen - off < MASK:         # cells beyond tlen: only if tlen < 128
            invalid = kr > tlen - off
            Hd = np.where(invalid, NEG, Hd)
            En = np.where(invalid, NEG, En)
        v = Hd + O - E * kr

        # F: in-lane prefix (restarted at the split lane's head), the lane
        # totals in band order, the exclusive shift
        pf = v.copy()
        for c in range(1, PER):
            pf[:, c] = np.maximum(np.where(rc[:, 0] == c, IDENT, pf[:, c - 1]),
                                  v[:, c])
        S = shfl(pf[:, 3], LANE + (k0 >> 2))         # lane r: band lane r's
        for s in (1, 2, 4, 8, 16):
            S = np.maximum(S, shfl_up(S, s))
        Xl = shfl(S, lr - 1)
        cross = np.where(C[None, :] >= rc, IDENT, Xl[:, None])
        inl = np.concatenate([np.full((LANES, 1), IDENT), pf[:, :-1]], axis=1)
        inl = np.where(C[None, :] == rc, IDENT, inl)
        F = np.where(C[None, :] == rc, NEG, np.maximum(cross, inl) + E * kr)
        fw = Hd < F
        part = pack(np.where(fw, (pre & 4) | 2, pre))
        H = np.maximum(Hd, F)
        Ev = En
        off_prev = off
    if qlen > 0:
        words.append(move_word(shfl(H[:, 3], LANE - 1), off_prev))
    moves = (np.stack([unpack(w).reshape(-1) for w in words]) if words
             else np.zeros((0, 128), np.uint64)).astype(np.uint8)
    res = tlen & MASK
    laneT = tlen - off_prev
    score = int(H[res >> 2, res & 3]) if 0 <= laneT <= MASK else NEG
    return score, moves, offs


def _cases(name):
    if name == "ties":
        return synth.fill_tie_cases(np.random.default_rng(31))[:4]
    return synth.rotband_cases(np.random.default_rng(5))


# O + E = 0: band position 0's F bit (its F and its left neighbour NEG) is
# 0 here and 8 under the defaults
ZERO_GAP = AlignParams(gap_open=3, gap_extend=-3)


@pytest.mark.parametrize("name,params", [("ties", AlignParams()),
                                         ("rotband", AlignParams()),
                                         ("ties", ZERO_GAP)],
                         ids=["ties", "rotband", "ties-O+E=0"])
def test_rotband_lanes_match_plain_fills(name, params):
    """Every problem's score, offsets and live move rows against the plain
    rotating-band fill and the plain band-local fill."""
    qs, qlens, ts, tlens = _cases(name)
    args = [torch.from_numpy(x) for x in (qs, qlens, ts, tlens)]
    rs, rm, ro = banded_rotband.rotband_global_moves(*args, params)
    res, bm, bo = banded.banded_global_moves(*args, params)
    for k in range(len(qs)):
        ql = int(qlens[k])
        score, mv, off = emulate_rotband(qs[k], ql, ts[k], ts.shape[1],
                                         int(tlens[k]), params)
        for want_s, want_m, want_o in ((rs, rm, ro), (res.score, bm, bo)):
            assert score == int(want_s[k]), k
            np.testing.assert_array_equal(mv, want_m[k, :ql].numpy(),
                                          err_msg=f"problem {k}")
            np.testing.assert_array_equal(off, want_o[k, :ql].numpy(),
                                          err_msg=f"problem {k}")


def test_rotband_cases_cover_every_band_phase():
    """Between them the two corpora put the band's start at every cell of a
    lane under every advance d in 0..4, with the split lane at lane 31 and
    at lane 0 (the ring wraps from residue 127 to 0 inside the band)."""
    seen, split = set(), set()
    for name in ("ties", "rotband"):
        qs, qlens, ts, tlens = _cases(name)
        _, _, offs = banded.banded_global_moves(
            *(torch.from_numpy(x) for x in (qs, qlens, ts, tlens)))
        for k, ql in enumerate(qlens):
            o = offs[k, :ql].numpy().astype(int)
            d = np.diff(np.concatenate([[0], o]))
            seen |= set(zip(o % 4, d))
            split |= {((x & MASK) >> 2, x % 4) for x in o if x % 4}
    assert seen == {(cs, d) for cs in range(4) for d in range(5)}
    assert {(31, cs) for cs in (1, 2, 3)} <= split
    assert {(0, cs) for cs in (1, 2, 3)} <= split


@pytest.mark.parametrize("k0", range(0, 128, 5))
def test_permutes_are_inverse_rotations(k0):
    """The two byte permutes are the rotation by k0 residues and its
    inverse: band position b of the match word lands on residue
    (b + k0) & 127, and the move word brings residue (b + k0) & 127 back to
    band position b; cs = 0 takes the hi word whole (lo, for the move
    word), where a funnel shift masked to 31 bits would not."""
    cs, lr = k0 & 3, (LANE - (k0 >> 2)) & 31
    band = np.arange(128, dtype=np.uint64).reshape(LANES, PER)
    w = pack(band)
    res = unpack(byte_perm(shfl(w, lr - 1), shfl(w, lr),
                           0x7654 - cs * 0x1111)).reshape(-1)
    K = np.arange(128)
    np.testing.assert_array_equal(res, (K - k0) & MASK)
    src = (k0 >> 2) + LANE
    back = unpack(byte_perm(shfl(pack(res.reshape(LANES, PER)), src),
                            shfl(pack(res.reshape(LANES, PER)), src + 1),
                            0x3210 + cs * 0x1111)).reshape(-1)
    np.testing.assert_array_equal(back, K)
