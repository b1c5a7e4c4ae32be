"""Banded affine-gap fills in plain PyTorch: the global fill with move
bytes (every refine round) and the local fill with path statistics (the
strand walk's pair checks).

Both are a loop over query rows, vectorised over problems x band, in int32:
a band of 128 cells a row whose offset follows a nominal line, moves at
most ``maxshift`` columns a row, and (global) keeps the end cell reachable.
Scores: match +2, mismatch -6, gap open -3 charged with the first extend
-2.  Tie rules: E opens on >=, the diagonal wins over E on >=, the F scan
keeps the later cell on ties, Hd wins over F on >=; a local row replaces
the best cell only on a strict gain, at its first maximal lane.

Move byte (global): bits 0-1 the H choice (0 diagonal, 1 E/up, 2
F/left), bit 2 set when E was reached by extension, bit 3 the same for F.

A row is one ``step(i, state)`` of plain tensor operations.  On the CPU
the rows run one after another.  On the card a row is some forty small
operations, so the rows run in CUDA graphs of ``CHUNK`` steps, captured
once for a problem shape (``Fills`` keeps them) and replayed: the same
operations, issued without the host in between.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import torch

NEG = -(2 ** 28)
PAD = 5
BAND = 128
MAXSHIFT = 4
MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = 2, -6, -3, -2
MOVE_DIAG, MOVE_UP, MOVE_LEFT = 0, 1, 2
EBIT_EXT = 4
FBIT_EXT = 8
CHUNK = 64
KEEP_SHAPES = 6
I32 = torch.int32
I64 = torch.int64


class Local(NamedTuple):
    score: torch.Tensor
    qb: torch.Tensor
    qe: torch.Tensor
    tb: torch.Tensor
    te: torch.Tensor
    aln: torch.Tensor
    mat: torch.Tensor


def _offset(i, off_prev, qlen, tcap, line, local):
    """Band offset of row i: the nominal line's column less half a band,
    floored at 0 (local) or at what keeps the end reachable (global),
    monotone, at most MAXSHIFT a row, capped at tcap; clip order
    min(max(x, lo), hi) even when lo > hi."""
    li0, lj0, li1, lj1 = line
    nom = lj0 + torch.div((i - li0) * (lj1 - lj0),
                          torch.clamp(li1 - li0, min=1),
                          rounding_mode="floor")
    desired = nom - BAND // 2
    if local:
        lo = torch.zeros_like(desired)
    else:
        lo = torch.clamp(tcap - (qlen - i) * MAXSHIFT, min=0)
    hi = torch.minimum(off_prev + MAXSHIFT, tcap)
    off = torch.minimum(torch.maximum(torch.maximum(desired, lo), off_prev),
                        hi)
    return torch.maximum(off, off_prev)


class _Problem:
    """A batch of (query, template) pairs at one padded shape: the inputs,
    the carried row state and the outputs, in fixed buffers that a
    captured graph reads and writes."""

    def __init__(self, n, qmax, tmax, dev):
        self.n, self.qmax, self.tmax, self.dev = n, qmax, tmax, dev
        self.k = torch.arange(BAND, dtype=I32, device=dev)
        self.k64 = self.k.long()
        self.q = torch.full((n, qmax + CHUNK), PAD, dtype=I32, device=dev)
        self.tpad = torch.full((n, 1 + tmax + BAND + MAXSHIFT), PAD,
                               dtype=I32, device=dev)
        self.qlen = torch.zeros(n, dtype=I64, device=dev)
        self.tlen = torch.zeros(n, dtype=I64, device=dev)
        self.line = torch.zeros((4, n), dtype=I64, device=dev)
        self.tcap = torch.zeros(n, dtype=I64, device=dev)
        self.tlen32 = torch.zeros((n, 1), dtype=I32, device=dev)
        self.negcol = torch.full((n, 1), NEG, dtype=I32, device=dev)
        self.negtail = torch.full((n, MAXSHIFT), NEG, dtype=I32, device=dev)
        self.i = torch.ones((), dtype=I64, device=dev)
        self.state = None
        self.graph = None

    def load(self, qs, qlens, ts, tlens, lines=None):
        n, ql, tl = qs.shape[0], qs.shape[1], ts.shape[1]
        self.q.fill_(PAD)
        self.q[:n, :ql] = qs.to(I32)
        self.tpad.fill_(PAD)
        self.tpad[:n, 1:1 + tl] = ts.to(I32)
        self.qlen.zero_()
        self.qlen[:n] = qlens.long()
        self.tlen.zero_()
        self.tlen[:n] = tlens.long()
        self.line.zero_()
        if lines is None:
            self.line[2] = self.qlen
            self.line[3] = self.tlen
        else:
            self.line[:, :n] = lines.long().t()
        # every buffer a captured step reads is written in place
        self.tcap.copy_(torch.clamp(self.tlen - BAND + 1, min=0))
        self.tlen32.copy_(self.tlen.to(I32)[:, None])
        self.i.fill_(1)

    def tband(self, off):
        return torch.gather(self.tpad, 1, off[:, None] + self.k64[None, :])

    def shifted(self, row, d, ofs):
        padded = torch.cat([self.negcol, row, self.negtail], dim=1)
        return torch.gather(padded, 1, (d + ofs)[:, None] + self.k64[None, :])

    def shift_right(self, x, fill):
        col = self.negcol if fill == NEG else torch.full_like(self.negcol,
                                                              fill)
        return torch.cat([col, x[:, :-1]], dim=1)

    def row_q(self, i):
        return torch.index_select(self.q, 1, (i - 1).view(1))


class _GlobalProblem(_Problem):
    def __init__(self, n, qmax, tmax, dev):
        super().__init__(n, qmax, tmax, dev)
        self.moves = torch.zeros((n, qmax + CHUNK, BAND), dtype=torch.uint8,
                                 device=dev)
        self.offs = torch.zeros((n, qmax + CHUNK), dtype=I32, device=dev)
        self.state = [torch.zeros((n, BAND), dtype=I32, device=dev),
                      torch.zeros((n, BAND), dtype=I32, device=dev),
                      torch.zeros(n, dtype=I64, device=dev)]

    def load(self, qs, qlens, ts, tlens, lines=None):
        super().load(qs, qlens, ts, tlens)
        O, E = GAP_OPEN, GAP_EXTEND
        k = self.k
        H, Ev, off_prev = self.state
        H.copy_(torch.where(k[None, :] <= self.tlen32,
                            torch.where(k == 0, 0, O + E * k)[None, :],
                            NEG))
        Ev.fill_(NEG)
        off_prev.zero_()
        self.moves.zero_()
        self.offs.zero_()

    def step(self, i, state):
        M, X, O, E = MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND
        H, Ev, off_prev = state
        k = self.k
        qlen = self.qlen
        line = (self.line[0], self.line[1], self.line[2], self.line[3])
        live = i <= qlen
        off = _offset(i, off_prev, qlen, self.tcap, line, False)
        d = off - off_prev
        j = off[:, None].to(I32) + k[None, :]
        tb = self.tband(off)
        qi = self.row_q(i)
        sub = torch.where((qi == tb) & (qi < 4) & (tb < 4), M, X)

        Hd_diag = self.shifted(H, d, 0)
        H_up = self.shifted(H, d, 1)
        E_up = self.shifted(Ev, d, 1)
        e_ext = E_up + E
        e_open = H_up + (O + E)
        e_is_open = e_open >= e_ext
        Enew = torch.maximum(e_ext, e_open)
        diag_term = Hd_diag + sub
        d_wins = diag_term >= Enew
        Hd = torch.maximum(diag_term, Enew)
        at0 = j == 0
        edge = (O + E * i).to(I32)
        Hd = torch.where(at0, edge, Hd)
        Enew = torch.where(at0, edge, Enew)
        invalid = j > self.tlen32
        Hd = torch.where(invalid, NEG, Hd)
        Enew = torch.where(invalid, NEG, Enew)

        v = Hd + O - E * k
        cum = torch.cummax(v, dim=1).values
        F = self.shift_right(cum, NEG) + E * k
        hd_wins = Hd >= F
        Hnew = torch.maximum(Hd, F)

        choice = torch.where(hd_wins & d_wins, MOVE_DIAG,
                             torch.where(hd_wins, MOVE_UP, MOVE_LEFT))
        ebit = torch.where(e_is_open, 0, EBIT_EXT)
        H_left = self.shift_right(Hnew, NEG)
        fbit = torch.where(F == H_left + (O + E), 0, FBIT_EXT)
        mv = (choice | ebit | fbit).to(torch.uint8)

        lv = live[:, None]
        at = (i - 1).view(1)
        self.moves.index_copy_(1, at, torch.where(lv, mv, 0)[:, None])
        off_prev = torch.where(live, off, off_prev)
        self.offs.index_copy_(1, at, off_prev.to(I32)[:, None])
        return [torch.where(lv, Hnew, H), torch.where(lv, Enew, Ev),
                off_prev]


class _LocalProblem(_Problem):
    """The local fill's row state is one (10, n, band) stack -- H, E and the
    path statistics of H and E (mat, aln, qb, tb, Emat, Ealn, Eqb, Etb) --
    so that a row shifts, selects and keeps them in a few operations; then
    the band offset, and the best cell's (score, qe, mat, aln, qb, tb,
    te)."""

    def __init__(self, n, qmax, tmax, dev):
        super().__init__(n, qmax, tmax, dev)
        self.state = [torch.zeros((10, n, BAND), dtype=I32, device=dev),
                      torch.zeros(n, dtype=I64, device=dev),
                      torch.zeros((7, n), dtype=I32, device=dev)]
        self.negcol3 = torch.full((10, n, 1), NEG, dtype=I32, device=dev)
        self.negtail3 = torch.full((10, n, MAXSHIFT), NEG, dtype=I32,
                                   device=dev)
        # rows of the stack the diagonal predecessor is read from
        self.diag_rows = torch.tensor([0, 2, 3, 4, 5], device=dev)

    def load(self, qs, qlens, ts, tlens, lines=None):
        super().load(qs, qlens, ts, tlens, lines)
        S, off_prev, best = self.state
        kk = self.k[None, :].expand(self.n, BAND)
        S.zero_()
        S[0].copy_(torch.where(kk <= self.tlen32, 0, NEG))
        S[1].fill_(NEG)
        S[5].copy_(kk)
        S[9].copy_(kk)
        off_prev.zero_()
        best.zero_()
        best[0].fill_(NEG)

    def shifted_stack(self, X, d, ofs):
        padded = torch.cat([self.negcol3[:X.shape[0]], X,
                            self.negtail3[:X.shape[0]]], dim=2)
        idx = ((d + ofs)[:, None] + self.k64[None, :]).expand(X.shape)
        return torch.gather(padded, 2, idx)

    def step(self, i, state):
        M, X, O, E = MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND
        S, off_prev, best = state
        k = self.k
        qlen = self.qlen
        line = (self.line[0], self.line[1], self.line[2], self.line[3])
        i32 = i.to(I32)
        live = i <= qlen
        off = _offset(i, off_prev, qlen, self.tcap, line, True)
        d = off - off_prev
        j = off[:, None].to(I32) + k[None, :]
        tband = self.tband(off)
        qi = self.row_q(i)
        ismatch = (qi == tband) & (qi < 4) & (tband < 4)
        sub = torch.where(ismatch, M, X)

        (Hd_diag, mat_diag, aln_diag, qb_diag, tb_diag) = self.shifted_stack(
            torch.index_select(S, 0, self.diag_rows), d, 0).unbind(0)
        up = self.shifted_stack(S, d, 1)
        H_up, E_up = up[0], up[1]
        # E (vertical): its statistics from H's (open) or E's (extend)
        e_ext = E_up + E
        e_open = H_up + (O + E)
        e_is_open = e_open >= e_ext
        Enew = torch.maximum(e_ext, e_open)
        nE = torch.where(e_is_open[None], up[2:6], up[6:10])
        nE[1] += 1            # aln counts the column
        nEmat, nEaln, nEqb, nEtb = nE.unbind(0)

        diag_term = Hd_diag + sub
        d_wins = diag_term >= Enew
        Hd = torch.maximum(diag_term, Enew)
        Hs = torch.where(d_wins[None],
                         torch.stack([mat_diag + ismatch.to(I32),
                                      aln_diag + 1, qb_diag, tb_diag]),
                         torch.stack([nEmat, nEaln, nEqb, nEtb]))

        invalid = j > self.tlen32
        Hd = torch.where(invalid, NEG, Hd)
        Enew = torch.where(invalid, NEG, Enew)

        # F: prefix max of v with the statistics of the lane it came from,
        # the later lane on ties (key v * 256 + lane)
        v = Hd + O - E * k
        key = torch.cummax(v.long() * 256 + self.k64[None, :], dim=1).values
        src = (key & 255).expand(4, -1, -1)
        F = self.shift_right((key >> 8).to(I32), NEG) + E * k
        Fs = torch.gather(Hs - torch.stack([0 * k, k, 0 * k, 0 * k])[:, None],
                          2, src)
        Fs = torch.cat([torch.zeros_like(Fs[:, :, :1]), Fs[:, :, :-1]], dim=2)
        Fs[1] += k

        hd_wins = Hd >= F
        Hnew = torch.maximum(Hd, F)
        stats = torch.where(hd_wins[None], Hs, Fs)

        clamp = Hnew < 0
        Hnew = torch.where(clamp, 0, Hnew)
        stats = torch.where(clamp[None],
                            torch.stack([torch.zeros_like(j),
                                         torch.zeros_like(j),
                                         i32.expand_as(j), j]), stats)
        Hnew = torch.where(invalid, NEG, Hnew)

        lane = torch.argmax(Hnew, dim=1, keepdim=True)
        val = torch.where(live, torch.gather(Hnew, 1, lane)[:, 0], NEG)
        at = torch.gather(stats, 2, lane[None].expand(4, -1, -1))[:, :, 0]
        cand = torch.cat([val[None], i32.expand_as(val)[None], at,
                          (off + lane[:, 0]).to(I32)[None]])
        best = torch.where((val > best[0])[None], cand, best)

        new = torch.cat([Hnew[None], Enew[None], stats, nE])
        return [torch.where(live[None, :, None], new, S),
                torch.where(live, off, off_prev), best]


def _pad_to(x: int, q: int) -> int:
    return max(q, -(-x // q) * q)


class Fills:
    """Runs the fills; on the card keeps each problem shape's buffers and
    captured graph for reuse (the ``KEEP_SHAPES`` last used)."""

    def __init__(self, device="cuda"):
        self.dev = torch.device(device)
        self.problems = collections.OrderedDict()

    def _problem(self, cls, n, qmax, tmax):
        if self.dev.type != "cuda":
            return cls(n, qmax, tmax, self.dev)
        key = (cls, _pad_to(n, 16), _pad_to(qmax, 256), _pad_to(tmax, 256))
        p = self.problems.pop(key, None)
        if p is None:
            while len(self.problems) >= KEEP_SHAPES:
                self.problems.popitem(last=False)
            p = cls(*key[1:], self.dev)
        self.problems[key] = p
        return p

    def _rows(self, p: _Problem, rows: int) -> None:
        if self.dev.type != "cuda":
            for _ in range(rows):
                p.state = p.step(p.i, p.state)
                p.i += 1
            return
        done = 0
        if p.graph is None:
            # the first chunk eagerly, which loads every kernel; then the
            # capture of CHUNK steps from whatever state the buffers hold
            for _ in range(min(rows, CHUNK)):
                new = p.step(p.i, p.state)
                for buf, x in zip(p.state, new):
                    buf.copy_(x)
                p.i += 1
            done = min(rows, CHUNK)
            torch.cuda.synchronize(self.dev)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                st = p.state
                for c in range(CHUNK):
                    st = p.step(p.i + c, st)
                for buf, x in zip(p.state, st):
                    buf.copy_(x)
                p.i.add_(CHUNK)
            p.graph = g
        for _ in range(-(-(rows - done) // CHUNK)):
            p.graph.replay()

    def global_moves(self, qs, qlens, ts, tlens):
        """Global fill of each (query, template) pair, corner to corner.
        qs (n, qmax) uint8, qlens (n,), ts (n, tmax) uint8, tlens (n,), on
        the host.  Returns (score (n,) int32, moves (n, qmax, 128) uint8,
        offs (n, qmax) int32) on the host; rows beyond a query's length
        have zero moves and the last offset."""
        n, qmax = qs.shape
        p = self._problem(_GlobalProblem, n, qmax, ts.shape[1])
        p.load(qs.to(self.dev), qlens.to(self.dev), ts.to(self.dev),
               tlens.to(self.dev))
        rows = int(qlens.max()) if n else 0
        self._rows(p, rows)
        H, _, off_prev = (x[:n] for x in p.state)
        offs = p.offs[:n, :qmax].clone()
        if rows < qmax:
            offs[:, rows:] = off_prev.to(I32)[:, None]
        laneT = p.tlen[:n] - off_prev
        reachable = (laneT >= 0) & (laneT < BAND)
        lane = torch.clamp(laneT, 0, BAND - 1)
        score = torch.where(reachable,
                            torch.gather(H, 1, lane[:, None])[:, 0], NEG)
        return (score.to(I32).cpu(), p.moves[:n, :qmax].cpu(), offs.cpu())

    def local(self, qs, qlens, ts, tlens,
              lines: Optional[torch.Tensor] = None) -> Local:
        """Local fill with the best cell's path statistics.  ``lines``
        (n, 4) holds each pair's nominal line (i0, j0, i1, j1); None means
        its corners.  Returns, on the host, the best cell's score, its
        query/template span [qb, qe) x [tb, te), and the path's columns
        (aln) and matches (mat), each (n,) int32."""
        n = qs.shape[0]
        p = self._problem(_LocalProblem, n, qs.shape[1], ts.shape[1])
        p.load(qs.to(self.dev), qlens.to(self.dev), ts.to(self.dev),
               tlens.to(self.dev),
               None if lines is None else lines.to(self.dev))
        self._rows(p, int(qlens.max()) if n else 0)
        s, qe, mat, aln, qb, tb, te = p.state[2][:, :n].cpu().unbind(0)
        return Local(score=s, qb=qb, qe=qe, tb=tb, te=te, aln=aln, mat=mat)
