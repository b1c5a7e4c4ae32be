"""Host-facing aligner: seeds on the host, fills on the device.

Bridges the per-pair host logic of the strand walk (strand_match) and the
banded local fill: k-mer diagonal seeding (ops/seed.py) produces the
nominal-line hint, the pair is padded to bucketed widths, and the
acceptance rule is the reference's (aln*2 > min(qlen, tlen) and
mat*100 >= aln*similarity_pct).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.consensus.star import bucket_len, pad_to
from ccsx_tpu_torch.ops import banded, banded_cuda, seed


@dataclasses.dataclass
class MatchResult:
    ok: bool
    score: int
    qb: int
    qe: int
    tb: int
    te: int
    aln: int
    mat: int


class HostAligner:
    """strand_match with the reference's acceptance rule."""

    def __init__(self, params: AlignParams = AlignParams(), quant: int = 512,
                 device="cuda"):
        self.params = params
        self.quant = quant
        self.device = torch.device(device)

    def _run(self, q: np.ndarray, t: np.ndarray,
             line: Optional[np.ndarray]) -> banded.BandedResult:
        dev = self.device
        qp = torch.from_numpy(pad_to(q, bucket_len(len(q), self.quant)))
        tp = torch.from_numpy(pad_to(t, bucket_len(len(t), self.quant)))
        lens = torch.tensor([[len(q)], [len(t)]], dtype=torch.int32)
        if line is None:
            lines = banded.corner_lines(lens[0], lens[1])
        else:
            lines = torch.from_numpy(np.asarray(line, np.int32)).reshape(1, 4)
        return banded_cuda.batched_align_local(
            qp[None].to(dev), lens[0].to(dev), tp[None].to(dev),
            lens[1].to(dev), lines.to(dev), params=self.params)

    def strand_match(self, q: np.ndarray, t: np.ndarray,
                     similarity_pct: int) -> Tuple[bool, MatchResult]:
        hit = seed.seed_diagonal(q, t)
        if hit is None:
            # no shared 13-mers at all: unalignable at >=60% identity
            return False, MatchResult(False, 0, 0, 0, 0, 0, 0, 0)
        # near-diagonal pairs don't need the hint; off-diagonal ones do
        line = hit.line if abs(hit.diag) > self.params.band // 4 else None
        res = self._run(q, t, line)
        score, qb, qe, tb, te, aln, mat = torch.stack(list(res)).cpu()[:, 0].tolist()
        rs = MatchResult(ok=False, score=score, qb=qb, qe=qe, tb=tb, te=te,
                         aln=aln, mat=mat)
        rs.ok = (rs.aln * 2 > min(len(q), len(t))) and (
            rs.mat * 100 >= rs.aln * similarity_pct)
        return rs.ok, rs
