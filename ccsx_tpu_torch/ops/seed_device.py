"""Batched k-mer seeding on the device: the exact twin of
ops/seed.seed_diagonal for a whole (qmax, tmax) group of strand-walk pairs
(sort, capped join, diagonal histogram, windowed argmax and the median
line), as tensor ops on the device the group lives on.

Equal to the host by construction (held by tests/test_torch_sketch.py):
the stable sort order and the capped first hits of ops/sketch's device
functions, np.argmax's first maximum, and int(np.median(...))'s
truncation toward zero of the two middle values' mean for an even count
(not torch.median, which returns the lower middle value).

``--seed-device-min-t`` (CcsConfig.seed_device_min_t) is the crossover:
templates at least that long seed here, shorter ones keep the host
sort-join with its per-template index cache; 0 seeds every pair on the
host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ccsx_tpu_torch.ops import seed as seed_mod
from ccsx_tpu_torch.ops import sketch as sketch_mod

MIN_VOTES = 3   # seed_diagonal's default, pinned


def seed_step(qmax: int, tmax: int):
    """The batched seeder: f(big (N, qmax+tmax) uint8 codes, small (N, 2)
    int32 lengths) -> (N, 8) int32 rows (found, diag, votes, i0, j0, i1,
    j1, total); found is 0 exactly when seed_diagonal returns None, and
    then every field but total is 0."""
    nb = (qmax + tmax) // sketch_mod.DIAG_BIN + 2
    # median sentinel: larger than any real diagonal of these shapes
    big_d = qmax + tmax + 2 * sketch_mod.DIAG_BIN

    def step(big: torch.Tensor, small: torch.Tensor) -> torch.Tensor:
        q, t = big[:, :qmax], big[:, qmax:qmax + tmax]
        qlen, tlen = small[:, 0], small[:, 1]
        cnt, left, order, qpos = sketch_mod._hits_dev(q, t)
        total = cnt.sum(1, dtype=torch.int32)
        hist, diags, inhit, lo = sketch_mod._diag_hist_dev(
            cnt, left, order, qpos, tlen, nb)
        best, votes = sketch_mod._best_window(hist)
        # the median of the hit diagonals inside the best two-bin window
        binned = torch.div(diags - lo[:, :, None], sketch_mod.DIAG_BIN,
                           rounding_mode="floor")
        b3 = best[:, None, None]
        inb = inhit & ((binned == b3) | (binned == b3 + 1))
        m = inb.sum((1, 2))
        sorted_d = torch.sort(torch.where(inb, diags, big_d).reshape(
            len(big), -1), dim=1).values
        a = sorted_d.gather(1, (torch.clamp(m - 1, min=0) // 2)[:, None])
        b = sorted_d.gather(1, (m // 2)[:, None])
        diag = torch.div(a[:, 0] + b[:, 0], 2, rounding_mode="trunc")
        i0 = torch.clamp(diag, min=0)
        j0 = i0 - diag
        i1 = torch.minimum(qlen, tlen + diag)
        j1 = i1 - diag
        found = (total > 0) & (votes >= MIN_VOTES)
        fields = [torch.where(found, x, 0)
                  for x in (torch.ones_like(diag), diag, votes, i0, j0, i1,
                            j1)]
        return torch.stack(fields + [total], dim=1).to(torch.int32)

    return step


def hit_from_row(row) -> Optional[seed_mod.SeedHit]:
    """One output row -> the host contract's SeedHit (or None), so the
    executor consumes either seeding path the same way."""
    row = [int(v) for v in row]
    if not row[0]:
        return None
    return seed_mod.SeedHit(diag=row[1], votes=row[2],
                            line=np.array(row[3:7], dtype=np.int32))
