"""Whole-read consensus — the reference's primitive `-P` path (ccs_for,
main.c:455-508), redesigned as a template-anchored star MSA.

The reference pushes all oriented passes into one POA graph and calls the
graph consensus (beg/push/end_bspoa, main.c:486-492).  Here the template
pass anchors a star MSA (consensus/star.py): banded global DP batched over
passes, traceback projection onto anchor coordinates, column vote, and
liberal-insert/strict-delete refinement rounds that recover the
cross-pass insertion reinforcement a POA graph provides natively.  The
rounds run on ``cfg.device`` through ``cfg.banded_impl``'s global fill.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.consensus import prepare as prep
from ccsx_tpu_torch.consensus.star import StarMsa
from ccsx_tpu_torch.ops import encode as enc


def consensus_passes(passes: List[np.ndarray], cfg: CcsConfig):
    """Consensus of oriented pass code arrays; passes[0] is the anchor.
    Returns codes, or (codes, phred_quals) under cfg.emit_quality."""
    sm = StarMsa(cfg.align, cfg.max_ins_per_col, cfg.len_bucket_quant,
                 cfg.device, cfg.banded_impl)
    return sm.consensus(passes, cfg.refine_iters, cfg.pass_buckets,
                        cfg.max_passes,
                        quality=((cfg.qv_coeffs, cfg.qv_cap)
                                 if cfg.emit_quality else None))


def ccs_whole_read(zmw, aligner, cfg: CcsConfig):
    """Full `-P` path for one ZMW (ccs_for, main.c:455-508): prepare ->
    orient -> star-MSA consensus.  Returns (seq_bytes, qual_bytes|None)
    per encode.to_record — the same contract as hole.ccs_hole — or
    None."""
    passes = prep.oriented_passes(zmw, aligner, cfg)
    if passes is None:  # main.c:460
        return None
    return enc.to_record(consensus_passes(passes, cfg))
