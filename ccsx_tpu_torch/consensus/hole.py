"""Per-hole consensus entry points shared by the per-hole and batched
pipelines: one function selects the consensus generator for a ZMW
(windowed by default, whole-read star MSA under -P — main.c:701-704), so
the two pipelines cannot drift apart in prep or mode selection.
"""

from __future__ import annotations

from typing import Optional

from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.consensus import prepare as prep
from ccsx_tpu_torch.consensus.star import StarMsa, run_rounds
from ccsx_tpu_torch.consensus.windowed import windowed_gen
from ccsx_tpu_torch.ops import encode as enc


def _traced(gen, tag: str):
    """Wrap a consensus generator with the reference's -v level-2 logs
    ('poa begin/end' per hole, main.c:466-467,521-522,645-646)."""
    import sys

    print(f"[ccsx-tpu] consensus begin {tag}", file=sys.stderr)
    result = yield from gen
    print(f"[ccsx-tpu] consensus end {tag}", file=sys.stderr)
    return result


def _consensus_gen_for_passes(passes, zmw, cfg: CcsConfig):
    if cfg.split_subread:
        gen = windowed_gen(passes, cfg)
    else:
        sm = StarMsa(cfg.align, cfg.max_ins_per_col, cfg.len_bucket_quant,
                 cfg.device)
        gen = sm.consensus_gen(
            passes, cfg.refine_iters, cfg.pass_buckets, cfg.max_passes,
            quality=((cfg.qv_coeffs, cfg.qv_cap)
                     if cfg.emit_quality else None))
    if cfg.verbose >= 2:
        gen = _traced(gen, f"{zmw.movie}/{zmw.hole}")
    return gen


def consensus_gen_for_zmw(zmw, aligner, cfg: CcsConfig):
    """The consensus generator for one hole, or None if it is skipped.
    Prep runs synchronously here (per-pair dispatches via `aligner`); the
    batched pipeline uses full_gen_for_zmw instead."""
    passes = prep.oriented_passes(zmw, aligner, cfg)
    if passes is None:
        return None
    return _consensus_gen_for_passes(passes, zmw, cfg)


def full_gen_for_zmw(zmw, cfg: CcsConfig):
    """Combined prep + consensus generator for one hole.

    Yields prepare.PairRequest during the orientation walk, then
    star.RefineRequest during consensus (the driver dispatches on type,
    batching each across holes); returns the consensus codes (or None
    for a skipped hole) via StopIteration.value.
    """
    if zmw.n_passes < 3:  # main.c:460,515
        return None
    codes = enc.encode(zmw.seqs)
    segments = yield from prep.ccs_prepare_gen(codes, zmw.lens, zmw.offs,
                                               cfg)
    passes = prep.passes_from_segments(codes, segments, zmw, cfg)
    result = yield from _consensus_gen_for_passes(passes, zmw, cfg)
    return result


def _counted(gen, stats: dict):
    """Count the generator's device requests (one RefineRequest per
    window attempt) into stats['windows']."""
    try:
        req = next(gen)
        while True:
            stats["windows"] = stats.get("windows", 0) + 1
            rr = yield req
            req = gen.send(rr)
    except StopIteration as e:
        return e.value


def ccs_hole(zmw, aligner, cfg: CcsConfig,
             stats: Optional[dict] = None):
    """Per-hole path: run the hole's generator with immediate rounds.
    Returns (seq_bytes, qual_bytes|None) per encode.to_record, or None
    for a skipped hole.

    stats, if given, receives per-hole counters ('windows': window
    refinements run) so the driver can aggregate them thread-safely on
    its own side.
    """
    gen = consensus_gen_for_zmw(zmw, aligner, cfg)
    if gen is None:
        return None
    if stats is not None:
        gen = _counted(gen, stats)
    sm = StarMsa(cfg.align, cfg.max_ins_per_col, cfg.len_bucket_quant,
                 cfg.device)
    return enc.to_record(run_rounds(gen, sm))
