#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccsx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--parent-walk SRC] [--parent-rotband SRC ...]
                          [--kernels-only]

Phases, in order; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build every kernel from csrc/ (one nvcc per source, in parallel);
3. each kernel against its plain PyTorch version on the same CUDA inputs at
   the widths the main path gives it (global fill: 32 passes, qmax 2048,
   tmax 2560, plus an edge batch with a >4096-row final-flush window and
   the tie cases of ``synth.fill_tie_cases``; local fill: 5 kb and 15 kb
   pairs with and without a seeded line, the edge batch with other lines,
   the tie cases, also with their template rows padded to 32,768 bytes (the
   body with unpacked statistics); traceback walk: on the global fill's
   output, the edge batch's and the tie cases', random move bytes with
   lanes out of the band and edge lengths at max_ins 1, 4 and 16
   (``synth.walk_cases``), and R=200 passes; rotating-band fill: a packed
   slab of 128 rows over 4 holes' templates, qmax 2048, tmax 2560, also
   against the band-local kernel on the same inputs, plus the edge batch,
   the tie cases and ``synth.rotband_cases`` (band offsets through every
   (OFF % 4, d) pair)) — exact equality, all are integers.  The two fills'
   launch choice (W = 1, 2, 4 problems per block) is timed once at P=32,
   R=128 and the local table's shape, the walk's ring choices (rows per
   stage, stages, threads) at P=32, the walk's longest pass alone (its ns
   per row step), the rotating-band fill's ns a row (the slab's time over
   its longest query), and, with ``--parent-walk`` and
   ``--parent-rotband``, the parent commit's walk and rotating-band fill
   against this one's in turns;
4. the main path: the 64-hole scale corpus (synthesized from rng(42))
   through the port's CLI on the card in four arms — the default (the
   batched packed driver), ``--banded-impl rotband``, ``--pass-buckets
   4,8,16,32`` (the bucketed (Z, P) driver) and ``--batch off`` — twice
   each, alternating, and the bucketed arm once more under ``--banded-impl
   rotband``.  Each output must have the JAX package's pinned md5, no
   device step may fail over to its per-request replay, the driver's
   counters must show packed slabs and no bucketed group in a packed run
   and the reverse in a bucketed one, and the launch counts (reset just
   before and read just after each run) must show the default run going
   through the band-local fill, the local fill and the walk, the rotband
   run through the rotating-band fill, and each bucketed run through its
   arm's global fill and the walk.  A cold default run comes first (the
   CUDA modules of the torch ops load on first launch) and is reported
   apart; it records its local-fill groups, and the local fill's launch
   choices are timed on the one with the most rows.  Then the default and
   the rotband arm once more each under torch.profiler, for the device busy
   time by kernel and each kernel's device time per launch on the main
   path;
5. 8 HiFi-size holes (15 kb templates, at least 10 passes) through the CLI
   on the card (the batched driver); each consensus must reach identity
   >= 0.99 against its template;
6. the long-molecule corpus (benchmarks/long_molecule.py's 4x50000
   scenario: 4 holes, 50 kb templates, seed 11) through the CLI in three
   pre-alignment arms — the default (device seeding), ``--seed-device-min-t
   0`` (host seeding behind the device screen) and ``--prefilter off
   --seed-device-min-t 0`` (all host) — each to the JAX package's md5, with
   counters that show each route, the default arm's equal to the JAX
   package's; the local fill against its plain version on the default
   arm's recorded group with the longest query (50 kb rows, the body with
   unpacked statistics); then the default and the screen arm once more under
   torch.profiler, for the device time of the seed and screen steps (each
   call in a profiler range of its own) and the arms' device busy time.

The last lines are the kernels' JSON record, the card line, and
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")

SCALE64_MD5 = "0c83700d0fb67e3c89169f99574a9a2d"
SCALE64_BYTES = 188359
# the long-molecule corpus: benchmarks/long_molecule.py's 4x50000 scenario
# (4 holes, 50,000-base templates, 8 complete passes, seed 11), its flags
# and the JAX package's md5 and pre-alignment counters for its default arm
# (benchmarks/long_molecule_r11.json, confirmed on the JAX package's CPU
# run of the same corpus)
LONG_FLAGS = ["-A", "-m", "1000", "-M", "4000000", "--batch", "on",
              "--slab-rows", "32"]
LONG_MD5 = "1c9d8a68d1245c2b1c30becaa18a1f50"
LONG_COUNTS = {"pairs": 28, "pairs_screened": 55, "pairs_prefiltered": 27,
               "pairs_seeded_device": 56, "pairs_seeded_host": 0,
               "windows": 99}
LONG_ARMS = {"default": [], "screen": ["--seed-device-min-t", "0"],
             "host": ["--prefilter", "off", "--seed-device-min-t", "0"]}
BUCKETS = ["--pass-buckets", "4,8,16,32"]

# H100 SXM peaks used for the bounds: HBM rate from NVIDIA's data sheet; the
# INT32 rate is 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (Hopper white
# paper SM layout) — the integer rate these fills and the walk run at
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations of each kernel, tallied from its body in the source
# notes of csrc/banded_fill.cu, csrc/banded_rotband.cu and
# csrc/traceback_walk.cu: for the fills, per query row once (offset step,
# loop), per lane of the row's warp and per band cell; for the walk per
# step plus per move kind.  The rotating-band fill computes the same
# function as the band-local one, so both are bound by the smallest tally
# of any body that computes it (global_fill_ops): the band-local kernel's,
# 6,345 a row against the rotating-band warp body's 8,214
OPS_GLOBAL = dict(row=9, lane=70, cell=32)
OPS_ROTBAND = dict(row=22, lane=80, cell=44)
OPS_LOCAL = dict(row=9, lane=58, cell=57)
# the walk: the first design's cell walk, per cell step plus per move kind,
# and the row chain of csrc/traceback_walk.cu, per step that takes one row
# (an insertion), per jumped deletion run and per run of diagonals (28 on
# each of the walker warp's 32 lanes); the bound takes the smaller tally on
# each run's data, since the two compute one function
OPS_PER_STEP_WALK = 27
OPS_WALK_DIAG, OPS_WALK_INS, OPS_WALK_DEL = 5, 19, 7
OPS_WALK_ROW, OPS_WALK_RUN, OPS_WALK_DIAG_RUN = 40, 30, 32 * 28
# the profiler's kernel names, by the launch counter's names
PROFILE_NAMES = {"banded_global": "global_fill_kernel",
                 "banded_local": "local_fill_kernel",
                 "banded_rotband": "rotband_fill_kernel",
                 "traceback_walk": "walk_kernel"}
WARPS = (1, 2, 4)
# the walk's ring choices: rows per stage, stages, threads per block
WALK_RINGS = ((32, 2, 96), (32, 4, 96), (32, 8, 96), (64, 4, 96),
              (64, 8, 96), (32, 4, 128))
# --parent-walk SRC / --parent-rotband SRC: copies of the parent commit's
# csrc/traceback_walk.cu and csrc/banded_rotband.cu, timed against this
# checkout's kernels (never part of the checkout)
PARENT: dict = {}

SOURCES = {
    "banded_global": ("ccsx_tpu_torch/csrc/banded_fill.cu",
                      "ccsx_tpu/ops/banded_pallas.py:494"),
    "banded_local": ("ccsx_tpu_torch/csrc/banded_fill.cu",
                     "ccsx_tpu/ops/banded.py:133 (lax original, mode='local')"),
    "banded_rotband": ("ccsx_tpu_torch/csrc/banded_rotband.cu",
                       "ccsx_tpu/ops/banded_rotband.py:412"),
    "traceback_walk": ("ccsx_tpu_torch/csrc/traceback_walk.cu",
                       "ccsx_tpu/ops/traceback.py:173 (lax original)"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over reps CUDA-event-timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def fill_ops(rows: int, tally: dict) -> int:
    """Operations of ``rows`` query rows of a fill: per row, per lane of
    its warp (32) and per band cell (128)."""
    return rows * (tally["row"] + 32 * tally["lane"] + 128 * tally["cell"])


def global_fill_ops(rows: int) -> int:
    """The global function's operations: the smallest tally of the two
    bodies that compute it."""
    return min(fill_ops(rows, OPS_GLOBAL), fill_ops(rows, OPS_ROTBAND))


def _pad(x, n, fill=5):
    out = np.full(n, fill, np.uint8)
    out[:len(x)] = x
    return out


def global_inputs(rng, P, qmax, tmax, tlen, synth):
    """P noisy passes of one draft (the round's shape: one template row
    broadcast over the passes)."""
    t = rng.integers(0, 4, tlen).astype(np.uint8)
    qs = np.full((P, qmax), 5, np.uint8)
    qlens = np.zeros(P, np.int32)
    for k in range(P):
        q = synth.mutate(rng, t, 0.02, 0.05, 0.05)[:qmax]
        qs[k, :len(q)] = q
        qlens[k] = len(q)
    return qs, qlens, _pad(t, tmax), tlen


def edge_inputs(rng, synth):
    """qlen 0, a tiny query, qlen == qmax, an unreachable band, and a
    final-flush window longer than 4096 rows (past the Pallas cap)."""
    qmax, tmax = 5120, 5632
    t = rng.integers(0, 4, 5300).astype(np.uint8)
    long_q = synth.mutate(rng, t, 0.02, 0.05, 0.05)[:qmax]
    full_q = np.concatenate([long_q, rng.integers(0, 4, qmax).astype(np.uint8)])
    rows = [(np.zeros(0, np.uint8), t), (t[:7], t), (full_q[:qmax], t),
            (rng.integers(0, 4, 20).astype(np.uint8), t), (long_q, t)]
    qs = np.stack([_pad(q, qmax) for q, _ in rows])
    ts = np.stack([_pad(tt, tmax) for _, tt in rows])
    qlens = np.array([len(q) for q, _ in rows], np.int32)
    tlens = np.array([len(tt) for _, tt in rows], np.int32)
    return qs, qlens, ts, tlens


def slab_inputs(rng, R, qmax, tmax, holes, synth):
    """A packed slab's rows: R rows over ``holes`` templates, each row
    carrying its own hole's template (the packed round's per-row gather),
    the last row a padding row."""
    tpls = [rng.integers(0, 4, int(rng.integers(tmax - 500, tmax - 300))
                         ).astype(np.uint8) for _ in range(holes)]
    qs = np.full((R, qmax), 5, np.uint8)
    ts = np.full((R, tmax), 5, np.uint8)
    qlens = np.zeros(R, np.int32)
    tlens = np.zeros(R, np.int32)
    for r in range(R - 1):
        t = tpls[r % holes]
        q = synth.mutate(rng, t, 0.02, 0.05, 0.05)[:qmax]
        qs[r, :len(q)] = q
        qlens[r] = len(q)
        ts[r, :len(t)] = t
        tlens[r] = len(t)
    return qs, qlens, ts, tlens


def local_inputs(rng, synth, enc, seed):
    """5 kb and 15 kb strand-walk pairs: a forward pass, a wrong-strand
    pass, and an off-diagonal read-through-like query; each once with the
    corner line and once with its seeded line."""
    pairs = []
    for L in (5000, 15000):
        t = rng.integers(0, 4, L).astype(np.uint8)
        fwd = synth.mutate(rng, t, 0.02, 0.05, 0.05)
        wrong = enc.revcomp_codes(synth.mutate(rng, t, 0.02, 0.05, 0.05))
        shifted = np.concatenate([rng.integers(0, 4, 700).astype(np.uint8),
                                  fwd[: L - 500]])
        pairs += [(fwd, t), (wrong, t), (shifted, t)]
    qmax = max(len(q) for q, _ in pairs)
    tmax = max(len(t) for _, t in pairs)
    qs = np.stack([_pad(q, qmax) for q, _ in pairs])
    ts = np.stack([_pad(t, tmax) for _, t in pairs])
    qlens = np.array([len(q) for q, _ in pairs], np.int32)
    tlens = np.array([len(t) for _, t in pairs], np.int32)
    corner = np.stack([[0, 0, ql, tl] for ql, tl in zip(qlens, tlens)])
    seeded = []
    for (q, t), c in zip(pairs, corner):
        hit = seed.seed_diagonal(q, t)
        seeded.append(c if hit is None else hit.line)
    lines = np.concatenate([corner, np.stack(seeded)]).astype(np.int32)
    return (np.concatenate([qs, qs]), np.concatenate([qlens, qlens]),
            np.concatenate([ts, ts]), np.concatenate([tlens, tlens]), lines)


def phase_kernels(device, sizes=None):
    """Every kernel against its plain version on the same inputs; returns
    the per-kernel records (without launches)."""
    import torch

    from ccsx_tpu_torch.ops import banded, banded_cuda, banded_rotband
    from ccsx_tpu_torch.ops import encode as enc
    from ccsx_tpu_torch.ops import seed, traceback
    from ccsx_tpu_torch.utils import synth

    sizes = sizes or dict(P=32, qmax=2048, tmax=2560, tlen=2200, reps=20,
                          plain_reps=3, edges=True, local=True, R=128)
    rng = np.random.default_rng(1234)
    dev = torch.device(device)
    records = {}

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def max_err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    # ---- global fill + moves, at the round's shape ----
    qs, qlens, t, tlen = global_inputs(rng, sizes["P"], sizes["qmax"],
                                       sizes["tmax"], sizes["tlen"], synth)
    P = len(qs)
    q_t, ql_t = T(qs), T(qlens)
    t_t = T(t)[None].expand(P, sizes["tmax"])
    tl_t = torch.full((P,), tlen, dtype=torch.int32, device=dev)

    def run_kernel():
        return banded_cuda.batched_align_global_moves(q_t, ql_t, t_t, tl_t)

    def run_plain():
        return plain_global(q_t, ql_t, t_t, tl_t)

    def compare_global(k_out, p_out, qlens_np):
        (ks, km, ko), (ps, pm, po) = k_out, p_out
        err = max(max_err(ks, ps), max_err(ko, po))
        for i, ql in enumerate(qlens_np):
            err = max(err, max_err(km[i, :ql], pm[i, :ql]))
        return err

    def plain_global(*a):
        res, m, o = banded.banded_global_moves(*a)
        return res.score, m, o

    k_out = run_kernel()
    t0 = time.perf_counter()
    p_out = plain_global(q_t, ql_t, t_t, tl_t)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = compare_global(k_out, p_out, qlens)
    edges = [T(x) for x in edge_inputs(rng, synth)] if sizes["edges"] else None
    if edges:
        err = max(err, compare_global(
            banded_cuda.batched_align_global_moves(*edges),
            plain_global(*edges), edges[1].cpu().numpy()))
    # homopolymers, repeats, qlen 0/1/qmax, tlen < 128, a band clipped at
    # tcap: the cases where the tie rules decide
    ties = [T(x) for x in synth.fill_tie_cases(np.random.default_rng(31))]
    err = max(err, compare_global(
        banded_cuda.batched_align_global_moves(*ties[:4]),
        plain_global(*ties[:4]), ties[1].cpu().numpy()))
    if err:
        raise AssertionError(f"global fill differs from its plain version "
                             f"(max abs err {err})")
    rows = int(qlens.sum())
    nbytes = qs.size + t.size + 8 * P + P * sizes["qmax"] * (128 + 4) + 4 * P
    b_ms, b_by = bound_ms(nbytes, global_fill_ops(rows))
    records["banded_global"] = dict(
        max_abs_err=err, mismatches=0,
        ms=time_ms(run_kernel, sizes["reps"]),
        plain_ms=time_ms(run_plain, sizes["plain_reps"], warmup=0),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"P={P} qmax={sizes['qmax']} tmax={sizes['tmax']} band=128",
        warps_ms={f"P={P}": time_choices(dev, (q_t, ql_t, t_t, tl_t))})
    print(f"[chip_smoke] global fill: 0 mismatches vs plain, on the edge "
          f"batch and the tie cases ({time.perf_counter() - t0:.1f}s incl. "
          f"plain)", flush=True)

    # ---- rotating-band fill, at the packed slab's width ----
    R = sizes["R"]
    sq, sql, sts, stl = (T(x) for x in slab_inputs(
        rng, R, sizes["qmax"], sizes["tmax"], 4, synth))

    def run_rot():
        return banded_rotband.batched_align_global_moves(sq, sql, sts, stl)

    def run_rot_plain():
        return banded_rotband.rotband_global_moves(sq, sql, sts, stl)

    def run_local_layout():
        return banded_cuda.batched_align_global_moves(sq, sql, sts, stl)

    def compare_rot(args):
        """The rotating-band kernel against its plain version and the
        band-local kernel, moves compared in full (rows beyond qlen are
        zero in all three)."""
        out = banded_rotband.batched_align_global_moves(*args)
        every_row = np.full(len(args[0]), args[0].shape[1])
        return max(compare_global(out, banded_rotband.rotband_global_moves(
                       *args), every_row),
                   compare_global(out, banded_cuda.batched_align_global_moves(
                       *args), every_row))

    t0 = time.perf_counter()
    err = compare_rot((sq, sql, sts, stl))
    # the edge batch, the tie cases, and band offsets through every
    # (OFF % 4, d) pair with the ring wrapped several times
    if edges:
        err = max(err, compare_rot(edges))
    err = max(err, compare_rot(ties[:4]), compare_rot(
        [T(x) for x in synth.rotband_cases(np.random.default_rng(5))]))
    if err:
        raise AssertionError(f"rotating-band fill differs from its plain "
                             f"version or the band-local kernel (max abs err "
                             f"{err})")
    rows = int(sql.sum())
    longest = int(sql.max())
    nbytes = (sq.numel() + sts.numel() + 8 * R
              + R * sizes["qmax"] * (128 + 4) + 4 * R)
    b_ms, b_by = bound_ms(nbytes, global_fill_ops(rows))
    records["banded_global"]["warps_ms"][f"R={R}"] = time_choices(
        dev, (sq, sql, sts, stl))
    rot_ms = time_ms(run_rot, sizes["reps"])
    local_ms = time_ms(run_local_layout, sizes["reps"])
    records["banded_rotband"] = dict(
        max_abs_err=err, mismatches=0, ms=rot_ms,
        band_local_ms_same_inputs=local_ms,
        plain_ms=time_ms(run_rot_plain, sizes["plain_reps"], warmup=0),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"R={R} rows of 4 holes, qmax={sizes['qmax']} "
              f"tmax={sizes['tmax']} band=128",
        longest_query_rows=longest, ns_per_row=rot_ms * 1e6 / longest,
        band_local_ns_per_row=local_ms * 1e6 / longest,
        parent_ms=time_parent_rotband(dev, (sq, sql, sts, stl), run_rot,
                                      sizes["reps"]))
    print(f"[chip_smoke] rotating-band fill: 0 mismatches vs plain and vs "
          f"the band-local kernel, on the edge batch, the tie cases and the "
          f"rotband cases ({time.perf_counter() - t0:.1f}s incl. plain); "
          f"{rot_ms:.4f} ms vs band-local {local_ms:.4f} ms at R={R}, "
          f"{rot_ms * 1e6 / longest:.1f} vs {local_ms * 1e6 / longest:.1f} "
          f"ns a row of the longest query ({longest} rows)", flush=True)

    # ---- traceback walk on the global fill's output ----
    _, moves, offs = k_out
    tmax = sizes["tmax"]

    def run_walk():
        return traceback.project(moves, offs, q_t, ql_t, tl_t, tmax, 4)

    def run_walk_plain():
        return traceback.project_plain(moves, offs, q_t, ql_t, tl_t, tmax, 4)

    def walk_err(args, tmax_, max_ins):
        kw = traceback.project(*args, tmax_, max_ins)
        pw = traceback.project_plain(*args, tmax_, max_ins)
        return max(max_err(a, b) for a, b in zip(kw, pw))

    t0 = time.perf_counter()
    kw, pw = run_walk(), run_walk_plain()
    err = max(max_err(a, b) for a, b in zip(kw, pw))
    # the edge batch's and the tie cases' fill outputs, random move bytes
    # (out-of-band lanes, edge lengths, max_ins 1/4/16) and R=200 passes
    if edges:
        _, em, eo = banded_cuda.batched_align_global_moves(*edges)
        err = max(err, walk_err((em, eo, edges[0], edges[1], edges[3]),
                                edges[2].shape[1], 4))
    _, tm, to = banded_cuda.batched_align_global_moves(*ties[:4])
    err = max(err, walk_err((tm, to, ties[0], ties[1], ties[3]),
                            ties[2].shape[1], 4))
    for max_ins in (1, 4, 16):
        err = max(err, walk_err([T(x) for x in synth.walk_cases(
            np.random.default_rng(5), 256, 320)], 320, max_ins))
    err = max(err, walk_err([T(x) for x in synth.walk_cases(
        np.random.default_rng(6), 203, 251)], 251, 4))
    err = max(err, walk_err([T(x) for x in synth.walk_cases(
        np.random.default_rng(7), sizes["qmax"], tmax, n=200)], tmax, 4))
    if err:
        raise AssertionError(f"traceback walk differs from its plain version "
                             f"(max abs err {err})")
    # this run's paths: each pass's tlen columns are diagonals or deletions,
    # and its qlen is its diagonals plus insertions
    dels = int((kw[0][:, :tlen] == traceback.GAP).sum())
    diag = P * tlen - dels
    ins = int(qlens.sum()) - diag
    steps = walk_row_steps(kw, qlens, tlen)
    del_runs = int(steps.sum() - (qlens - kw[3].cpu().numpy()).sum())
    nbytes = (diag + ins + dels + P * sizes["qmax"] * 4 + qs.size
              + P * tmax * (1 + 4 + 4) + 4 * P)
    ops = min((diag + ins + dels) * OPS_PER_STEP_WALK + diag * OPS_WALK_DIAG
              + ins * OPS_WALK_INS + dels * OPS_WALK_DEL,
              ins * OPS_WALK_ROW + del_runs * OPS_WALK_RUN
              + walk_diag_runs(kw, tlen) * OPS_WALK_DIAG_RUN)
    b_ms, b_by = bound_ms(nbytes, ops)
    ms = time_ms(run_walk, sizes["reps"])
    # the chain alone: the longest pass (in row steps) by itself
    big = int(steps.argmax())
    one = [x[big:big + 1] for x in (moves, offs, q_t, ql_t, tl_t)]
    one_ms = time_ms(lambda: traceback.project(*one, tmax, 4), sizes["reps"])
    records["traceback_walk"] = dict(
        max_abs_err=err, mismatches=0, ms=ms,
        plain_ms=time_ms(run_walk_plain, sizes["plain_reps"], warmup=0),
        bound_ms=b_ms, bound_by=b_by, shape=f"P={P} tmax={tmax} max_ins=4",
        row_steps_longest_pass=int(steps[big]), longest_pass_ms=one_ms,
        ns_per_row_step=one_ms * 1e6 / int(steps[big]),
        ring_ms=time_rings(dev, (moves, offs, q_t, ql_t, tl_t), tmax),
        parent_ms=time_parent_walk(dev, (moves, offs, q_t, ql_t, tl_t), tmax,
                                   run_walk, sizes["reps"]))
    print(f"[chip_smoke] traceback walk: 0 mismatches vs plain, on the edge "
          f"batch, the tie cases, random bytes and R=200 "
          f"({time.perf_counter() - t0:.1f}s incl. plain); {ms:.4f} ms at "
          f"P={P}; longest pass {int(steps[big])} row steps in "
          f"{one_ms:.4f} ms = {one_ms * 1e6 / int(steps[big]):.1f} ns a step",
          flush=True)

    # ---- local fill + stats, at the strand walk's pair lengths ----
    if sizes["local"]:
        lq, lql, lt, ltl, lines = (T(x) for x in
                                   local_inputs(rng, synth, enc, seed))
    else:
        lq, lql, lt, ltl = q_t[:2], ql_t[:2], t_t[:2].contiguous(), tl_t[:2]
        lines = banded.corner_lines(lql, ltl)

    def run_local():
        return banded_cuda.batched_align_local(lq, lql, lt, ltl, lines)

    def compare_local(*a):
        kl = torch.stack(list(banded_cuda.batched_align_local(*a)))
        pl = torch.stack(list(banded.banded_local(*a)))
        err = max_err(kl, pl)
        if err:
            raise AssertionError(f"local fill differs from its plain version "
                                 f"(max abs err {err}): {kl.tolist()} vs "
                                 f"{pl.tolist()}")
        return err

    t0 = time.perf_counter()
    kl = torch.stack(list(run_local()))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    # the plain local fill takes tens of seconds here: one host-timed run
    # (it syncs with the card on every row) stands for its time
    tp = time.perf_counter()
    pl = torch.stack(list(banded.banded_local(lq, lql, lt, ltl, lines)))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - tp) * 1e3
    err = max_err(kl, pl)
    if err:
        raise AssertionError(f"local fill differs from its plain version "
                             f"(max abs err {err}): {kl.tolist()} vs "
                             f"{pl.tolist()}")
    if edges:
        err = max(err, compare_local(*edge_local(edges, seed)))
    # the tie cases, also with the template rows padded to 32,768 bytes:
    # the body with unpacked statistics (qmax + tmax + 128 >= 32768)
    wide = torch.full((len(ties[2]), 32768), 5, dtype=torch.uint8, device=dev)
    wide[:, :ties[2].shape[1]] = ties[2]
    err = max(err, compare_local(*ties),
              compare_local(*ties[:4], banded.corner_lines(ties[1], ties[3])),
              compare_local(ties[0], ties[1], wide, ties[3], ties[4]))
    rows = int(lql.sum())
    nbytes = lq.numel() + lt.numel() + 16 * len(lql) + 8 * len(lql) + 28 * len(lql)
    b_ms, b_by = bound_ms(nbytes, fill_ops(rows, OPS_LOCAL))
    records["banded_local"] = dict(
        max_abs_err=err, mismatches=0, ms=time_ms(run_local, sizes["reps"]),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        shape=f"n={len(lql)} pairs of 5 and 15 kb, corner and seeded lines",
        warps_ms={"table shape": time_choices(dev, (lq, lql, lt, ltl), lines)})
    print(f"[chip_smoke] local fill: 0 mismatches vs plain, on the edge batch "
          f"and the tie cases ({time.perf_counter() - t0:.1f}s incl. plain)",
          flush=True)
    return records


def edge_local(edges, seed):
    """The edge batch for the local fill: each problem once with its corner
    line and once with another (a line starting at li0 > 1, a seeded line,
    a falling line, a line whose slope is not a whole number)."""
    import torch

    qs, qlens, ts, tlens = edges
    ql = qlens.tolist()
    tl = tlens.tolist()
    q4 = qs[4, :ql[4]].cpu().numpy()
    hit = seed.seed_diagonal(q4, ts[4, :tl[4]].cpu().numpy())
    other = [[0, 0, 0, tl[0]], [2, 1, 7, 6],
             [60, 200, ql[2], tl[2] + 37], [5, 300, 200, 20],
             list(hit.line) if hit is not None else [0, 0, ql[4], tl[4]]]
    corner = [[0, 0, q, t] for q, t in zip(ql, tl)]
    lines = torch.tensor(corner + other, dtype=torch.int32, device=qs.device)
    return (torch.cat([qs, qs]), torch.cat([qlens, qlens]),
            torch.cat([ts, ts]), torch.cat([tlens, tlens]), lines)


def time_choices(dev, args, lines=None, reps=10):
    """Milliseconds of each launch choice of a fill on the same inputs, W
    problems per block ("not measured" off the card)."""
    from ccsx_tpu_torch.ops import banded_cuda

    if dev.type != "cuda":
        return "not measured"
    out = {}
    for w in WARPS:
        out[f"W={w}"] = time_ms(lambda: banded_cuda.launch_variant(
            *args, w, lines), reps)
    print(f"[chip_smoke]   launch choices, {len(args[0])} problems: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items()), flush=True)
    return out


def walk_row_steps(walk_out, qlens, tlen):
    """Each pass's row steps in the walk kernel's chain: one per query row
    consumed before column 0, plus one per deletion run (a maximal run of
    GAP columns with no insertion slot inside it)."""
    aligned, ins_cnt, _, lead = (x.cpu().numpy() for x in walk_out)
    gap = aligned[:, :tlen] == 4
    nxt = np.concatenate([gap[:, 1:], np.zeros((len(gap), 1), bool)], 1)
    runs = (gap & ~(nxt & (ins_cnt[:, :tlen] == 0))).sum(1)
    return (qlens - lead) + runs


def walk_diag_runs(walk_out, tlen):
    """The maximal runs of diagonal columns (no insertion slot inside) of
    every pass: the steps the walker warp takes down the diagonal (at
    least)."""
    aligned, ins_cnt = (x.cpu().numpy() for x in walk_out[:2])
    diag = aligned[:, :tlen] != 4
    nxt = np.concatenate([diag[:, 1:], np.zeros((len(diag), 1), bool)], 1)
    return int((diag & ~(nxt & (ins_cnt[:, :tlen] == 0))).sum())


def time_rings(dev, args, tmax, reps=10):
    """Milliseconds of each ring choice of the walk on the same inputs:
    rows per stage, stages, threads per block ("not measured" off the
    card)."""
    from ccsx_tpu_torch.ops import traceback

    if dev.type != "cuda":
        return "not measured"
    out = {}
    for rows, stages, threads in WALK_RINGS:
        out[f"T={rows} S={stages} threads={threads}"] = time_ms(
            lambda: traceback.launch_variant(*args, tmax, 4, rows, stages,
                                             threads), reps)
    print("[chip_smoke]   walk rings: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in out.items()), flush=True)
    return out


def time_parent_walk(dev, args, tmax, run_walk, reps):
    """The parent commit's walk kernel against this one on the same inputs,
    in turns (parent, new, new, parent), when ``--parent-walk SRC`` names a
    copy of its source; None otherwise.  Its outputs must equal this
    kernel's."""
    import ctypes

    import torch

    from ccsx_tpu_torch.ops import cuda_ext

    src = PARENT.get("walk")
    if not src or dev.type != "cuda":
        return None
    lib = ctypes.CDLL(build_parent(src, "parent_walk.so"))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    lib.ccsx_traceback_walk.argtypes = [P_, P_, P_, I_, P_, P_, I_, I_, P_,
                                        P_, P_, P_, I_, P_]
    moves, offs, qs, qlens, tlens = args
    n, qmax, _ = moves.shape
    out = (torch.empty((n, tmax), dtype=torch.uint8, device=dev),
           torch.empty((n, tmax), dtype=torch.int32, device=dev),
           torch.empty((n, tmax, 4), dtype=torch.uint8, device=dev),
           torch.empty((n,), dtype=torch.int32, device=dev))

    def run_parent():
        rc = lib.ccsx_traceback_walk(
            moves.data_ptr(), offs.data_ptr(), qs.data_ptr(), qmax,
            qlens.data_ptr(), tlens.data_ptr(), tmax, 4,
            *(x.data_ptr() for x in out), n, cuda_ext.stream_ptr(dev))
        if rc:
            raise AssertionError(f"parent walk launch failed ({rc})")

    run_parent()
    for a, b in zip(out, run_walk()):
        if not torch.equal(a, b):
            raise AssertionError("the parent's walk and this one differ")
    times = [time_ms(f, reps) for f in (run_parent, run_walk, run_walk,
                                        run_parent)]
    print("[chip_smoke]   walk, parent / new / new / parent: "
          + " / ".join(f"{t:.4f}" for t in times) + " ms", flush=True)
    return {"order": "parent, new, new, parent", "ms": times}


def build_parent(src, name):
    """A parent commit's kernel source, built as the checkout's are, into
    WORK/name; returns the library's path."""
    from ccsx_tpu_torch.ops import cuda_ext

    so = os.path.join(WORK, name)
    subprocess.run([cuda_ext._nvcc(), *cuda_ext.NVCC_FLAGS, "-o", so, src],
                   check=True, capture_output=True, timeout=600)
    return so


def time_parent_rotband(dev, args, run_rot, reps):
    """Each source named by ``--parent-rotband`` (the parent commit's
    rotating-band fill, or any earlier version) against this one on the
    same inputs, in turns (parent, new, new, parent): {source: times}, or
    None without one.  Their outputs must equal this kernel's."""
    if not PARENT.get("rotband") or dev.type != "cuda":
        return None
    return {src: time_one_parent_rotband(dev, args, run_rot, reps, src, k)
            for k, src in enumerate(PARENT["rotband"])}


def time_one_parent_rotband(dev, args, run_rot, reps, src, k):
    import ctypes

    import torch

    from ccsx_tpu_torch.config import AlignParams
    from ccsx_tpu_torch.ops import cuda_ext

    lib = ctypes.CDLL(build_parent(src, f"parent_rotband{k}.so"))
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ccsx_banded_rotband.argtypes = [P_, I_, P_, P_, L_, I_, P_, I_, I_,
                                        I_, I_, P_, P_, P_, I_, P_]
    qs, qlens, ts, tlens = args
    n, qmax = qs.shape
    p = AlignParams()
    out = (torch.empty((n,), dtype=torch.int32, device=dev),
           torch.empty((n, qmax, 128), dtype=torch.uint8, device=dev),
           torch.empty((n, qmax), dtype=torch.int32, device=dev))

    def run_parent():
        rc = lib.ccsx_banded_rotband(
            qs.data_ptr(), qmax, qlens.data_ptr(), ts.data_ptr(),
            ts.stride(0), ts.shape[1], tlens.data_ptr(), p.match, p.mismatch,
            p.gap_open, p.gap_extend, out[1].data_ptr(), out[2].data_ptr(),
            out[0].data_ptr(), n, cuda_ext.stream_ptr(dev))
        if rc:
            raise AssertionError(f"parent rotband launch failed ({rc})")

    run_parent()
    for a, b in zip(out, run_rot()):
        if not torch.equal(a, b):
            raise AssertionError("the parent's rotating-band fill and this "
                                 "one differ")
    times = [time_ms(f, reps) for f in (run_parent, run_rot, run_rot,
                                        run_parent)]
    print(f"[chip_smoke]   rotating-band fill, parent ({src}) / new / new / "
          "parent: " + " / ".join(f"{t:.4f}" for t in times) + " ms",
          flush=True)
    return {"order": "parent, new, new, parent", "ms": times}


def run_cli(argv, what, record=None):
    """cli.main(argv) under -v with its stderr captured (echoed without the
    per-hole segment dump); returns (seconds, launch counts reset just
    before, the driver's counters from -v's last stderr line).  A
    ``record`` list receives a copy of the inputs of every local-fill
    launch of the run (its groups of strand-walk pairs)."""
    import contextlib
    import io

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.ops import banded_cuda, cuda_ext

    err = io.StringIO()
    local = banded_cuda.batched_align_local
    if record is not None:
        def recording(*a, **k):
            record.append([x.clone() for x in a[:5]])
            return local(*a, **k)
        banded_cuda.batched_align_local = recording
    try:
        cuda_ext.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["-v", *argv])
        secs = time.perf_counter() - t0
        counts = dict(cuda_ext.LAUNCHES)
    finally:
        banded_cuda.batched_align_local = local
    text = err.getvalue()
    sys.stderr.write("".join(line for line in text.splitlines(True)
                             if " segment offs=" not in line))
    if rc != 0:
        raise AssertionError(f"CLI {what} exited {rc}")
    if "device step failed" in text:
        raise AssertionError(f"CLI {what}: a device step failed over to its "
                             "per-request replay")
    last = text.strip().splitlines()[-1]
    driver = {k: int(v) for k, v in (kv.split("=", 1) for kv in last.split()
                                     if "=" in kv) if v.isdigit()}
    if driver.get("failed_steps") or driver.get("host_replays"):
        raise AssertionError(f"CLI {what}: device steps failed over to their "
                             f"replay: {driver}")
    return secs, counts, driver


def phase_scale64(device, extra=(), n_holes=64, record=None):
    """The 64-hole scale corpus through the CLI; returns (seconds, launch
    counts, driver counters).  No device step may fail over to its
    per-request replay.  A ``record`` list receives a copy of the inputs of
    every local-fill launch (its groups of strand-walk pairs)."""
    from ccsx_tpu_torch.utils import synth

    bam = os.path.join(WORK, "in64.bam")
    out = os.path.join(WORK, "out64.fa")
    if not os.path.exists(bam):
        synth.make_big_bam(bam, n_holes, np.random.default_rng(42))
    secs, counts, driver = run_cli(["--device", device, *extra, bam, out],
                                   f"{list(extra)} on the scale corpus",
                                   record)
    data = open(out, "rb").read()
    md5 = hashlib.md5(data).hexdigest()
    grouping = {k: driver[k] for k in ("slabs", "bucketed_groups",
                                       "bucketed_dispatches") if k in driver}
    print(f"[chip_smoke] scale corpus {list(extra) or 'default'}: {n_holes} "
          f"holes in {secs:.3f}s ({n_holes / secs:.2f} holes/s), "
          f"{len(data)} bytes, md5 {md5}, launches {counts}, grouping "
          f"{grouping}", flush=True)
    if n_holes == 64 and (md5 != SCALE64_MD5 or len(data) != SCALE64_BYTES):
        raise AssertionError(f"scale corpus output {md5}/{len(data)} != "
                             f"pinned {SCALE64_MD5}/{SCALE64_BYTES}")
    bucketed = "--pass-buckets" in extra
    if "--batch" not in extra and (
            bool(driver.get("slabs")) == bucketed
            or bool(driver.get("bucketed_groups")) != bucketed):
        raise AssertionError(f"CLI {list(extra)}: the wrong grouping ran "
                             f"({grouping})")
    return secs, counts, driver


def profile_cli(argv, what):
    """One CLI run under torch.profiler, with each device screen and device
    seed step inside a ``record_function`` range named after it: the wall,
    the device time summed by kernel name, each port kernel's device time
    per launch, and each step kind's device time (its range's kernels) and
    CUDA-event span.  Returns that record, or None when the profiler records
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.ops import cuda_ext

    cuda_ext.reset_counts()
    with StepTimer() as steps, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = dict(cuda_ext.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"CLI {what} exited {rc} under the profiler")
    cpu = torch.autograd.DeviceType.CPU
    ranges = {}
    for ev in prof.events():
        # a CPU range's device time is that of the kernels launched in it
        if ev.name in steps.spans and ev.device_type == cpu:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = getattr(ev, "cuda_time_total", 0)
            ranges[ev.name] = ranges.get(ev.name, 0.0) + us / 1e3
    by = {}
    for ev in prof.key_averages():
        if ev.key in steps.spans:
            continue       # the ranges themselves, never device busy
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            by[ev.key] = us / 1e6
    if not by:
        print(f"[chip_smoke] profile of {what}: no device time recorded (not "
              "measured)")
        return None
    dev_s = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    per_launch = {}
    for name, sym in PROFILE_NAMES.items():
        t = sum(v for k, v in by.items() if sym in k)
        if counts[name]:
            per_launch[name] = t * 1e3 / counts[name]
    step_ms = {k: {"calls": len(v),
                   "device_ms": ranges.get(k) or "not measured",
                   "event_span_ms": sum(a.elapsed_time(b) for a, b in v)}
               for k, v in steps.spans.items() if v}
    print(f"[chip_smoke] profile of {what}: wall {wall:.3f}s (under the "
          f"profiler), device busy {dev_s:.3f}s ({100 * dev_s / wall:.1f}%), "
          f"launches {counts}", flush=True)
    for k, v in top:
        print(f"[chip_smoke]   {v * 1e3:9.2f} ms  {k[:90]}")
    print("[chip_smoke]   device ms per launch: " + ", ".join(
        f"{k} {v:.4f}" for k, v in per_launch.items()), flush=True)
    for k, v in step_ms.items():
        print(f"[chip_smoke]   {k}: {v['calls']} calls, device time "
              f"{v['device_ms']} ms (its kernels), {v['event_span_ms']:.3f} ms "
              "between CUDA events", flush=True)
    return {"wall_s": wall, "device_s": dev_s,
            "top_kernels": [[k[:80], v] for k, v in top],
            "ms_per_launch": per_launch, "steps": step_ms}


def phase_profile(device, extra=()):
    """Where the scale corpus's time goes: a run of one arm again under the
    profiler (profile_cli)."""
    return profile_cli(["--device", device, *extra,
                        os.path.join(WORK, "in64.bam"),
                        os.path.join(WORK, "out64_prof.fa")],
                       f"the scale corpus {list(extra) or 'default'}")


def phase_hifi(device, n_holes=8, tlen=15000, min_identity=0.99,
               min_passes=10):
    """HiFi-size holes through the CLI; every consensus must reach
    min_identity against its template (oracle alignment, the strand picked
    by k-mer votes)."""
    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.io import fastx
    from ccsx_tpu_torch.ops import encode as enc
    from ccsx_tpu_torch.ops import oracle, seed
    from ccsx_tpu_torch.utils import synth

    rng = np.random.default_rng(15000)
    # HiFi depth: the log-normal pass counts floored at 10.  Unfloored, this
    # seed draws a 7-pass hole that reaches only ~0.989 at these error
    # rates, and the JAX package gives the same bytes for it
    # (tests/test_torch_hifi.py pins both on the CPU)
    counts = synth.sample_pass_counts(rng, n_holes, lo=min_passes)
    zs = [synth.make_zmw(rng, tlen, int(c), movie="hifi", hole=str(h),
                         **synth.ERR) for h, c in enumerate(counts)]
    src = os.path.join(WORK, "hifi.fa")
    out = os.path.join(WORK, "hifi_out.fa")
    with open(src, "w") as f:
        f.write(synth.make_fasta(zs))
    bases_in = sum(len(p) for z in zs for p in z.passes)
    t0 = time.perf_counter()
    rc = cli.main(["-A", "--device", device, src, out])
    secs = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI exited {rc} on the HiFi-size holes")
    got = {r.name: enc.encode(r.seq) for r in fastx.read_fastx(out)}
    idents = []
    for z in zs:
        cons = got.get(f"{z.movie}/{z.hole}/ccs")
        if cons is None:
            raise AssertionError(f"no consensus for hole {z.hole}")
        fwd = seed.seed_diagonal(cons, z.template)
        rev = seed.seed_diagonal(enc.revcomp_codes(cons), z.template)
        if (rev.votes if rev else 0) > (fwd.votes if fwd else 0):
            cons = enc.revcomp_codes(cons)
        idents.append(oracle.align(cons, z.template, mode="global").identity)
        print(f"[chip_smoke] HiFi hole {z.hole}: {len(z.passes)} passes, "
              f"identity {idents[-1]:.5f}", flush=True)
    print(f"[chip_smoke] HiFi-size: {n_holes} holes x {tlen} bp, "
          f"{bases_in} subread bases in {secs:.2f}s "
          f"({bases_in / secs:.0f} bases/s), identity min "
          f"{min(idents):.5f} mean {np.mean(idents):.5f}", flush=True)
    if min(idents) < min_identity:
        raise AssertionError(f"identity {min(idents):.5f} < {min_identity}")
    return secs, bases_in, idents


class StepTimer:
    """Puts each device screen and device seed step launched inside the
    block in a profiler range named after it, between two CUDA events, by
    wrapping the two step factories; ``spans[name]`` holds the events."""

    NAMES = ("screen_step", "seed_step")

    def __enter__(self):
        import torch

        from ccsx_tpu_torch.ops import seed_device, sketch

        self.spans = {n: [] for n in self.NAMES}
        self._mods = {"screen_step": sketch, "seed_step": seed_device}
        self._real = {n: getattr(m, n) for n, m in self._mods.items()}
        for name, real in self._real.items():
            def factory(qmax, tmax, _real=real, _name=name):
                step = _real(qmax, tmax)

                def timed(big, small):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    with torch.profiler.record_function(_name):
                        a.record()
                        out = step(big, small)
                        b.record()
                    self.spans[_name].append((a, b))
                    return out
                return timed
            setattr(self._mods[name], name, factory)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(self._mods[name], name, real)


def phase_long(device):
    """The long-molecule corpus (benchmarks/long_molecule.py's 4x50000
    scenario, synthesized here from its seed) through the CLI in the three
    pre-alignment arms: the default (templates of 16,384 bases and more
    seed on the device), --seed-device-min-t 0 (every pair seeds on the
    host, and the long ones are screened on the device first) and
    --prefilter off --seed-device-min-t 0 (all on the host).  Each must
    give the JAX package's md5; the counters must show each route ran, and
    the default arm's must equal the JAX package's.  Then the default and
    the screen arm once more each under the profiler, for the device time
    of the seed and screen steps.  Returns ({arm: record}, {arm: profile})."""
    from ccsx_tpu_torch.utils import synth

    fa = os.path.join(WORK, "long.fa")
    synth.make_long_fasta(fa, 4, 50000, 8, 11)
    arms = {}
    groups = []
    for arm, extra in LONG_ARMS.items():
        out = os.path.join(WORK, f"long_{arm}.fa")
        secs, launches, driver = run_cli(
            [*LONG_FLAGS, "--device", device, *extra, fa, out],
            f"{extra} on the long-molecule corpus",
            groups if arm == "default" else None)
        md5 = hashlib.md5(open(out, "rb").read()).hexdigest()
        keys = ("pairs", "pairs_screened", "pairs_prefiltered",
                "pairs_seeded_device", "pairs_seeded_host", "screen_steps",
                "seed_steps", "pair_fills", "windows", "slabs", "out")
        counters = {k: driver.get(k, 0) for k in keys}
        arms[arm] = {"seconds": secs, "md5": md5, "counters": counters,
                     "launches": launches}
        print(f"[chip_smoke] long-molecule {arm} {extra}: {secs:.3f}s, md5 "
              f"{md5}, counters {counters}, local-fill launches "
              f"{launches['banded_local']}, launches {launches}", flush=True)
        if md5 != LONG_MD5:
            raise AssertionError(f"long-molecule {arm}: md5 {md5} != pinned "
                                 f"{LONG_MD5}")
        dev, scr = counters["pairs_seeded_device"], counters["screen_steps"]
        ok = {"default": dev > 0 and counters["seed_steps"] > 0,
              "screen": dev == 0 and scr > 0 and counters["pairs_screened"] > 0,
              "host": dev == 0 and scr == 0
              and counters["pairs_screened"] == 0}[arm]
        if not ok or launches["banded_local"] <= 0:
            raise AssertionError(f"long-molecule {arm}: the counters do not "
                                 f"show the arm's route: {counters}")
    got = {k: arms["default"]["counters"][k] for k in LONG_COUNTS}
    if got != LONG_COUNTS:
        raise AssertionError(f"long-molecule default counters {got} != the "
                             f"JAX package's {LONG_COUNTS}")
    arms["default"]["local_fill_check"] = check_local_group(groups)
    profiles = {arm: profile_cli(
        [*LONG_FLAGS, "--device", device, *LONG_ARMS[arm], fa,
         os.path.join(WORK, f"long_{arm}_prof.fa")],
        f"the long-molecule corpus, {arm} arm") for arm in ("default",
                                                             "screen")}
    return arms, profiles


def check_local_group(groups):
    """The local fill against its plain version on one group that the
    long-molecule default arm launched it on, the same CUDA tensors: the
    group with the longest query (the unpacked-statistics body at 50 kb
    rows; the plain version's time grows with the query rows, not the
    pairs).  Every output of every pair must be equal."""
    import torch

    from ccsx_tpu_torch.ops import banded, banded_cuda

    if not groups:
        raise AssertionError("the long-molecule default arm launched no "
                             "local fill")
    qs, qlens, ts, tlens, lines = max(
        groups, key=lambda g: (int(g[1].max()), len(g[1])))
    qmax, tmax = qs.shape[1], ts.shape[1]
    if qmax + tmax + 128 < 32768:
        raise AssertionError(f"the long-molecule local fill group "
                             f"(qmax {qmax}, tmax {tmax}) does not reach the "
                             "unpacked-statistics body")
    kl = torch.stack(list(banded_cuda.batched_align_local(
        qs, qlens, ts, tlens, lines)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pl = torch.stack(list(banded.banded_local(qs, qlens, ts, tlens, lines)))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    mismatches = int((kl != pl).sum())
    rec = {"pairs": len(qlens), "qmax": qmax, "tmax": tmax,
           "query_rows_max": int(qlens.max()), "mismatches": mismatches,
           "max_abs_err": int((kl.long() - pl.long()).abs().max()),
           "plain_s": plain_s}
    print(f"[chip_smoke] long-molecule local fill vs plain on its recorded "
          f"group ({len(groups)} recorded): {rec}", flush=True)
    if mismatches:
        raise AssertionError(f"local fill differs from its plain version on "
                             f"the long-molecule group: {kl.tolist()} vs "
                             f"{pl.tolist()}")
    return rec


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-walk", metavar="SRC",
                    help="a copy of the parent commit's traceback_walk.cu, "
                         "timed against this walk in phase 3")
    ap.add_argument("--parent-rotband", metavar="SRC", nargs="+",
                    help="a copy of the parent commit's banded_rotband.cu "
                         "(or of any earlier version; several are timed one "
                         "after another), timed against this rotating-band "
                         "fill in phase 3")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 3 (the kernels against their "
                         "plain versions), printing their records")
    args = ap.parse_args(argv)
    PARENT.update(walk=args.parent_walk, rotband=args.parent_rotband or ())
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import ccsx_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    if not os.path.abspath(ccsx_tpu_torch.__file__).startswith(HERE + os.sep):
        print("chip_smoke: ccsx_tpu_torch resolves outside this checkout",
              file=sys.stderr)
        return 1
    from ccsx_tpu_torch.ops import cuda_ext

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[chip_smoke] card: {card} | torch: {name} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    secs, logs = cuda_ext.timed_build(ptxas_verbose=True)
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"[chip_smoke] ptxas {src}: {line.strip()}")
    print(f"[chip_smoke] build: {secs:.1f}s for {len(cuda_ext.SOURCES)} "
          "sources", flush=True)

    records = phase_kernels("cuda")
    if args.kernels_only:
        print(json.dumps({"kernels": records}))
        return 0
    # a first run loads the CUDA modules of the torch ops the drivers use
    # (lazily, on first launch): the cold run a user's first CLI call sees,
    # reported apart from the warm reruns
    groups = []
    cold_s, _, _ = phase_scale64("cuda", record=groups)
    print(f"[chip_smoke] cold first run of the scale corpus: {cold_s:.3f}s "
          f"(recording its {len(groups)} local-fill groups)", flush=True)
    # the local fill's launch choices on the scale corpus's own group with
    # the most query rows
    big = max(groups, key=lambda g: int(g[1].sum()))
    records["banded_local"]["warps_ms"][
        f"SCALE64 group, {len(big[0])} pairs, qmax {big[0].shape[1]}"] = \
        time_choices(torch.device("cuda"), big[:4], big[4])
    arms = {"batched": [], "rotband": ["--banded-impl", "rotband"],
            "bucketed": BUCKETS, "per_hole": ["--batch", "off"]}
    reps = {k: [] for k in arms}
    for _ in range(2):     # alternating, so a drift falls on every arm alike
        for k, extra in arms.items():
            reps[k].append(phase_scale64("cuda", extra))
    for k, rr in reps.items():
        if rr[0][1] != rr[1][1]:
            raise AssertionError(f"SCALE64 {k}: launch counts differ between "
                                 f"reruns: {rr[0][1]} vs {rr[1][1]}")
    runs = {k: rr[0] for k, rr in reps.items()}
    # the bucketed path under the other global-fill arm, once
    buck_rot = phase_scale64("cuda", BUCKETS + arms["rotband"])
    prof = phase_profile("cuda")
    prof_rot = phase_profile("cuda", arms["rotband"])
    hifi_s, hifi_bases, idents = phase_hifi("cuda")
    long_arms, long_prof = phase_long("cuda")
    # each kernel's launches on the run of the main path that carries it
    launches = {k: runs["rotband" if k == "banded_rotband" else "batched"][1][k]
                for k in SOURCES}
    for name_k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name_k} never launched on the "
                                 "main path")
    if runs["batched"][1]["banded_rotband"] or runs["rotband"][1][
            "banded_global"]:
        raise AssertionError("a global-fill arm launched the other arm's "
                             "kernel")
    for arm, (_, counts, _) in (("bucketed", runs["bucketed"]),
                                ("bucketed rotband", buck_rot)):
        want = ("banded_rotband" if "rotband" in arm else "banded_global",
                "traceback_walk")
        other = "banded_global" if "rotband" in arm else "banded_rotband"
        if min(counts[k] for k in want) <= 0 or counts[other]:
            raise AssertionError(f"SCALE64 {arm}: launches {counts} do not "
                                 f"show {want} alone")
    print(f"[chip_smoke] SCALE64 walls (warm, in-process; cold first run "
          f"{cold_s:.3f}s): " + ", ".join(
              f"{k} " + " / ".join(f"{r[0]:.3f}s ({64 / r[0]:.2f} holes/s)"
                                   for r in rr)
              for k, rr in reps.items())
          + f", bucketed rotband {buck_rot[0]:.3f}s", flush=True)
    # each kernel's device time per launch in the profiled run of its arm
    per_launch = {k: ((prof_rot if k == "banded_rotband" else prof) or {}
                      ).get("ms_per_launch", {}).get(k) for k in SOURCES}
    kernels = [dict(name=k, route="cuda", source=SOURCES[k][0],
                    replaces=SOURCES[k][1], launches=launches[k],
                    library_ms=None, main_path_ms_per_launch=per_launch[k],
                    **records[k]) for k in SOURCES]
    print(json.dumps({"kernels": kernels,
                      "scale64": {k: {"seconds": [r[0] for r in rr],
                                      "holes_per_s": [64 / r[0] for r in rr],
                                      "launches": rr[0][1],
                                      "grouping": {g: rr[0][2][g] for g in (
                                          "slabs", "bucketed_groups",
                                          "bucketed_dispatches")
                                          if g in rr[0][2]}}
                                  for k, rr in reps.items()}
                      | {"bucketed_rotband_s": buck_rot[0],
                         "cold_first_run_s": cold_s,
                         "profile_batched": prof,
                         "profile_rotband": prof_rot},
                      "hifi": {"seconds": hifi_s,
                               "bases_per_s": hifi_bases / hifi_s,
                               "min_identity": min(idents)},
                      "long_molecule": {"arms": long_arms,
                                        "profiles": long_prof}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
