#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccsx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build every kernel from csrc/ (one nvcc per source, in parallel);
3. each kernel against its plain PyTorch version on the same CUDA inputs at
   the widths the main path gives it (global fill: 32 passes, qmax 2048,
   tmax 2560, plus an edge batch with a >4096-row final-flush window; local
   fill: 5 kb and 15 kb pairs with and without a seeded line; traceback
   walk: on the global fill's output) — exact equality, all are integers;
4. the main path: the 64-hole scale corpus (synthesized from rng(42))
   through the port's CLI on the card; its output must have the JAX
   package's pinned md5, and every kernel must have launched during it
   (launch counts are reset just before and read just after this run);
   then the same run once more under torch.profiler, for the device busy
   time by kernel;
5. 8 HiFi-size holes (15 kb templates, at least 10 passes) through the CLI
   on the card; each consensus must reach identity >= 0.99 against its
   template.

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

# H100 SXM peaks used for the bounds: HBM rate from NVIDIA's data sheet; the
# INT32 rate is 64 INT32 lanes per SM x 132 SMs x 1.98 GHz (Hopper white
# paper SM layout) — the integer rate these fills and the walk run at
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations of each kernel, tallied from its body in the source
# note of csrc/banded_fill.cu and csrc/traceback_walk.cu: per query row
# (band offset and loop) plus per band lane of each row, and per walk step
# plus per move kind
OPS_PER_ROW_GLOBAL, OPS_PER_CELL_GLOBAL = 29, 85
OPS_PER_ROW_LOCAL, OPS_PER_CELL_LOCAL = 25, 125
OPS_PER_STEP_WALK = 27
OPS_WALK_DIAG, OPS_WALK_INS, OPS_WALK_DEL = 5, 19, 7

SOURCES = {
    "banded_global": ("ccsx_tpu_torch/csrc/banded_fill.cu",
                      "ccsx_tpu/ops/banded_pallas.py:494"),
    "banded_local": ("ccsx_tpu_torch/csrc/banded_fill.cu",
                     "ccsx_tpu/ops/banded.py:133 (lax original, mode='local')"),
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

    from ccsx_tpu_torch.ops import banded, banded_cuda, encode as enc
    from ccsx_tpu_torch.ops import seed, traceback
    from ccsx_tpu_torch.utils import synth

    sizes = sizes or dict(P=32, qmax=2048, tmax=2560, tlen=2200, reps=20,
                          plain_reps=3, edges=True, local=True)
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
        return banded.banded_global_moves(q_t, ql_t, t_t, tl_t)

    def compare_global(k_out, p_out, qlens_np):
        (ks, km, ko), (pr, pm, po) = k_out, p_out
        err = max(max_err(ks, pr.score), max_err(ko, po))
        for i, ql in enumerate(qlens_np):
            err = max(err, max_err(km[i, :ql], pm[i, :ql]))
        return err

    k_out = run_kernel()
    t0 = time.perf_counter()
    p_out = run_plain()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = compare_global(k_out, p_out, qlens)
    if sizes["edges"]:
        e = [T(x) for x in edge_inputs(rng, synth)]
        err = max(err, compare_global(
            banded_cuda.batched_align_global_moves(*e),
            banded.banded_global_moves(*e), e[1].cpu().numpy()))
    if err:
        raise AssertionError(f"global fill differs from its plain version "
                             f"(max abs err {err})")
    rows = int(qlens.sum())
    nbytes = qs.size + t.size + 8 * P + P * sizes["qmax"] * (128 + 4) + 4 * P
    b_ms, b_by = bound_ms(nbytes, rows * (OPS_PER_ROW_GLOBAL
                                          + 128 * OPS_PER_CELL_GLOBAL))
    records["banded_global"] = dict(
        max_abs_err=err, mismatches=0,
        ms=time_ms(run_kernel, sizes["reps"]),
        plain_ms=time_ms(run_plain, sizes["plain_reps"], warmup=0),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"P={P} qmax={sizes['qmax']} tmax={sizes['tmax']} band=128")
    print(f"[chip_smoke] global fill: 0 mismatches vs plain "
          f"({time.perf_counter() - t0:.1f}s incl. plain)", flush=True)

    # ---- traceback walk on the global fill's output ----
    _, moves, offs = k_out
    tmax = sizes["tmax"]

    def run_walk():
        return traceback.project(moves, offs, q_t, ql_t, tl_t, tmax, 4)

    def run_walk_plain():
        return traceback.project_plain(moves, offs, q_t, ql_t, tl_t, tmax, 4)

    kw, pw = run_walk(), run_walk_plain()
    err = max(max_err(a, b) for a, b in zip(kw, pw))
    if err:
        raise AssertionError(f"traceback walk differs from its plain version "
                             f"(max abs err {err})")
    # this run's paths: each pass's tlen columns are diagonals or deletions,
    # and its qlen is its diagonals plus insertions
    dels = int((kw[0][:, :tlen] == traceback.GAP).sum())
    diag = P * tlen - dels
    ins = int(qlens.sum()) - diag
    steps = diag + ins + dels
    nbytes = steps + P * sizes["qmax"] * 4 + qs.size + P * tmax * (1 + 4 + 4) + 4 * P
    b_ms, b_by = bound_ms(nbytes, steps * OPS_PER_STEP_WALK
                          + diag * OPS_WALK_DIAG + ins * OPS_WALK_INS
                          + dels * OPS_WALK_DEL)
    records["traceback_walk"] = dict(
        max_abs_err=err, mismatches=0, ms=time_ms(run_walk, sizes["reps"]),
        plain_ms=time_ms(run_walk_plain, sizes["plain_reps"], warmup=0),
        bound_ms=b_ms, bound_by=b_by, shape=f"P={P} tmax={tmax} max_ins=4")
    print("[chip_smoke] traceback walk: 0 mismatches vs plain", flush=True)

    # ---- local fill + stats, at the strand walk's pair lengths ----
    if sizes["local"]:
        lq, lql, lt, ltl, lines = (T(x) for x in
                                   local_inputs(rng, synth, enc, seed))
    else:
        lq, lql, lt, ltl = q_t[:2], ql_t[:2], t_t[:2].contiguous(), tl_t[:2]
        lines = banded.corner_lines(lql, ltl)

    def run_local():
        return banded_cuda.batched_align_local(lq, lql, lt, ltl, lines)

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
    rows = int(lql.sum())
    nbytes = lq.numel() + lt.numel() + 16 * len(lql) + 8 * len(lql) + 28 * len(lql)
    b_ms, b_by = bound_ms(nbytes, rows * (OPS_PER_ROW_LOCAL
                                          + 128 * OPS_PER_CELL_LOCAL))
    records["banded_local"] = dict(
        max_abs_err=err, mismatches=0, ms=time_ms(run_local, sizes["reps"]),
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        shape=f"n={len(lql)} pairs of 5 and 15 kb, corner and seeded lines")
    print(f"[chip_smoke] local fill: 0 mismatches vs plain "
          f"({time.perf_counter() - t0:.1f}s incl. plain)", flush=True)
    return records


def phase_scale64(device, n_holes=64):
    """The 64-hole scale corpus through the CLI; returns (seconds, counts)."""
    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.ops import cuda_ext
    from ccsx_tpu_torch.utils import synth

    bam = os.path.join(WORK, "in64.bam")
    out = os.path.join(WORK, "out64.fa")
    synth.make_big_bam(bam, n_holes, np.random.default_rng(42))
    cuda_ext.reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["--device", device, bam, out])
    secs = time.perf_counter() - t0
    counts = dict(cuda_ext.LAUNCHES)
    if rc != 0:
        raise AssertionError(f"CLI exited {rc} on the scale corpus")
    data = open(out, "rb").read()
    md5 = hashlib.md5(data).hexdigest()
    print(f"[chip_smoke] scale corpus: {n_holes} holes in {secs:.2f}s "
          f"({n_holes / secs:.2f} holes/s), {len(data)} bytes, md5 {md5}, "
          f"launches {counts}", flush=True)
    if n_holes == 64 and (md5 != SCALE64_MD5 or len(data) != SCALE64_BYTES):
        raise AssertionError(f"scale corpus output {md5}/{len(data)} != "
                             f"pinned {SCALE64_MD5}/{SCALE64_BYTES}")
    return secs, counts


def phase_profile(device):
    """Where the scale corpus's time goes: a second run of it under
    torch.profiler, device time summed by kernel name against the wall
    time.  Returns {"wall_s", "device_s", "by_kernel": {name: s}} or None
    when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ccsx_tpu_torch import cli

    bam = os.path.join(WORK, "in64.bam")
    out = os.path.join(WORK, "out64_prof.fa")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = cli.main(["--device", device, bam, out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI exited {rc} under the profiler")
    by = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us and ev.device_type == torch.autograd.DeviceType.CUDA:
            by[ev.key] = us / 1e6
    if not by:
        print("[chip_smoke] profile: no device time recorded (not measured)")
        return None
    dev_s = sum(by.values())
    top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
    print(f"[chip_smoke] profile of the scale corpus: wall {wall:.3f}s "
          f"(under the profiler), device busy {dev_s:.3f}s "
          f"({100 * dev_s / wall:.1f}%)", flush=True)
    for k, v in top:
        print(f"[chip_smoke]   {v * 1e3:9.2f} ms  {k[:90]}")
    return {"wall_s": wall, "device_s": dev_s,
            "top_kernels": [[k[:80], v] for k, v in top]}


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


def main() -> int:
    import torch

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
    scale_s, counts = phase_scale64("cuda")
    prof = phase_profile("cuda")
    hifi_s, hifi_bases, idents = phase_hifi("cuda")
    for name_k, (src, repl) in SOURCES.items():
        if counts[name_k] <= 0:
            raise AssertionError(f"kernel {name_k} never launched on the "
                                 "main path")
    kernels = [dict(name=k, route="cuda", source=SOURCES[k][0],
                    replaces=SOURCES[k][1], launches=counts[k],
                    library_ms=None, **records[k]) for k in SOURCES]
    print(json.dumps({"kernels": kernels,
                      "scale64": {"seconds": scale_s,
                                  "holes_per_s": 64 / scale_s,
                                  "profile": prof},
                      "hifi": {"seconds": hifi_s,
                               "bases_per_s": hifi_bases / hifi_s,
                               "min_identity": min(idents)}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
