#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ccsx_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--parent-walk SRC] [--parent-rotband SRC ...]
                          [--kernels-only | --host-planes-only |
                           --warmup-only [--cold-holes N] | --shards-only |
                           --serve-only | --supervisor-only |
                           --resilience-only | --mesh-only |
                           --scale-walls N]

Phases, in order; any failure raises and the script exits non-zero:

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build every kernel from csrc/ (one nvcc per source, in parallel), and
   the native IO library (native/io_native.cpp, one g++): its state
   (built or loaded, seconds, ``g++ --version``, ``build_error()``);
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
   through the port's CLI on the card in five arms — the batched packed
   driver with inline prep (``--prep-threads 0``, as every run of phases 4
   to 8 but the pooled one, so that launch counts, spans and fault
   positions follow a fixed schedule), the default flags (the prep pool
   on; its launch counts may differ between reruns), ``--banded-impl
   rotband``, ``--pass-buckets 4,8,16,32`` (the bucketed (Z, P) driver) and
   ``--batch off`` — twice each, alternating, and the bucketed arm once
   more under ``--banded-impl rotband``.  Each output must have the JAX package's pinned md5, no
   device step may fail over to its per-request replay, the driver's
   counters must show packed slabs and no bucketed group in a packed run
   and the reverse in a bucketed one, and the launch counts (reset just
   before and read just after each run) must show the default run going
   through the band-local fill, the local fill and the walk, the rotband
   run through the rotating-band fill, and each bucketed run through its
   arm's global fill and the walk.  Each batched run's refine steps go
   through the program cache (pipeline/graphs.py): a shape's first slab (or
   bucketed dispatch) runs eagerly and the rest replay its CUDA graph, so
   eager dispatches plus replays equal the slabs; iters + 1 global-fill and
   walk launches in each graph and each eager dispatch, and each kernel's
   launches equal to the replays times the launches of one plus the eager
   dispatches' (``graph_pins``; the builds' priming runs and the warmup
   plane's replays are counted apart).  A cold default run comes first (the
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
   call in a profiler range of its own) and the arms' device busy time;
7. the flight recorder: the scale corpus through the default arm four
   times under ``--metrics`` alone and four times under ``--trace
   --metrics``, in turns.  Each traced run must keep the pinned md5, end
   with a final metrics event with no stall, forced groups and the card
   memory the run holds, and show one ``refine_packed`` span a slab, one
   ``pair_fill`` span a local-fill launch, and as many global-fill and
   walk launches as the replayed graphs hold rounds; the ``stats`` subcommand
   summarizes the first one's files, and every run's host time is split by
   stage (its final event's stage timers).  Then the stall watchdog on a
   blocked CUDA wait (a kernel spinning for about 2 s inside a device span,
   a 0.5 s stall timeout: it must fire exactly once, while the host thread
   is blocked in the synchronise), a run with ``CCSX_BLACKBOX`` set whose
   ring the ``blackbox`` subcommand reads back in a process that cannot
   import torch (nothing in flight), and a run under ``--profile DIR``,
   whose Chrome trace must name the global fill, local fill and walk
   kernels;
8. crash and resume: the scale corpus through the default arm under each
   fault point of ``utils/faultinject.py``, each run a CLI process of its
   own (the kills call os._exit), three at a time.  ``write``, ``journal``
   and ``rank_death`` at the 20th retirement under ``--journal`` (rc 57,
   the killed journal's cursor, a torn tail where one is due), ``sigterm``
   (rc 75, the drained journal) and ``disk_full`` (rc 1) each resume with
   the same command to the pinned md5; ``device_oom`` once (a resplit, no
   failed step) and always (the per-request replay on the card), ``stall``
   and ``device_hang`` (4 s, past the watchdog's grace) to the pinned md5;
   ``compute@3`` and ``--salvage input_corrupt@5`` to the pinned output
   less that hole's record; ``input_corrupt@5`` without salvage to rc 1.
   Every run must launch the global fill, the local fill and the walk;
9. the host planes: in-process untraced ``--metrics`` runs, alternated,
   two of each — the scale corpus under inline prep through the native
   reader and through the Python reader (``native.available`` patched to
   False), under ``--prep-threads 1``, ``3`` and auto (the default), and
   under ``--bam`` (read back: the pinned FASTA's names and sequences,
   every ``rq`` in (0.8, 1]); the long-molecule corpus with the pool on
   in its default and its screen arm (its md5; the device seed and the
   device screen steps launched from the pump thread); and a
   gzipped FASTQ cut short (holes 100 and 101, md5 prefix ``2feaead356``,
   one ``gzip_truncated``).  Each run reports its wall and its stage
   split; the scale runs must give the pinned md5;
10. the warmup plane and the refine programs: the scale corpus under
   ``--warmup`` and ``--trace --metrics`` on an empty program cache (each
   packed group builds at most ``slab_shape_ladder`` + 1 programs; no
   shape the warmup plane built, and no shape warm_refine predicted and
   the run dispatched, books its first dispatch as a compile; the
   driver's seconds waiting for the plane's builds; the shared pool's
   bytes and ``device_buffer_bytes``); the pinned md5 under the default flags,
   ``--warmup``, ``--no-warmup``, ``--banded-impl rotband``,
   ``--pass-buckets 4,8,16,32`` and ``--prep-threads 0``, and the
   long-molecule corpus's under its default flags; the packed step eager
   against its replayed graph on the recorded slabs of an inline run
   (equal outputs; CUDA-event and host times); the default, ``--warmup``
   and eager arms (eager: ``graphs.CAPTURE_AT`` past every shape, on a
   program cache of its own), alternating, five untraced ``--metrics``
   runs each (quartiles of the wall, ``compute_s`` and the
   ``refine_packed`` spans).  ``--warmup-only`` runs this phase alone and
   adds three cold CLI processes of each dispatch arm (the default,
   ``--warmup``, eager and a capture at each shape's first dispatch),
   alternating, with the slabs each shape got, and ``--cold-holes N`` two
   an arm on a corpus of N holes (the full script leaves them out);
11. the run seen and split from outside: the scale corpus's BGZF hole
   index (``--make-index``, 64 holes); two ranks at once (``--hosts 2``,
   each a CLI process on the one card, the kernels built once before) in
   range mode, with ``top --once`` over their telemetry endpoints while
   they run, then in round-robin mode (the index removed), then with rank
   1 killed by ``rank_death`` at its 10th retirement under ``--journal``
   (rc 57; the merge refuses the set) and resumed with the same command:
   each merge to the pinned md5, each rank launching the default arm's
   kernels with its wall, ``elapsed_s``, progress total, ``ingest_bytes``
   and ``ingest_s``; a cold process under ``--telemetry-port`` scraped
   from start to end (every ``/metrics`` parses, every ``/healthz`` is
   ok, every ``/progress`` carries the total 64, programs captured
   meanwhile, the pinned md5); the scale corpus in process three times
   each without ``--telemetry-port``, with it, and with it scraped at
   20 Hz, alternating; ``report`` over phase 7's first traced run (its
   timeline names ``refine_packed`` and ``pair_fill`` spans).
   ``--shards-only`` runs this phase alone after one scale run and one
   traced run, and adds a corpus of 2048 holes (``big_corpus``) in one
   cold process against two cold ranks in range mode, whose merge must be
   its bytes;
12. the resident server and its replica fleet, each a ``python -m
   ccsx_tpu_torch.cli`` process on the card (``serve`` with ``-M
   4000000``, which both corpora pass; every SCALE64 job under inline prep
   and a pinned window of 16 holes, so its slabs depend on its input
   alone): the server's start-to-ready seconds; a warm wave of two SCALE64
   jobs at once (each to the pinned md5, each job's own launches — counted
   for it alone — through the global fill, the local fill and the walk),
   then two long-molecule jobs at once (their md5); a steady wave of four
   SCALE64 jobs and one long-molecule job, after which ``/progress`` shows
   no new refine-program build, and in which every SCALE64 job dispatches
   nothing eagerly (its graph replays equal its slabs); a ``device_oom@2``
   job beside a clean one (both to the md5, ``oom_resplits`` >= 1 in the
   faulted job only); a job cancelled mid-flight (a ``stall``), rc 75; a
   SIGTERM with a job in flight (rc 75, the job ``interrupted`` in
   ``state.json``) and the same command restarted, which finishes it to the
   md5; then ``gateway`` and two ``serve --fleet`` replicas under
   ``--banded-impl rotband``, four SCALE64 jobs through the gateway, and
   the replica holding the first (stalled) job SIGKILLed mid-job: its lease
   expires to the survivor, every job ends at the md5 with exactly one
   done marker, and every process and job read launched the rotating-band
   fill and never the band-local one.  Submit-to-done seconds, each job's
   ``elapsed_s``, start-to-ready seconds and the pool's bytes are reported
   beside phase 10's cold CLI processes, not gated.  ``--serve-only`` runs
   this phase alone after one scale run;
13. the supervisor, each command a ``python -m ccsx_tpu_torch.cli
   shepherd`` process on the card over the scale corpus's BGZF BAM and its
   hole index, its children reporting their kernel launches at exit
   through a hook on their PYTHONPATH (``CHILD_HOOK``): (a) ``--hosts 2
   --prep-threads 0 --max-rank-restarts 2 --rank-backoff 0.5`` with
   ``CCSX_FAULTS=rank_death@10`` in the shepherd's environment and the
   kernels' build directory emptied (the first launches build every kernel
   at once, as in a fresh checkout: one library a source after): every
   first launch dies (rc 57), each restart resumes from its shard journal
   and launches the default arm's kernels, the merge is the pinned md5;
   (b) the same with ``--inject-faults stall@5`` and a
   ``--rank-stall-timeout`` of twice (a)'s slowest launch-to-first-
   retirement: the shepherd kills each wedged rank, the restart runs
   clean, the md5; (c) ``--hosts 2 --fleet-ranges 8
   --max-rank-restarts 0`` with worker w1 SIGKILLed mid-range (holding a
   lease, a hole of it retired): the survivor absorbs its ranges,
   "merged 64 records from 8 leased ranges", the md5, the fleet directory
   removed; then one worker
   (stalled in its first device step) and ``shepherd --join <out>.fleet
   --hosts 1`` mid-run: both rc 0, the md5, the joined worker's launches;
   (d) ``--serve-replicas 2 --gateway-port P --fleet SPOOL --port Q -M
   4000000 --banded-impl rotband``, four SCALE64 jobs through the
   gateway, the replica holding the first (stalled) job SIGKILLed: its
   relaunch (attempt 1) comes back ready, every job ends at the md5 with
   one done marker and its own launches through the rotating-band fill
   and never the band-local one; SIGTERM to the shepherd drains every
   child and it exits 0.  Walls, start-ups, death to relaunch and
   relaunch to ready are reported, not gated.  ``--supervisor-only`` runs
   this phase alone after one scale run;
14. the resilience plane (pipeline/resilience.py), on the scale corpus
   under inline prep: (a) two CLI processes under ``--dispatch-deadline
   2 --inject-faults device_hang@1`` with ``CCSX_FAULT_HANG_S`` past the
   phase, the default arm and ``--banded-impl rotband``: rc 0, the md5,
   ``device_hangs`` >= 1, degraded, ``host_fallbacks`` >= 1, a wall far
   under the hang, and the arm's three kernels launched (by the
   per-request replay and the other steps) and never the other arm's
   global fill; (b) ``--inject-faults device_oom@1+ --breaker-strikes 2``:
   the md5, ``breaker_trips`` >= 1, the breaker ``open``, the kernels
   launched by the replays alone; then with ``--breaker-probe-s 0.2`` and
   a hook of this script that stops the faults when the probe is due: a
   probe, the breaker ``closed``, the md5 (the four processes at once);
   (c) in this process, in phase 10's eager arm (no refine program built)
   after one warm-up run, the first eager refine dispatch queues a
   ``torch.cuda._sleep`` of about 3 s (calibrated with CUDA events) ahead
   of its work under ``--dispatch-deadline 1`` and a grace of 1, with
   ``--inflight 1`` (the spun group alone in its sweep): the materialize
   wait is abandoned, the replay finishes behind the spin with the md5,
   ``device_hangs`` 1, and the abandoned thread ends once the spin does;
   then the same at the adaptive window, where a later dispatch of the
   spun sweep may wait behind the spin too (at least one expiry); a
   process that exits (``sys.exit``, then ``os._exit``) while a daemon
   thread waits in a copy queued behind a 6 s spin, with the seconds its
   exit takes; (d) one ``serve`` process
   with two SCALE64 jobs at once, one with ``{"faults": "device_hang@1",
   "dispatch_deadline_s": 1.5}``: both to the md5, the hang booked in that
   job alone, the server ready, SIGTERM rc 0 with the abandoned call still
   parked; (e) the scale corpus in process with deadlines off and at 60 s,
   alternating, seven runs each: walls and the host ms of each bounded
   call (quartiles, not gated), and the refine programs' pins equal in
   both arms.  ``--resilience-only`` runs this phase alone after one scale
   run;
15. the device mesh (parallel/mesh.py), on the scale corpus under inline
   prep, the card listed several times (``utils/device.local_devices``
   patched to ``[cuda:0] * k``: each entry a logical device with its own
   stream).  The single-device runs first, each fill arm's at (a)'s slab
   budget (``FUSED_ROWS``, where plans hold more slabs than the default
   budget's at most 2) recording each sweep's slab plan; then (a) the
   fused packed dispatch at k = 2 and 4 under both fill arms at that
   budget: the md5, ``fused_waves`` the sum over the plans of ceil(slabs /
   k), ``fused_slot_fill`` and the slabs as the plans give them, each
   kernel's launches equal to the single-device run's of its arm, every
   logical device's launches (``cuda_ext.LANE_LAUNCHES``) above 0 and
   adding up to them, and every entry's refine programs (its lane's,
   pipeline/graphs.py) built at an eager dispatch and replayed; then k = 2
   under ``--warmup`` on an empty program cache: the same, but every
   entry's programs built and warmed by the warmup plane, none run
   eagerly; (b) ``--mesh 4,2``, ``2,4`` and ``8,1`` over 8
   logical devices: the md5, the "pass packing disabled" line, bucketed
   groups and no slab, and every entry's global-fill and walk launches
   equal to the bucketed single-device run's (every entry runs every round
   of its data shard's loop, so the card gets D x P times the launches);
   (c) the real CLI on the one card with ``--mesh 4,2`` and ``--mesh
   16,2``: the "--mesh ignored" line, packed slabs, the md5; (d) two CLI
   ranks on the card under ``--hosts 2 --coordinator 127.0.0.1:PORT`` (a
   gloo process group), merged to the md5, with each rank's start-up
   (process seconds less the run's elapsed seconds).  (e) The walls of (a)
   and (b) beside the single-device runs', with the card line: reported,
   not gated, and no multi-GPU figure (the logical devices share one
   card).  ``--mesh-only`` runs this phase alone after one scale run; the
   full script runs the fused k = 2 arm (with its single-device run) once
   after phase 4.  ``--scale-walls N`` runs the scale corpus N times
   under inline prep after one run and prints the walls: for an A/B of
   two checkouts in one call, this script copied into the other and the
   two run in turns.

The last lines are the kernels' JSON record, the card line, and
``{"ok": true, "device": {...}}``.  Without a card, or without the rest of
the repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import operator
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
SCALE64_HOLES = 64
# the long-molecule corpus: benchmarks/long_molecule.py's 4x50000 scenario
# (4 holes, 50,000-base templates, 8 complete passes, seed 11), its flags
# and the JAX package's md5 and pre-alignment counters for its default arm
# (benchmarks/long_molecule_r11.json, confirmed on the JAX package's CPU
# run of the same corpus)
LONG_FLAGS = ["-A", "-m", "1000", "-M", "4000000", "--batch", "on",
              "--slab-rows", "32"]
LONG_MD5 = "1c9d8a68d1245c2b1c30becaa18a1f50"
LONG_COUNTS = {"pair_alignments": 28, "pairs_screened": 55,
               "pairs_prefiltered": 27, "pairs_seeded_device": 56,
               "pairs_seeded_host": 0, "windows": 99}
LONG_ARMS = {"default": [], "screen": ["--seed-device-min-t", "0"],
             "host": ["--prefilter", "off", "--seed-device-min-t", "0"]}
BUCKETS = ["--pass-buckets", "4,8,16,32"]
# inline prep: the batched driver's fixed schedule (launch counts, spans and
# fault positions do not depend on the prep pool's threads)
INLINE = ["--prep-threads", "0"]
# a gzipped FASTQ cut short (see phase_host_planes): the JAX CLI's md5
# prefix and holes
GZ_CUT_MD5 = "2feaead356"
GZ_CUT_HOLES = ["mv/100/ccs", "mv/101/ccs"]

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


# the refine programs' stats (pipeline/graphs.stats()) of the last run_cli
LAST: dict = {}


def run_cli(argv, what, record=None):
    """cli.main(argv) under -v with its stderr captured (echoed without the
    per-hole segment dump); returns (seconds, launch counts reset just
    before, the driver's counters), and leaves the run's refine-program
    stats (reset with the counts) in ``LAST["graphs"]``.  The counters are
    the run's final
    metrics snapshot (utils/metrics.py), which -v prints as the last stderr
    line, ``[ccsx-tpu-torch] {json}``: the JAX package's keys
    (``holes_out``, ``pair_alignments``, ``host_fallbacks``, ...) and the
    port's own (``slabs``, ``failed_steps``, ...).  A ``record`` list
    receives a copy of the inputs of every local-fill launch of the run
    (its groups of strand-walk pairs)."""
    import contextlib
    import io

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.ops import banded_cuda, cuda_ext
    from ccsx_tpu_torch.pipeline import graphs

    err = io.StringIO()
    local = banded_cuda.batched_align_local
    if record is not None:
        def recording(*a, **k):
            record.append([x.clone() for x in a[:5]])
            return local(*a, **k)
        banded_cuda.batched_align_local = recording
    try:
        cuda_ext.reset_counts()
        graphs.reset_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["-v", *argv])
        secs = time.perf_counter() - t0
        counts = dict(cuda_ext.LAUNCHES)
        LAST["graphs"] = graphs.stats()
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
    prefix, snap = text.strip().splitlines()[-1].split(" ", 1)
    if prefix != "[ccsx-tpu-torch]":
        raise AssertionError(f"CLI {what}: no metrics snapshot on the last "
                             "stderr line")
    driver = json.loads(snap)
    if driver["failed_steps"] or driver["host_fallbacks"]:
        raise AssertionError(f"CLI {what}: device steps failed over to their "
                             f"replay: {driver}")
    return secs, counts, driver


def graph_pins(what, counts, driver, stats, bucketed=False):
    """The refine programs of one batched run (pipeline/graphs.py) against
    its launch counts: a shape's eager dispatches (graphs.CAPTURE_AT) plus
    its replays sum to the driver's slabs (or bucketed dispatches); every
    program that replays is a CUDA graph whose one replay launches its
    global fill and its walk iters + 1 times, and so does each eager
    dispatch (the device-only loop); each kernel's launches equal the sum
    over shapes of replays x the launches of one replay plus the eager
    dispatches' launches.  The builds' priming runs and the warm replays
    are counted apart.  Returns the record; raises on a broken rule."""
    kind = "refine" if bucketed else "refine_packed"
    at = 4 if bucketed else 3               # the key's iters
    progs = {k: v for k, v in stats.items() if k[0] == kind}
    replays = sum(v["replays"] for v in progs.values())
    eager = sum(v["eager"] for v in progs.values())
    want = driver["bucketed_dispatches" if bucketed else "slabs"]
    problems = []
    if replays + eager != want:
        problems.append(f"replays {replays} + eager {eager} != {want}")
    rounds = 0
    for k, v in progs.items():
        for form, n, one in (("replay", v["replays"], v["launches"]),
                             ("eager", v["eager"], {
                                 name: c / max(1, v["eager"])
                                 for name, c in v["eager_launches"].items()})):
            if not n:
                continue
            walk = one.get("traceback_walk", 0)
            fills = (one.get("banded_global", 0)
                     + one.get("banded_rotband", 0))
            if (form == "replay" and not v["graph"]) or walk != fills or \
                    walk != k[at] + 1:
                problems.append(f"{k[:at + 4]}: {form}, graph {v['graph']},"
                                f" one launches {one}")
            rounds += n * walk
    for name in ("banded_global", "banded_rotband", "traceback_walk"):
        n = sum(v["replays"] * v["launches"].get(name, 0)
                + v["eager_launches"].get(name, 0) for v in progs.values())
        if n != counts[name]:
            problems.append(f"{name}: {counts[name]} launches != {n} from "
                            "replays and eager dispatches")
    warm, parts = {}, {}
    for v in progs.values():
        for name, n in v["launches"].items():
            warm[name] = warm.get(name, 0) + v["warm_replays"] * n
        for name, x in v["build_parts"].items():
            parts[name] = parts.get(name, 0.0) + x
    per_shape = sorted((v["eager"] + v["replays"] for v in progs.values()),
                       reverse=True)
    rec = {"shapes": len(progs), "builds": sum(v["builds"]
                                                for v in progs.values()),
           "eager": eager, "replays": replays, "rounds": rounds,
           "slabs_per_shape": per_shape,
           "warm_replays": sum(v["warm_replays"] for v in progs.values()),
           "warm_replay_launches": warm,
           "build_s": sum(v["build_s"] for v in progs.values()),
           "build_parts_s": parts}
    if problems:
        raise AssertionError(f"{what}: refine programs: {problems}")
    return rec


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
                                       "bucketed_dispatches")}
    print(f"[chip_smoke] scale corpus {list(extra) or 'default'}: {n_holes} "
          f"holes in {secs:.3f}s ({n_holes / secs:.2f} holes/s), "
          f"{len(data)} bytes, md5 {md5}, launches {counts}, grouping "
          f"{grouping}", flush=True)
    if n_holes == 64 and (md5 != SCALE64_MD5 or len(data) != SCALE64_BYTES):
        raise AssertionError(f"scale corpus output {md5}/{len(data)} != "
                             f"pinned {SCALE64_MD5}/{SCALE64_BYTES}")
    bucketed = "--pass-buckets" in extra
    if "--batch" not in extra:
        if (bool(driver["slabs"]) == bucketed
                or bool(driver["bucketed_groups"]) != bucketed):
            raise AssertionError(f"CLI {list(extra)}: the wrong grouping ran "
                                 f"({grouping})")
        LAST["pins"] = graph_pins(f"scale corpus {list(extra)}", counts,
                                  driver, LAST["graphs"], bucketed)
        print("[chip_smoke]   refine programs: " + json.dumps(LAST["pins"]),
              flush=True)
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
    rc = cli.main(["-A", "--device", device, *INLINE, src, out])
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
            [*LONG_FLAGS, "--device", device, *INLINE, *extra, fa, out],
            f"{extra} on the long-molecule corpus",
            groups if arm == "default" else None)
        md5 = hashlib.md5(open(out, "rb").read()).hexdigest()
        keys = ("pair_alignments", "pairs_screened", "pairs_prefiltered",
                "pairs_seeded_device", "pairs_seeded_host", "screen_steps",
                "seed_steps", "pair_fills", "windows", "slabs", "holes_out")
        counters = {k: driver[k] for k in keys}
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
        [*LONG_FLAGS, "--device", device, *INLINE, *LONG_ARMS[arm], fa,
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


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def traced_scale64(device, tag):
    """The scale corpus through the default arm under --trace and --metrics:
    the pinned md5; the final metrics event with no stall, forced groups
    and the card's allocated bytes; one refine_packed span a slab and one
    graph replay a span, one pair_fill span a local-fill launch, and
    global-fill and walk launches equal to the rounds in the replayed
    graphs (graph_pins).  Returns (seconds, record)."""
    from ccsx_tpu_torch.utils import trace

    bam = os.path.join(WORK, "in64.bam")
    out = os.path.join(WORK, f"rec_{tag}.fa")
    t = os.path.join(WORK, f"rec_{tag}_trace.jsonl")
    m = os.path.join(WORK, f"rec_{tag}_metrics.jsonl")
    secs, launches, driver = run_cli(
        ["--device", device, *INLINE, "--trace", t, "--metrics", m, bam,
         out], f"traced ({tag}) on the scale corpus")
    progs = graph_pins(f"traced ({tag})", launches, driver, LAST["graphs"])
    md5 = hashlib.md5(open(out, "rb").read()).hexdigest()
    if md5 != SCALE64_MD5:
        raise AssertionError(f"traced scale corpus md5 {md5} != pinned")
    finals = [e for e in read_jsonl(m) if e["event"] == "final"]
    if len(finals) != 1:
        raise AssertionError(f"{len(finals)} final metrics events")
    fin = finals[0]
    spans = [r for r in read_jsonl(t) if r.get("ev") == "span"
             and r["cat"] == "device" and not r.get("args", {}).get("error")]
    n_packed = sum(r["name"] == "refine_packed" for r in spans)
    n_pair = sum(r["name"] == "pair_fill" for r in spans)
    checks = {
        "stalls == 0": fin["stalls"] == 0,
        "groups_forced": fin["groups_forced"] is True,
        "device_buffer_bytes > 0": fin["device_buffer_bytes"] > 0,
        "refine_packed spans == slabs == graph replays":
            n_packed == fin["slabs"] == progs["replays"] > 0,
        "pair_fill spans == local-fill launches":
            n_pair == launches["banded_local"] > 0,
        "global-fill and walk launches == rounds in the replayed graphs":
            launches["banded_global"] == launches["traceback_walk"]
            == progs["rounds"],
    }
    rec = {"seconds": secs, "slabs": fin["slabs"],
           "refine_packed_spans": n_packed, "rounds": progs["rounds"],
           "refine_programs": progs,
           "pair_fill_spans": n_pair, "launches": launches,
           "stalls": fin["stalls"],
           "device_buffer_bytes": fin["device_buffer_bytes"],
           "trace": t, "metrics": m, "final": fin}
    print(f"[chip_smoke] traced scale corpus ({tag}): {secs:.3f}s, md5 "
          f"{md5}, {n_packed} refine_packed spans, {fin['slabs']} slabs, "
          f"{progs['rounds']} rounds, {n_pair} pair_fill spans, launches "
          f"{launches}, stalls {fin['stalls']}, device_buffer_bytes "
          f"{fin['device_buffer_bytes']}", flush=True)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"traced scale corpus ({tag}): {failed}")
    return secs, rec


def stage_split(fin):
    """The host-time split of one run from its final metrics event: the
    stage seconds, the steady-state and first-launch device seconds of the
    group table, and the share of the wall that no stage accounts for."""
    stages = {k: fin[k] for k in ("ingest_s", "prep_s", "compute_s",
                                  "write_s")}
    wall = fin["elapsed_s"]
    groups = fin.get("groups", {})
    return {**stages, "prep_blocked_s": fin["prep_blocked_s"],
            "elapsed_s": wall, "groups_forced": fin.get("groups_forced"),
            "execute_s": sum(g["execute_s"] for g in groups.values()),
            "first_launch_s": sum(g["compile_s"] for g in groups.values()),
            "unaccounted_share": 1 - sum(stages.values()) / wall}


def watchdog_on_card(seconds=2.0, stall_timeout=0.5):
    """A device span whose CUDA wait blocks the host for ``seconds`` (a
    spinning kernel, then a synchronise): the stall watchdog must fire
    exactly once while the host thread is still blocked in that wait, and
    its stack dump must show the thread there.  A first short span of the
    same group takes the first-of-shape grace."""
    import contextlib
    import io

    import torch

    from ccsx_tpu_torch.utils import trace
    from ccsx_tpu_torch.utils.run_metrics import RunMetrics

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    probe = int(2e7)
    a.record()
    torch.cuda._sleep(probe)
    b.record()
    torch.cuda.synchronize()
    cycles = int(probe * seconds * 1e3 / a.elapsed_time(b))
    path = os.path.join(WORK, "watchdog_trace.jsonl")
    m = RunMetrics()
    err = io.StringIO()
    tr = trace.Tracer(path, stall_timeout=stall_timeout, metrics=m)
    try:
        with tr.device_span("spin", group="spin"):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        with contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            with tr.device_span("spin", group="spin"):
                torch.cuda._sleep(cycles)
                torch.cuda.synchronize()
            wait_s = time.perf_counter() - t0
    finally:
        tr.close()
    stalls = [r for r in read_jsonl(path) if r.get("ev") == "stall"]
    main_stack = "".join(v for k, v in (stalls[0]["stacks"] if stalls
                                        else {}).items()
                         if k.startswith("MainThread"))
    rec = {"wait_s": wait_s, "stall_timeout_s": stall_timeout,
           "stalls": m.stalls,
           "fired_at_open_s": stalls[0]["open_s"] if stalls else None,
           "main_thread_in_synchronize": "synchronize" in main_stack,
           "degraded": m.degraded}
    print(f"[chip_smoke] watchdog on a blocked CUDA wait: {rec}", flush=True)
    if not (m.stalls == 1 and len(stalls) == 1
            and rec["main_thread_in_synchronize"]
            and stall_timeout <= stalls[0]["open_s"] < wait_s
            and "STALL WATCHDOG" in err.getvalue()):
        raise AssertionError("the stall watchdog did not fire exactly once "
                             "while the host was blocked in the CUDA wait: "
                             f"{rec}")
    return rec


def blackbox_run(device):
    """The scale corpus with CCSX_BLACKBOX set, then the ``blackbox``
    subcommand in a process that cannot import torch or jax: it reads the
    ring back and shows nothing in flight after the clean exit."""
    from ccsx_tpu_torch.utils import blackbox

    bb_dir = os.path.join(WORK, "blackbox")
    out = os.path.join(WORK, "bb.fa")
    os.environ[blackbox.ENV_DIR] = bb_dir
    blackbox.reset()
    try:
        secs, _, _ = run_cli(["--device", device, *INLINE,
                              os.path.join(WORK, "in64.bam"), out],
                             "under CCSX_BLACKBOX on the scale corpus")
    finally:
        os.environ.pop(blackbox.ENV_DIR, None)
        blackbox.reset()
    events = blackbox.read_dump(blackbox.box_path(bb_dir))
    block = ("import sys\nfor m in ('torch', 'jax'):\n"
             "    sys.modules[m] = None\n"
             "from ccsx_tpu_torch import cli\n"
             f"sys.exit(cli.main(['blackbox', {bb_dir!r}, '--tail', '3']))\n")
    r = subprocess.run([sys.executable, "-c", block], cwd=HERE,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=HERE))
    rec = {"seconds": secs, "events": len(events),
           "inflight": len(blackbox.inflight(events)), "rc": r.returncode}
    print(f"[chip_smoke] blackbox run of the scale corpus: {rec}; the "
          "subcommand without torch or jax said:\n" + r.stdout.strip(),
          flush=True)
    if (r.returncode != 0 or not events or rec["inflight"]
            or "-- nothing in flight --" not in r.stdout):
        raise AssertionError(f"blackbox: {rec}\n{r.stderr}")
    return rec


def profile_flag_run(device):
    """The scale corpus under the CLI's --profile DIR: the Chrome trace in
    DIR must name the port's kernels among its CUDA kernel events."""
    import glob

    pdir = os.path.join(WORK, "profile")
    shutil.rmtree(pdir, ignore_errors=True)
    secs, launches, _ = run_cli(
        ["--device", device, *INLINE, "--profile", pdir,
         os.path.join(WORK, "in64.bam"), os.path.join(WORK, "prof.fa")],
        "under --profile on the scale corpus")
    files = glob.glob(os.path.join(pdir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"--profile wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    want = ("global_fill_kernel", "local_fill_kernel", "walk_kernel")
    named = {w: sum(w in k for k in kernels) > 0 for w in want}
    rec = {"seconds": secs, "file_mb": os.path.getsize(files[0]) / 1e6,
           "kernel_names": len(kernels), "named": named}
    print(f"[chip_smoke] --profile run of the scale corpus: {rec}",
          flush=True)
    if not all(named.values()):
        raise AssertionError(f"--profile trace lacks the port's kernels: "
                             f"{rec}")
    return rec


def phase_recorder(device, untraced):
    """Phase 7, the flight recorder on the card: the scale corpus through
    the default arm untraced and traced in turns (U T T U U T T U), the
    untraced runs under --metrics alone (its stage timers force nothing),
    the traced ones under --trace --metrics (traced_scale64 checks each);
    the stats subcommand over the first traced run's files; each run's
    host-time split by stage; the watchdog on a blocked CUDA wait; a run
    under CCSX_BLACKBOX read back by the blackbox subcommand; a run under
    --profile.  ``untraced`` holds phase 4's warm walls of the default arm,
    printed beside these."""
    import contextlib
    import io

    from ccsx_tpu_torch import cli

    runs = {"untraced": [], "traced": []}
    for i, kind in enumerate("UTTUUTTU"):
        if kind == "T":
            secs, rec = traced_scale64(device, f"t{i}")
            runs["traced"].append(rec)
        else:
            m = os.path.join(WORK, f"rec_u{i}_metrics.jsonl")
            secs = phase_scale64(device, [*INLINE, "--metrics", m])[0]
            runs["untraced"].append({"seconds": secs, "final": [
                e for e in read_jsonl(m) if e["event"] == "final"][0]})
    first = runs["traced"][0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["stats", first["trace"], first["metrics"]])
    if rc != 0:
        raise AssertionError(f"stats exited {rc}")
    print("[chip_smoke] stats over the first traced run's trace and "
          "metrics:\n" + buf.getvalue().rstrip(), flush=True)
    walls = {k: [r["seconds"] for r in v] for k, v in runs.items()}
    splits = {k: [stage_split(r["final"]) for r in v]
              for k, v in runs.items()}
    for kind, ss in splits.items():
        for sp in ss:
            print(f"[chip_smoke] host-time split, {kind} run: {sp}",
                  flush=True)
    print("[chip_smoke] scale corpus walls, default arm: traced "
          + " / ".join(f"{w:.3f}" for w in walls["traced"]) + " s, untraced "
          + " / ".join(f"{w:.3f}" for w in walls["untraced"])
          + " s in turns; phase 4's untraced "
          + " / ".join(f"{w:.3f}" for w in untraced) + " s", flush=True)
    return {"walls": walls, "phase4_untraced": list(untraced),
            "splits": splits,
            "traced": [{k: v for k, v in r.items()
                        if k not in ("final", "trace", "metrics")}
                       for r in runs["traced"]],
            "watchdog": watchdog_on_card(),
            "blackbox": blackbox_run(device),
            "profile": profile_flag_run(device)}


# phase 8: one run of the CLI in a process of its own (the injected kills
# call os._exit); the launch counts are written to stderr at every exit,
# the hard one included
CRASH_RUNNER = """
import json, os, sys
from ccsx_tpu_torch import cli
from ccsx_tpu_torch.ops import cuda_ext
def report():
    sys.stderr.write("[chip_smoke] launches " + json.dumps(cuda_ext.LAUNCHES)
                     + "\\n")
    sys.stderr.flush()
real_exit = os._exit
def hard_exit(code):
    report()
    real_exit(code)
os._exit = hard_exit
rc = cli.main(sys.argv[1:])
report()
sys.exit(rc)
"""
# the kernels every phase 8 run must go through: the default arm's
CRASH_KERNELS = ("banded_global", "banded_local", "traceback_walk")
# the retirement at which phase 8's kill points fire
CRASH_AT = 20


def crash_cli(argv, env_extra=None, timeout=300, verbose=True,
              runner=CRASH_RUNNER):
    """The port's CLI on ``argv`` (under -v, unless ``verbose`` is False) in
    a subprocess (``runner``'s code); returns rc, seconds, stderr, the
    launch counts and the final metrics snapshot (None after a hard exit or
    without -v)."""
    env = dict(os.environ, PYTHONPATH=HERE, **(env_extra or {}))
    env.pop("CCSX_FAULTS", None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", runner,
                        *(["-v"] if verbose else []), *argv],
                       cwd=HERE, env=env, capture_output=True, text=True,
                       timeout=timeout)
    secs = time.perf_counter() - t0
    lines = r.stderr.splitlines()
    launches = [json.loads(ln.split(" ", 2)[2]) for ln in lines
                if ln.startswith("[chip_smoke] launches ")]
    snaps = [json.loads(ln.split(" ", 1)[1]) for ln in lines
             if ln.startswith("[ccsx-tpu-torch] {")]
    return {"rc": r.returncode, "seconds": secs, "stderr": r.stderr,
            "launches": launches[-1] if launches else None,
            "final": snaps[-1] if snaps else None}


def crash_scenario(name, spec, env, extra, resume, check, bam, device):
    """One phase 8 row: the faulted run and, with ``resume``, the same
    command without the fault.  ``check(run, resumed)`` returns the failed
    conditions.  Every run must have launched the default arm's kernels."""
    out = os.path.join(WORK, f"crash_{name}.fa")
    jp = os.path.join(WORK, f"crash_{name}.json")
    for f in (out, jp):
        if os.path.exists(f):
            os.remove(f)
    base = ["--device", device, *INLINE, *extra]
    if resume:
        base += ["--journal", jp]
    base += [bam, out]
    run = crash_cli(base + ["--inject-faults", spec], env)
    run["journal"] = (json.load(open(jp)) if resume and os.path.exists(jp)
                      else None)
    run["out_size"] = os.path.getsize(out) if os.path.exists(out) else None
    run["out"] = open(out, "rb").read() if os.path.exists(out) else b""
    resumed = None
    if resume:
        resumed = crash_cli(base, env)
        resumed["journal"] = json.load(open(jp))
        resumed["out"] = open(out, "rb").read()
    failed = list(check(run, resumed))
    for tag, r in (("run", run), ("resume", resumed)):
        if r is None:
            continue
        n = r["launches"] or {}
        if any(n.get(k, 0) <= 0 for k in CRASH_KERNELS) or n.get(
                "banded_rotband"):
            failed.append(f"{tag}: launches {n} miss the default arm's "
                          "kernels")
        if "Traceback" in r["stderr"]:
            failed.append(f"{tag}: a traceback on stderr")
    return {"name": name, "spec": spec, "run": run, "resumed": resumed,
            "failed": failed}


def _md5(b):
    return hashlib.md5(b).hexdigest()


def phase_crash(device, uninterrupted):
    """Phase 8, crash and resume on the card: the scale corpus through the
    default arm under each fault point (crash_scenario, three at a time),
    each to the pinned bytes or to the pinned bytes less the records the
    fault took.  ``uninterrupted`` is phase 4's cold run's driver
    counters."""
    from concurrent.futures import ThreadPoolExecutor

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.pipeline.run import open_zmw_stream

    bam = os.path.join(WORK, "in64.bam")
    ref = open(os.path.join(WORK, "out64.fa"), "rb").read()
    if _md5(ref) != SCALE64_MD5:
        raise AssertionError("phase 8 needs phase 4's pinned output")
    recs = {">" + c.split("\n", 1)[0]: ">" + c
            for c in ref.decode().split(">")[1:]}
    cfg = cli.config_from_args(cli.build_parser().parse_args([bam, "-"]))
    stream = [f">{z.movie}/{z.hole}/ccs"
              for z in open_zmw_stream(bam, cfg)]
    # the position (1-based) in the filtered stream of the k-th hole that
    # writes a record: write@k and disk_full@k fire at that hole
    writers = [i + 1 for i, h in enumerate(stream) if h in recs]

    def without(hole):
        return "".join(v for k, v in recs.items() if k != hole).encode()

    def pinned(r):
        return ([] if r is not None and _md5(r["out"]) == SCALE64_MD5
                and len(r["out"]) == SCALE64_BYTES else
                [f"output md5 {_md5(r['out']) if r else None} is not the "
                 "pinned one"])

    def rc_is(r, rc):
        return [] if r["rc"] == rc else [f"rc {r['rc']} != {rc}"]

    def killed(done, torn):
        def check(run, res):
            j = run["journal"] or {}
            yield from rc_is(run, 57)
            if j.get("version") != 2 or j.get("holes_done") != done:
                yield f"killed journal {j} (want v2, holes_done {done})"
            if (run["out_size"] > j.get("out_bytes", -1)) != torn:
                yield (f"output {run['out_size']} B against journaled "
                       f"{j.get('out_bytes')} B: torn tail should be {torn}")
            yield from rc_is(res, 0)
            yield from pinned(res)
            if res["journal"]["holes_done"] != len(stream):
                yield f"resumed journal {res['journal']}"
        return check

    def drained(run, res):
        j = run["journal"] or {}
        yield from rc_is(run, 75)
        if "drained cleanly" not in run["stderr"]:
            yield "no 'drained cleanly' line"
        # the holes in flight at the signal finish, the rest wait
        if not k <= j.get("holes_done", 0) < len(stream):
            yield f"drained journal {j}"
        yield from rc_is(res, 0)
        yield from pinned(res)
        if (res["final"]["holes_out"] + j.get("holes_emitted", 0)
                != uninterrupted["holes_out"]):
            yield (f"resumed holes_out {res['final']['holes_out']} + "
                   f"drained holes_emitted {j.get('holes_emitted')} != "
                   f"{uninterrupted['holes_out']}")

    def disk_full(run, res):
        j = run["journal"] or {}
        yield from rc_is(run, 1)
        if "No space left on device" not in run["stderr"]:
            yield "no ENOSPC message"
        if (j.get("holes_done") != writers[k - 1] - 1
                or j.get("out_bytes") != run["out_size"]):
            yield f"journal {j} against {run['out_size']} B on disk"
        yield from rc_is(res, 0)
        yield from pinned(res)

    def counters(**want):
        def check(run, res):
            yield from rc_is(run, 0)
            yield from pinned(run)
            fin = run["final"] or {}
            for k, (op, v) in want.items():
                if not op(fin.get(k, 0), v):
                    yield f"{k} = {fin.get(k)}"
        return check

    def dropped(position, counter):
        hole = stream[position - 1]

        def check(run, res):
            yield from rc_is(run, 0)
            if run["out"] != without(hole):
                yield (f"output is not the pinned output less {hole}'s "
                       "record")
            if (run["final"] or {}).get(counter) != 1:
                yield f"{counter} = {(run['final'] or {}).get(counter)}"
            if counter == "holes_failed" and \
                    f"hole {hole[1:-4]} failed" not in run["stderr"]:
                yield f"stderr does not name {hole}"
        return check

    def refused(run, res):
        yield from rc_is(run, 1)
        if "invalid input stream" not in run["stderr"]:
            yield "no 'invalid input stream' line"

    k = CRASH_AT
    fsync = {"CCSX_JOURNAL_FSYNC_S": "0"}

    def watched(tag):
        return ["--stall-timeout", "0.2", "--metrics",
                os.path.join(WORK, f"crash_{tag}.jsonl")]

    ge, eq, gt = operator.ge, operator.eq, operator.gt
    # the first device step of this corpus is a one-request local-fill
    # group, which the ladder replays at once (nothing to split): the
    # second, the first slab (2 holes), is the first that can resplit.  The
    # drain's window is pinned to 8 holes, so that the holes in flight at
    # the signal are a part of the corpus (the adaptive window grows to
    # all 64) and the resume has work to do
    rows = [
        ("write", f"write@{k}", fsync, [], True,
         killed(writers[k - 1] - 1, True)),
        ("journal", f"journal@{k}", fsync, [], True, killed(k - 1, True)),
        ("rank_death", f"rank_death@{k}", fsync, [], True,
         killed(k, False)),
        ("sigterm", f"sigterm@{k}", fsync, ["--inflight", "8"], True,
         drained),
        ("disk_full", f"disk_full@{k}", fsync, [], True, disk_full),
        ("device_oom", "device_oom@2", {}, [], False,
         counters(oom_resplits=(ge, 1), failed_steps=(eq, 0))),
        ("device_oom_all", "device_oom@1+", {}, [], False,
         counters(failed_steps=(gt, 0), host_fallbacks=(gt, 0))),
        ("compute", "compute@3", {}, [], False, dropped(3, "holes_failed")),
        ("stall", "stall@1", {"CCSX_FAULT_STALL_S": "4"}, watched("stall"),
         False, counters(stalls=(ge, 1))),
        ("device_hang", "device_hang@1", {"CCSX_FAULT_HANG_S": "4"},
         watched("hang"), False, counters(stalls=(ge, 1))),
        ("salvage", "input_corrupt@5", {}, ["--salvage"], False,
         dropped(5, "holes_corrupt")),
        ("corrupt", "input_corrupt@5", {}, [], False, refused),
    ]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        futs = [pool.submit(crash_scenario, *row, bam, device)
                for row in rows]
        results = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    keys = ("holes_in", "holes_out", "holes_failed", "holes_corrupt",
            "oom_resplits", "failed_steps", "host_fallbacks", "stalls",
            "slabs", "pair_fills")
    table = []
    for res in results:
        row = {"name": res["name"], "spec": res["spec"]}
        for tag in ("run", "resumed"):
            r = res[tag]
            if r is None:
                continue
            row[tag] = {"rc": r["rc"], "seconds": r["seconds"],
                        "md5": _md5(r["out"]), "bytes": len(r["out"]),
                        "launches": r["launches"], "journal": r["journal"],
                        "counters": {k: r["final"][k] for k in keys
                                     if r["final"] and k in r["final"]}}
        table.append(row)
        print(f"[chip_smoke] crash and resume {res['name']} "
              f"({res['spec']}): {json.dumps(row)}", flush=True)
    print(f"[chip_smoke] phase 8 wall: {wall:.3f}s for {len(rows)} rows "
          f"({sum(1 + bool(r['resumed']) for r in results)} CLI processes, "
          "three at a time)", flush=True)
    failed = {r["name"]: r["failed"] for r in results if r["failed"]}
    if failed:
        for r in results:
            if r["failed"]:
                sys.stderr.write(r["run"]["stderr"][-4000:])
        raise AssertionError(f"crash and resume: {failed}")
    return {"wall_s": wall, "rows": table}


# ---- phase 9: the host planes -------------------------------------------


def native_state():
    """Build (or load) the native IO library and report it: built or
    loaded, the build seconds, ``g++ --version``'s first line and
    ``build_error()``."""
    from ccsx_tpu_torch import native

    try:
        gxx = subprocess.run([os.environ.get("CXX", "g++"), "--version"],
                             capture_output=True, text=True,
                             timeout=30).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        gxx = f"unavailable ({e})"
    ok = native.available()
    rec = {"available": ok, **native.load_state, "gxx": gxx,
           "build_error": native.build_error()}
    print(f"[chip_smoke] native IO library: {rec}", flush=True)
    return rec


def zlib_probe():
    """None when a two-line zlib program builds and links here, else the
    compiler's first line: the one reason phase 9 may run without the
    native reader."""
    src = os.path.join(WORK, "zlib_probe.cpp")
    with open(src, "w") as f:
        f.write("#include <zlib.h>\n"
                "int main() { return zlibVersion() == 0; }\n")
    try:
        r = subprocess.run([os.environ.get("CXX", "g++"), "-o",
                            src[:-4], src, "-lz"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"no compiler: {e}"
    if r.returncode == 0:
        return None
    return (r.stderr or r.stdout).strip().splitlines()[0]


def host_plane_run(device, extra, tag, src=None, out_ext="fa"):
    """One untraced --metrics run of the scale corpus (or ``src``) through
    run_cli; returns (seconds, launches, final metrics event, output
    path)."""
    src = src or os.path.join(WORK, "in64.bam")
    out = os.path.join(WORK, f"hp_{tag}.{out_ext}")
    m = os.path.join(WORK, f"hp_{tag}_metrics.jsonl")
    if os.path.exists(m):
        os.remove(m)
    secs, launches, _ = run_cli(["--device", device, *extra, "--metrics", m,
                                 src, out], f"{tag} {list(extra)}")
    fin = [e for e in read_jsonl(m) if e["event"] == "final"][0]
    return secs, launches, fin, out


def bam_readback(path):
    """The --bam output against the pinned FASTA: the same names and
    sequences in order, every rq in (0.8, 1]."""
    from ccsx_tpu_torch.io import bam as bam_mod
    from ccsx_tpu_torch.io import fastx

    want = [(r.name, r.seq) for r in
            fastx.read_fastx(os.path.join(WORK, "out64.fa"))]
    recs = list(bam_mod.read_bam_records(path, with_aux=True))
    got = [(r.name, r.seq) for r, _ in recs]
    rq = [aux["rq"][1] for _, aux in recs]
    problems = []
    if got != want:
        problems.append(f"{len(got)} records, not the pinned FASTA's "
                        f"{len(want)} names and sequences")
    if not rq or not all(0.8 < q <= 1.0 for q in rq):
        problems.append(f"rq out of (0.8, 1]: min {min(rq, default=None)}")
    return {"records": len(recs), "rq_min": min(rq, default=None)}, problems


def gz_cut_input():
    """4 holes of 500-bp templates from rng(0) as FASTQ (quality 'I'),
    gzipped whole and cut to its first 2,231 of 3,347 bytes."""
    import gzip

    from ccsx_tpu_torch.ops import encode as enc
    from ccsx_tpu_torch.utils import synth

    rng = np.random.default_rng(0)
    zs = [synth.make_zmw(rng, template_len=500, n_passes=5, movie="mv",
                         hole=str(100 + h)) for h in range(4)]
    fq = "".join(f"@{n}\n{enc.decode(p)}\n+\n{'I' * len(p)}\n"
                 for z in zs for n, p in zip(z.names, z.passes)).encode()
    blob = gzip.compress(fq)
    if len(blob) != 3347:
        raise AssertionError(f"the gzipped FASTQ is {len(blob)} bytes, not "
                             "3,347")
    path = os.path.join(WORK, "cut.fq.gz")
    with open(path, "wb") as f:
        f.write(blob[:2231])
    return path


def phase_host_planes(device, state, long_inline_s=None):
    """Phase 9, the host planes on the card: the scale corpus under inline
    prep through the native and the Python reader, under --prep-threads 1,
    3 and auto, and under --bam; the long-molecule corpus with the pool on;
    alternated, two of each, untraced under --metrics; then the gzipped
    FASTQ cut short.  ``state`` is native_state()'s record;
    ``long_inline_s`` holds phase 6's walls of the default and the screen
    arm (inline prep), printed beside the pooled ones."""
    from ccsx_tpu_torch import native
    from ccsx_tpu_torch.pipeline.prep_pool import resolve_prep_threads
    from ccsx_tpu_torch.config import CcsConfig
    from ccsx_tpu_torch.utils import synth

    missing = None
    if not state["available"]:
        missing = zlib_probe()
        if missing is None:
            raise AssertionError("the native IO library did not load though "
                                 f"zlib builds here: {state}")
        print(f"[chip_smoke] native: unavailable ({missing}); the reader "
              "A/B and truncated-gzip rows are not run", flush=True)
    fa_long = os.path.join(WORK, "long.fa")
    if not os.path.exists(fa_long):
        synth.make_long_fasta(fa_long, 4, 50000, 8, 11)
    arms = {"native_0": INLINE, "python_0": INLINE,
            "pool_1": ["--prep-threads", "1"],
            "pool_3": ["--prep-threads", "3"], "pool_auto": [],
            "bam": ["--bam"], "long_pooled": LONG_FLAGS,
            "long_screen_pooled": LONG_FLAGS + LONG_ARMS["screen"]}
    if missing:
        arms.pop("native_0")
        arms.pop("python_0")
    real = native.available
    runs = {k: [] for k in arms}
    for rep_i in range(2):   # alternating: a drift falls on every arm alike
        for arm, extra in arms.items():
            tag = f"{arm}_{rep_i}"
            if arm == "python_0":
                native.available = lambda: False
            try:
                if arm.startswith("long"):
                    secs, launches, fin, out = host_plane_run(
                        device, extra, tag, src=fa_long)
                else:
                    secs, launches, fin, out = host_plane_run(
                        device, extra, tag,
                        out_ext="bam" if arm == "bam" else "fa")
            finally:
                native.available = real
            data = open(out, "rb").read()
            md5 = hashlib.md5(data).hexdigest()
            rec = {"seconds": secs, "bytes": len(data), "md5": md5,
                   "launches": launches, **stage_split(fin),
                   "prep_share": fin["prep_share"],
                   "prep_queue_peak": fin["prep_queue_peak"],
                   "prep_threads": fin["prep_threads"],
                   "ingest_share": fin["ingest_s"] / fin["elapsed_s"]}
            for k in ("seed_steps", "screen_steps", "pairs_seeded_device",
                      "pairs_screened", "pair_alignments", "windows"):
                rec[k] = fin[k]
            problems = []
            if arm == "bam":
                rb, problems = bam_readback(out)
                rec.update(rb)
            elif arm.startswith("long"):
                # the pump thread launched the device seed step (default
                # arm) or the device screen step (screen arm)
                if md5 != LONG_MD5:
                    problems.append(f"md5 {md5} != pinned {LONG_MD5}")
                step = "screen_steps" if "screen" in arm else "seed_steps"
                if fin[step] <= 0 or launches["banded_local"] <= 0:
                    problems.append(f"no {step} or no local fill ran")
            elif md5 != SCALE64_MD5 or len(data) != SCALE64_BYTES:
                problems.append(f"md5 {md5}/{len(data)} != pinned")
            if not arm.startswith("long") and any(
                    launches[k] <= 0 for k in CRASH_KERNELS):
                problems.append(f"launches {launches} miss a kernel of the "
                                "default arm")
            want_threads = {"native_0": 0, "python_0": 0, "pool_1": 1,
                            "pool_3": 3}.get(
                arm, resolve_prep_threads(CcsConfig()))
            if fin["prep_threads"] != want_threads:
                problems.append(f"prep_threads {fin['prep_threads']} != "
                                f"{want_threads}")
            runs[arm].append(rec)
            print(f"[chip_smoke] host planes {tag}: {secs:.3f}s, "
                  f"{len(data)} B, md5 {md5}, ingest "
                  f"{rec['ingest_s']:.4f}s ({100 * rec['ingest_share']:.1f}%)"
                  f", prep {rec['prep_s']:.4f}s, prep_blocked "
                  f"{rec['prep_blocked_s']:.4f}s, prep_share "
                  f"{rec['prep_share']}, queue peak "
                  f"{rec['prep_queue_peak']}, launches {launches}",
                  flush=True)
            if problems:
                raise AssertionError(f"host planes {tag}: {problems}")
    gz = None
    if not missing:
        path = gz_cut_input()
        secs, _, fin, out = host_plane_run(
            device, ["-A", "-m", "400", "--batch", "on", "--salvage"],
            "gz_cut", src=path)
        data = open(out, "rb").read()
        names = [ln[1:] for ln in data.decode().splitlines()
                 if ln.startswith(">")]
        gz = {"seconds": secs, "holes": names,
              "md5": hashlib.md5(data).hexdigest(),
              "holes_in": fin["holes_in"],
              "corrupt_reasons": fin.get("corrupt_reasons")}
        print(f"[chip_smoke] host planes, gzipped FASTQ cut short: {gz}",
              flush=True)
        if (names != GZ_CUT_HOLES or not gz["md5"].startswith(GZ_CUT_MD5)
                or gz["corrupt_reasons"] != {"gzip_truncated": 1}):
            raise AssertionError(f"truncated gzip FASTQ: {gz}")

    def med(arm, key):
        return statistics.median(r[key] for r in runs[arm])

    summary = {arm: {k: med(arm, k) for k in (
        "seconds", "ingest_s", "ingest_share", "prep_s", "prep_blocked_s",
        "prep_share", "compute_s", "elapsed_s")} for arm in runs}
    for arm, v in summary.items():
        print(f"[chip_smoke] host planes median {arm}: " + ", ".join(
            f"{k} {x:.4f}" for k, x in v.items()), flush=True)
    print("[chip_smoke] long-molecule walls: pooled " + " / ".join(
        f"{r['seconds']:.3f}" for r in runs["long_pooled"])
        + " s (default arm), " + " / ".join(
            f"{r['seconds']:.3f}" for r in runs["long_screen_pooled"])
        + f" s (screen arm); phase 6 inline {long_inline_s}", flush=True)
    return {"native": state, "native_missing": missing,
            "runs": runs, "median": summary, "gz_cut": gz,
            "long_inline_s": long_inline_s}


# ---- phase 10: the warmup plane and the refine programs -----------------

EAGER = 10 ** 9      # a graphs.CAPTURE_AT no shape reaches: never capture
# the dispatch arms: (graphs.CAPTURE_AT, None for the default; CLI flags)
ARMS = {"default": (None, []), "warmup": (None, ["--warmup"]),
        "eager": (EAGER, []), "capture_at_1": (1, [])}
_ARM_CACHES: dict = {}


class dispatch_arm:
    """graphs.CAPTURE_AT ``at`` for the duration, on a program cache of the
    arm's own (kept between its runs; the process's put back after), or
    nothing when ``at`` is None."""

    def __init__(self, at):
        self.at = at

    def __enter__(self):
        from ccsx_tpu_torch.pipeline import graphs

        if self.at is not None:
            own = _ARM_CACHES.setdefault(self.at, ({}, {}))
            self.saved = graphs.CAPTURE_AT, graphs._programs, graphs._eager
            graphs.CAPTURE_AT, graphs._programs, graphs._eager = \
                self.at, *own
        return self

    def __exit__(self, *exc):
        from ccsx_tpu_torch.pipeline import graphs

        if self.at is not None:
            graphs.CAPTURE_AT, graphs._programs, graphs._eager = self.saved


def quartiles(xs):
    """(first quartile, median, third quartile) of a list of numbers."""
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return q[0], statistics.median(xs), q[2]


def packed_span_s(fin):
    """Seconds in the refine_packed spans of a final metrics event."""
    return sum(g["compile_s"] + g["execute_s"]
               for k, g in fin["groups"].items() if k.startswith("packed:"))


def warm_traced_run(device):
    """The scale corpus under --warmup and --trace --metrics, on an empty
    program cache: the md5; the graph pins; each packed group builds at
    most slab_shape_ladder + 1 programs; no shape the warmup plane built (a
    warmup span that booked the compile) books its first dispatch as a
    compile; no shape the warmup plane was asked for in advance
    (warm_refine's predictions) and then dispatched books its first
    dispatch as a compile; the driver's seconds waiting for the plane's
    builds at its dispatches (BatchExecutor._warm_wait); the shared pool's
    bytes and the run's device_buffer_bytes."""
    import torch

    from ccsx_tpu_torch.config import CcsConfig
    from ccsx_tpu_torch.pipeline import batch, graphs

    graphs.clear()
    bam = os.path.join(WORK, "in64.bam")
    out = os.path.join(WORK, "warm_traced.fa")
    t = os.path.join(WORK, "warm_trace.jsonl")
    m = os.path.join(WORK, "warm_metrics.jsonl")
    predicted, waits = [], []
    real_submit = batch.BatchExecutor._submit_warm
    real_wait = batch.BatchExecutor._warm_wait

    def submit(ex, qmax, tmax, iters, R, urgent=False):
        key = real_submit(ex, qmax, tmax, iters, R, urgent)
        if not urgent:
            predicted.append(key)
        return key

    def wait(ex, key):
        t0 = time.perf_counter()
        real_wait(ex, key)
        waits.append(time.perf_counter() - t0)

    batch.BatchExecutor._submit_warm = submit
    batch.BatchExecutor._warm_wait = wait
    try:
        secs, launches, driver = run_cli(
            ["--device", device, "--warmup", "--trace", t, "--metrics", m,
             bam, out], "traced, --warmup, empty program cache")
    finally:
        batch.BatchExecutor._submit_warm = real_submit
        batch.BatchExecutor._warm_wait = real_wait
    stats = LAST["graphs"]
    progs = graph_pins("warm traced run", launches, driver, stats)
    md5 = hashlib.md5(open(out, "rb").read()).hexdigest()
    fin = [e for e in read_jsonl(m) if e["event"] == "final"][0]
    spans = [r for r in read_jsonl(t) if r.get("ev") == "span"
             and r["cat"] == "device" and "compile" in r]
    shape = {}     # (group, shape) -> how its first span booked it
    for r in sorted(spans, key=lambda r: r["ts"] + r["dur"]):
        k = (r["args"]["group"], r["args"].get("shape"))
        if r["compile"]:
            shape[k] = "warmup" if r.get("warmup") else "inline"
    warmed = {k for k, v in shape.items() if v == "warmup"}
    bad = [r for r in spans if r["name"] == "refine_packed" and r["compile"]
           and (r["args"]["group"], r["args"].get("shape")) in warmed]
    pred = {(f"packed:q{k[1]}:t{k[2]}:i{k[3]}:b{k[6]}", f"R{k[4]}:S{k[5]}")
            for k in predicted}
    disp = {(r["args"]["group"], r["args"].get("shape")) for r in spans
            if r["name"] == "refine_packed"}
    inline = sum(shape.get(k) == "inline" for k in pred & disp)
    per_group = {}
    for k, v in stats.items():
        if k[0] == "refine_packed" and v["builds"]:
            g = k[1:4] + (k[6],)
            per_group[g] = per_group.get(g, 0) + v["builds"]
    ladder = CcsConfig().slab_shape_ladder
    rec = {"seconds": secs, "md5": md5, "programs": progs,
           "builds_per_group": {":".join(map(str, g)): n
                                for g, n in per_group.items()},
           "warmup_built": len(warmed & disp),
           "inline_built": sum(v == "inline" for k, v in shape.items()
                               if k in disp),
           "predicted": len(pred), "predicted_dispatched": len(pred & disp),
           "predicted_claimed_inline": inline,
           "dispatch_wait_s": sum(waits), "dispatch_waits": len(waits),
           "warmed_first_dispatch_compiles": len(bad),
           "pool_bytes": graphs.pool_bytes(),
           "device_buffer_bytes": fin["device_buffer_bytes"],
           "memory_reserved": torch.cuda.memory_reserved(),
           "split": stage_split(fin)}
    print(f"[chip_smoke] phase 10 traced --warmup run, empty program cache: "
          f"{rec}", flush=True)
    problems = []
    if md5 != SCALE64_MD5:
        problems.append(f"md5 {md5}")
    if not per_group or max(per_group.values()) > ladder + 1:
        problems.append(f"builds per packed group {per_group} (ladder "
                        f"{ladder})")
    if bad:
        problems.append(f"{len(bad)} first dispatches of warmed shapes "
                        "booked as compiles")
    if not pred & disp or inline:
        problems.append(f"{inline} of {len(pred & disp)} dispatched "
                        "predictions booked their first dispatch as a "
                        "compile")
    if problems:
        raise AssertionError(f"phase 10 traced run: {problems}")
    return rec


def step_ab(device, reps=2):
    """The packed refine step, eager (the early-exit step launched op by
    op) against the replayed program, on the same slabs: every slab the
    inline default run dispatched, recorded at its dispatch (each shape's
    program built first where the run left none).  Each arm runs all the
    slabs in turns (eager, graph, graph, eager; ``reps`` times), timed by
    CUDA events around the whole set and by the host's clock around the
    dispatch calls alone; every output must be equal."""
    import torch

    from ccsx_tpu_torch.config import AlignParams
    from ccsx_tpu_torch.pipeline import batch, graphs

    recorded = []
    real = graphs.dispatch

    def recording(key, make_step, specs, dev, *host):
        recorded.append((key, make_step, specs, [h.clone() for h in host]))
        return real(key, make_step, specs, dev, *host)

    graphs.dispatch = recording
    try:
        phase_scale64(device, INLINE)
    finally:
        graphs.dispatch = real
    dev = torch.device(device)
    packed = [(graphs.program(k, mk, sp, dev), host)
              for k, mk, sp, host in recorded if k[0] == "refine_packed"]
    eager = []
    for prog, _ in packed:
        # the key: the shape, the arm, the lanes a build warms (D), then
        # graphs.config_key's fields
        (_, qmax, tmax, iters, R, H, bimpl, _, align, max_ins,
         *bp) = prog.key[:15]
        eager.append(batch._refine_step_packed(
            AlignParams(*align), max_ins, tmax, iters, H, tuple(bp[:5]),
            (R, qmax), "rotband" if bimpl == "rotband" else ""))
    hosts = [[h.pin_memory() for h in host] for _, host in packed]

    def run_arm(kind):
        outs = []
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        host_s = 0.0
        a.record()
        for (prog, _), step, host in zip(packed, eager, hosts):
            t0 = time.perf_counter()
            if kind == "graph":
                outs.append(prog.run(*host))
            else:
                outs.append(step(*(h.to(dev, non_blocking=True)
                                   for h in host)))
            host_s += time.perf_counter() - t0
        b.record()
        torch.cuda.synchronize()
        return outs, a.elapsed_time(b), host_s

    times = {"eager": [], "graph": []}
    ref = None
    for _ in range(reps):
        for kind in ("eager", "graph", "graph", "eager"):
            outs, ev_ms, host_s = run_arm(kind)
            times[kind].append({"event_ms": ev_ms, "host_s": host_s})
            if ref is None:
                ref = [o.cpu() for o in outs]
            elif not all(torch.equal(o.cpu(), r) for o, r in zip(outs, ref)):
                raise AssertionError(f"step A/B: the {kind} outputs differ")
    rec = {"slabs": len(packed), "order": "eager, graph, graph, eager",
           "eager": times["eager"], "graph": times["graph"],
           "host_ms_per_slab": {k: statistics.median(
               t["host_s"] for t in v) * 1e3 / max(1, len(packed))
               for k, v in times.items()},
           "event_ms": {k: statistics.median(t["event_ms"] for t in v)
                        for k, v in times.items()}}
    print(f"[chip_smoke] phase 10 step A/B on {len(packed)} recorded slabs: "
          f"host ms a slab {rec['host_ms_per_slab']}, CUDA-event ms for the "
          f"set {rec['event_ms']} (medians); runs {times}", flush=True)
    if not packed:
        raise AssertionError("step A/B: no packed slab was recorded")
    return rec


# one CLI process of a dispatch arm: argv[1] is graphs.CAPTURE_AT (0 keeps
# the default), the rest the CLI's; the last stdout line is the refine
# programs' record
COLD_CODE = """import json, sys
from ccsx_tpu_torch.pipeline import graphs
if int(sys.argv[1]):
    graphs.CAPTURE_AT = int(sys.argv[1])
from ccsx_tpu_torch.cli import main
rc = main(sys.argv[2:])
st = [v for k, v in graphs.stats().items() if k[0] == "refine_packed"]
print(json.dumps({
    "slabs_per_shape": sorted((v["eager"] + v["replays"] for v in st),
                              reverse=True),
    "eager": sum(v["eager"] for v in st),
    "replays": sum(v["replays"] for v in st),
    "builds": sum(v["builds"] for v in st),
    "build_s": sum(v["build_s"] for v in st)}))
sys.exit(rc)
"""


def cold_processes(device, src, arms, rounds, tag, want_md5=None):
    """``rounds`` CLI processes of each dispatch arm (ARMS) on ``src``,
    alternating: each process's wall, its run's elapsed_s, compute_s and
    refine_packed spans, and its refine programs (slabs per shape, eager
    dispatches, replays, builds and their seconds).  Every output must be
    equal (to ``want_md5`` when given)."""
    recs = {arm: [] for arm in arms}
    md5s = set()
    for i in range(rounds):
        for arm in arms:
            at, extra = ARMS[arm]
            out = os.path.join(WORK, f"cold_{tag}_{arm}_{i}.fa")
            m = os.path.join(WORK, f"cold_{tag}_{arm}_{i}_metrics.jsonl")
            argv = [sys.executable, "-c", COLD_CODE, str(at or 0),
                    "--device", device, *extra, "--metrics", m, src, out]
            t0 = time.perf_counter()
            r = subprocess.run(argv, cwd=HERE, capture_output=True,
                               text=True, timeout=900,
                               env=dict(os.environ, PYTHONPATH=HERE))
            secs = time.perf_counter() - t0
            md5 = (hashlib.md5(open(out, "rb").read()).hexdigest()
                   if os.path.exists(out) else None)
            md5s.add(md5)
            if r.returncode != 0 or md5 is None:
                raise AssertionError(f"cold process {tag} {arm} {i}: rc "
                                     f"{r.returncode}\n{r.stderr[-4000:]}")
            fin = [e for e in read_jsonl(m) if e["event"] == "final"][0]
            recs[arm].append({"process_s": secs,
                              "elapsed_s": fin["elapsed_s"],
                              "compute_s": fin["compute_s"],
                              "refine_packed_s": packed_span_s(fin),
                              "slabs": fin["slabs"],
                              **json.loads(r.stdout.splitlines()[-1])})
            print(f"[chip_smoke] phase 10 cold process {tag} {arm} {i}: "
                  f"{recs[arm][-1]}", flush=True)
    if len(md5s) != 1 or (want_md5 and md5s != {want_md5}):
        raise AssertionError(f"cold processes {tag}: md5s {md5s}")
    med = {arm: {k: statistics.median(r[k] for r in rr)
                 for k in ("elapsed_s", "process_s", "compute_s",
                           "refine_packed_s")} for arm, rr in recs.items()}
    print(f"[chip_smoke] phase 10 cold processes {tag}, medians: {med}",
          flush=True)
    return {"runs": recs, "medians": med, "md5": md5s.pop()}


def _corpus_holes(args):
    from ccsx_tpu_torch.utils import synth

    seed, holes, counts, tlens = args
    recs = []
    for h, n, tlen in zip(holes, counts, tlens):
        rng = np.random.default_rng([seed, h])
        z = synth.make_zmw(rng, int(tlen), int(n), movie="mv", hole=str(h),
                           partial_ends=True, **synth.ERR)
        if h % 5 == 0:
            z.passes.insert(len(z.passes) // 2,
                            synth.read_through(rng, z.template, **synth.ERR))
            z.strands.insert(len(z.strands) // 2, 0)
        recs += [(name, synth.enc.decode(p).encode(), None)
                 for name, p in zip(z.names, z.passes)]
    return recs


def big_corpus(path, n_holes, seed=2048, procs=8):
    """A scale corpus of ``n_holes`` holes made as synth.make_big_bam makes
    its holes (lognormal pass counts, 1-5 kb templates, partial ends, a
    read-through every 5th hole), with a generator per hole so that
    ``procs`` worker processes make it together."""
    import multiprocessing

    from ccsx_tpu_torch.io import bam
    from ccsx_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    counts = synth.sample_pass_counts(rng, n_holes)
    tlens = rng.integers(1000, 5001, n_holes)
    parts = [(seed, range(k, n_holes, procs), counts[k::procs],
              tlens[k::procs]) for k in range(procs)]
    with multiprocessing.get_context("fork").Pool(procs) as pool:
        chunks = pool.map(_corpus_holes, parts)
    by_hole = {}
    for chunk in chunks:
        for rec in chunk:
            by_hole.setdefault(int(rec[0].split("/")[1]), []).append(rec)
    bam.write_bam(path, [r for h in sorted(by_hole) for r in by_hole[h]],
                  bgzf=True)


def phase_warmup(device, runs=5, cold=2, big_holes=0):
    """Phase 10, the warmup plane and the refine programs on the card: the
    traced --warmup run on an empty program cache (warm_traced_run); the
    scale corpus's md5 under the default flags, --warmup, --no-warmup,
    --banded-impl rotband, --pass-buckets 4,8,16,32 and --prep-threads 0,
    with the shared pool's bytes after each, and the long-molecule corpus's
    in its default arm; the step A/B (step_ab); the default, --warmup and
    eager arms (the eager one in-process, graphs.CAPTURE_AT past every
    shape on a cache of its own), alternating, ``runs`` untraced --metrics
    runs each (medians and quartiles of the wall, compute_s and the
    refine_packed spans); ``cold`` CLI processes of each dispatch arm
    (ARMS) on the scale corpus, alternating; and with ``big_holes``, two
    of each on a corpus of that many holes (big_corpus)."""
    import torch

    from ccsx_tpu_torch.pipeline import graphs
    from ccsx_tpu_torch.utils import synth

    traced = warm_traced_run(device)
    arms = {"default": [], "warmup": ["--warmup"],
            "no_warmup": ["--no-warmup"],
            "rotband": ["--banded-impl", "rotband"], "bucketed": BUCKETS,
            "inline": INLINE}
    pinned = {}
    for arm, extra in arms.items():
        secs, counts, _ = phase_scale64(device, extra)
        pinned[arm] = {"seconds": secs, "launches": counts,
                       "programs": LAST["pins"],
                       "pool_bytes": graphs.pool_bytes(),
                       "memory_reserved": torch.cuda.memory_reserved()}
    print(f"[chip_smoke] phase 10 pool bytes after each arm: "
          f"{ {a: r['pool_bytes'] for a, r in pinned.items()} }", flush=True)
    fa = os.path.join(WORK, "long.fa")
    if not os.path.exists(fa):
        synth.make_long_fasta(fa, 4, 50000, 8, 11)
    lout = os.path.join(WORK, "warm_long.fa")
    secs, _, _ = run_cli([*LONG_FLAGS, "--device", device, fa, lout],
                         "the long-molecule corpus, default flags")
    lmd5 = hashlib.md5(open(lout, "rb").read()).hexdigest()
    pinned["long_default"] = {"seconds": secs, "md5": lmd5}
    print(f"[chip_smoke] phase 10 long-molecule default flags: {secs:.3f}s, "
          f"md5 {lmd5}", flush=True)
    if lmd5 != LONG_MD5:
        raise AssertionError(f"phase 10 long-molecule md5 {lmd5}")
    ab = step_ab(device)

    walls = {"default": [], "warmup": [], "eager": []}
    for i in range(runs):
        for arm in walls:
            at, extra = ARMS[arm]
            with dispatch_arm(at):
                secs, _, fin, out = host_plane_run(device, extra,
                                                   f"warm_{arm}_{i}")
            md5 = hashlib.md5(open(out, "rb").read()).hexdigest()
            if md5 != SCALE64_MD5:
                raise AssertionError(f"phase 10 {arm} run {i}: md5 {md5}")
            walls[arm].append({"seconds": secs, "compute_s": fin["compute_s"],
                               "refine_packed_s": packed_span_s(fin),
                               "elapsed_s": fin["elapsed_s"]})
    summary = {arm: {k: quartiles([r[k] for r in rr]) for k in (
        "seconds", "compute_s", "refine_packed_s")}
        for arm, rr in walls.items()}
    for arm, v in summary.items():
        print(f"[chip_smoke] phase 10 {arm}, {runs} untraced runs, (q1, "
              "median, q3): " + ", ".join(
                  f"{k} ({a:.4f}, {b:.4f}, {c:.4f})"
                  for k, (a, b, c) in v.items()), flush=True)

    procs = cold_processes(device, os.path.join(WORK, "in64.bam"),
                           list(ARMS), cold, "scale64",
                           SCALE64_MD5) if cold else None
    rec = {"traced": traced, "pinned": pinned, "step_ab": ab,
           "walls": walls, "walls_quartiles": summary, "cold": procs}
    if big_holes:
        src = os.path.join(WORK, f"big{big_holes}.bam")
        t0 = time.perf_counter()
        big_corpus(src, big_holes)
        print(f"[chip_smoke] phase 10 corpus of {big_holes} holes made in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        rec["cold_big"] = cold_processes(device, src, list(ARMS), 2,
                                         f"big{big_holes}")
    return rec


# phase 11: one-card sharded runs, each rank a CLI process of its own;
# the retirement at which phase 11's killed rank dies
SHARD_KILL_AT = 10


def free_ports(n):
    """A base port with the n ports from it free on this host now."""
    import socket

    for _ in range(50):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        base = s.getsockname()[1]
        s.close()
        if base + n > 65535:
            continue
        ok = True
        for p in range(base, base + n):
            t = socket.socket()
            try:
                t.bind(("0.0.0.0", p))
            except OSError:
                ok = False
            finally:
                t.close()
        if ok:
            return base
    raise AssertionError("no free run of ports for the telemetry scrapes")


def rank_cli(argv, metrics, env_extra=None):
    """One rank's (or one process's) CLI run for phase 11: crash_cli
    without -v (its per-hole dump is host time), the final event read from
    ``metrics`` instead."""
    if os.path.exists(metrics):
        os.remove(metrics)
    r = crash_cli([*argv, "--metrics", metrics], env_extra, verbose=False)
    if os.path.exists(metrics):
        finals = [e for e in read_jsonl(metrics) if e["event"] == "final"]
        r["final"] = finals[-1] if finals else None
    return r


def rank_record(r):
    """What phase 11 keeps of one rank's (or one process's) run; raises
    when it failed or missed a kernel of the default arm."""
    fin = r["final"] or {}
    n = r["launches"] or {}
    if r["rc"] != 0 or not fin:
        raise AssertionError(f"rank exited {r['rc']}\n{r['stderr'][-4000:]}")
    if any(n.get(k, 0) <= 0 for k in CRASH_KERNELS) or "Traceback" in \
            r["stderr"] or fin.get("device_dispatches", 0) <= 0:
        raise AssertionError(f"rank launches {n}, device_dispatches "
                             f"{fin.get('device_dispatches')}")
    return {"process_s": r["seconds"], "elapsed_s": fin["elapsed_s"],
            "holes_total": (fin.get("progress") or {}).get("total"),
            "holes_in": fin["holes_in"], "holes_out": fin["holes_out"],
            "ingest_bytes": fin["ingest_bytes"], "ingest_s": fin["ingest_s"],
            "compute_s": fin["compute_s"], "slabs": fin["slabs"],
            "device_dispatches": fin["device_dispatches"], "launches": n}


def shard_pair(device, src, out, extra=(), ports=None, kill=None):
    """Two ranks of ``src`` at once, each a CLI process on the one card,
    then the merge (in process, timed).  ``ports``: the ranks' telemetry
    base, with ``top --once`` rendered over both while they run.
    ``kill``: rank 1 runs under ``--inject-faults rank_death@kill`` and
    --journal (rank 0 too), must die with rc 57, the merge must refuse the
    set, and the same command without the fault resumes it.  Returns the
    ranks' records, the merge's seconds and the merged md5."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.parallel import distributed
    from ccsx_tpu_torch.utils import telemetry

    if os.path.exists(out):
        os.remove(out)
    for r in range(2):
        for f in (distributed.shard_path(out, r),
                  distributed.shard_path(out, r) + ".idx",
                  distributed.done_path(out, r), f"{out}.j.shard{r}"):
            if os.path.exists(f):
                os.remove(f)
    base = ["--device", device, *extra, "--hosts", "2"]
    if ports:
        base += ["--telemetry-port", str(ports)]
    # under --journal every advance reaches the disk, so the killed
    # rank's cursor is its kill point
    env = {"CCSX_JOURNAL_FSYNC_S": "0"} if kill else None
    if kill:
        base += ["--journal", f"{out}.j"]
    argvs = [base + ["--host-id", str(r), src, out] for r in range(2)]
    ms = [f"{out}.m{r}.jsonl" for r in range(2)]
    rec = {}
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(rank_cli, argvs[0], ms[0], env),
                pool.submit(rank_cli, argvs[1] + (
                    ["--inject-faults", f"rank_death@{kill}"] if kill
                    else []), ms[1], env)]
        if ports:
            # a frame while both ranks answer, the last one before both
            # have admitted a hole or once both have
            eps = [f"127.0.0.1:{ports + r}" for r in range(2)]
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 300 and not all(
                    f.done() for f in futs):
                srcs = [telemetry.read_source(e, timeout=1.0) for e in eps]
                if all(s["snap"] for s in srcs):
                    buf = io.StringIO()
                    with contextlib.redirect_stdout(buf):
                        rc = cli.main(["top", "--once", "--no-color", *eps])
                    if rc != 0 or "2 source(s)" not in buf.getvalue():
                        raise AssertionError(f"top exited {rc}:\n"
                                             f"{buf.getvalue()}")
                    rec["top"] = buf.getvalue()
                    if all(s["snap"].get("holes_in") for s in srcs):
                        break
                time.sleep(0.05)
            if "top" not in rec:
                raise AssertionError("phase 11: the ranks' endpoints never "
                                     "answered together")
            print("[chip_smoke] phase 11 top over both ranks:\n"
                  + rec["top"], flush=True)
        runs = [f.result() for f in futs]
    if kill:
        dead = runs[1]
        journal = json.load(open(f"{out}.j.shard1"))
        if dead["rc"] != 57 or journal["holes_done"] != kill:
            raise AssertionError(f"killed rank exited {dead['rc']}, its "
                                 f"journal {journal}")
        rec["killed"] = {"seconds": dead["seconds"], "journal": journal}
        with contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["--merge-shards", "2", "ignored", out])
        if rc != 1 or os.path.exists(out):
            raise AssertionError(f"the merge of a dead rank's set exited {rc}")
        runs[1] = rank_cli(argvs[1], ms[1], env)
    rec["ranks"] = [rank_record(r) for r in runs]
    t0 = time.perf_counter()
    rc = cli.main(["--merge-shards", "2", "ignored", out])
    rec["merge_s"] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"merge exited {rc}")
    rec["md5"] = _md5(open(out, "rb").read())
    return rec


def scraped_cold_run(device, src, out, port):
    """A cold CLI process of ``src`` under --telemetry-port, scraped in a
    loop from its start to its end (/progress, /metrics, /healthz), so
    the scrapes overlap its refine programs' captures.  Every /metrics
    body must parse, every /healthz say ok, every /progress carry the
    index's total.  Returns the record."""
    import urllib.error
    import urllib.request

    argv = [sys.executable, "-c", COLD_CODE, "0", "--device", device,
            "--telemetry-port", str(port), src, out]
    proc = subprocess.Popen(argv, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=HERE))
    counts = {"/progress": 0, "/metrics": 0, "/healthz": 0}
    totals, done, bad = set(), 0, []
    t0 = time.perf_counter()
    while proc.poll() is None and time.perf_counter() - t0 < 600:
        for path in counts:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                            timeout=2.0) as resp:
                    code, body = resp.status, resp.read().decode()
            except urllib.error.HTTPError as e:
                code, body = e.code, e.read().decode()
            except OSError:
                break                       # not up yet, or closed
            counts[path] += 1
            if path == "/progress":
                prog = json.loads(body)["progress"]
                totals.add(prog["total"])
                done = max(done, prog["done"])
            elif path == "/healthz":
                if code != 200 or json.loads(body)["status"] != "ok":
                    bad.append(f"/healthz {code} {body}")
            else:
                for line in body.splitlines():
                    if not line.startswith("# TYPE ccsx_"):
                        float(line.rpartition(" ")[2])
        time.sleep(0.01)
    stdout, stderr = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    md5 = _md5(open(out, "rb").read()) if os.path.exists(out) else None
    rec = {"process_s": secs, "scrapes": counts, "totals": sorted(
        t for t in totals if t is not None), "max_done": done,
        "md5": md5, "programs": json.loads(stdout.splitlines()[-1])
        if stdout.strip() else None}
    print(f"[chip_smoke] phase 11 scraped cold run: {rec}", flush=True)
    if proc.returncode != 0 or md5 != SCALE64_MD5:
        raise AssertionError(f"scraped run rc {proc.returncode}, md5 {md5}\n"
                             f"{stderr[-4000:]}")
    if bad or totals != {SCALE64_HOLES} or min(counts.values()) == 0:
        raise AssertionError(f"scraped run: {bad or rec}")
    if not rec["programs"]["builds"]:
        raise AssertionError("scraped run: no refine program was captured")
    return rec


def telemetry_walls(device, src, runs=3):
    """The scale corpus in process, ``runs`` times each, alternating:
    without --telemetry-port, with it and nobody scraping, and with it
    scraped by a thread at 20 Hz.  Every output keeps the pinned md5."""
    import threading
    import urllib.request

    walls = {"off": [], "on": [], "scraped": []}
    for i in range(runs):
        for arm in walls:
            extra = list(INLINE)
            stop = threading.Event()
            scraper = None
            if arm != "off":
                port = free_ports(1)
                extra += ["--telemetry-port", str(port)]
            if arm == "scraped":
                def scrape(port=port):
                    while not stop.is_set():
                        try:
                            urllib.request.urlopen(
                                f"http://127.0.0.1:{port}/metrics",
                                timeout=1.0).read()
                        except OSError:
                            pass
                        stop.wait(0.05)
                scraper = threading.Thread(target=scrape, daemon=True)
                scraper.start()
            try:
                secs, _, fin, out = host_plane_run(device, extra,
                                                   f"telem_{arm}_{i}", src)
            finally:
                stop.set()
                if scraper is not None:
                    scraper.join()
            if _md5(open(out, "rb").read()) != SCALE64_MD5:
                raise AssertionError(f"telemetry {arm} run {i}: md5")
            walls[arm].append({"seconds": secs,
                               "elapsed_s": fin["elapsed_s"]})
    print("[chip_smoke] phase 11 walls with and without --telemetry-port: "
          + "; ".join(f"{a} " + " / ".join(f"{r['seconds']:.4f}" for r in rr)
                      for a, rr in walls.items()), flush=True)
    return walls


def phase_shards(device, traced, big_holes=2048):
    """Phase 11, the run seen and split from outside, on the card: the
    scale corpus's hole index (``--make-index``: 64 holes); two ranks at
    once in range mode (the index fresh; ``top`` over their endpoints) and
    in round-robin mode (the index removed), and rank 1 killed by
    ``rank_death`` under --journal and resumed, each merge to the pinned
    md5; a cold process scraped throughout; the walls with and without
    --telemetry-port; ``report`` over ``traced`` (phase 7's first traced
    run's trace and metrics); and a ``big_holes`` corpus in one process
    against two ranks (range mode), their merge the single process's
    bytes."""
    import contextlib
    import io

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.io import bamindex
    from ccsx_tpu_torch.utils import synth

    src = os.path.join(WORK, "shard64.bam")
    shutil.copy2(os.path.join(WORK, "in64.bam"), src)
    rec = {"file_bytes": os.path.getsize(src)}
    t0 = time.perf_counter()
    if cli.main(["--make-index", src, "ignored"]) != 0:
        raise AssertionError("--make-index failed")
    rec["index_s"] = time.perf_counter() - t0
    idx = bamindex.load_index(src)
    if idx is None or idx["n_holes"] != SCALE64_HOLES:
        raise AssertionError(f"index of the scale corpus: {idx}")
    out = os.path.join(WORK, "shard64.fa")
    rec["range"] = shard_pair(device, src, out, ports=free_ports(2))
    rec["scraped"] = scraped_cold_run(
        device, src, os.path.join(WORK, "scraped64.fa"), free_ports(1))
    rec["telemetry_walls"] = telemetry_walls(device, src)
    os.remove(src + bamindex.INDEX_SUFFIX)
    rec["rr"] = shard_pair(device, src, out)
    rec["killed"] = shard_pair(device, src, out, kill=SHARD_KILL_AT)
    for mode in ("range", "rr", "killed"):
        r = rec[mode]
        print(f"[chip_smoke] phase 11 {mode}: md5 {r['md5']}, merge "
              f"{r['merge_s']:.4f}s, ranks {r['ranks']}", flush=True)
        if r["md5"] != SCALE64_MD5:
            raise AssertionError(f"phase 11 {mode}: merged md5 {r['md5']}")
    for k, r in enumerate(rec["range"]["ranks"]):
        lo, hi = bamindex.hole_range(SCALE64_HOLES, k, 2)
        if r["holes_total"] != hi - lo or not 0 < r["ingest_bytes"] <= \
                rec["file_bytes"]:
            raise AssertionError(f"phase 11 range rank: {r}")
    for r in rec["rr"]["ranks"]:
        if r["ingest_bytes"] != rec["file_bytes"] or r["holes_total"]:
            raise AssertionError(f"phase 11 round-robin rank: {r}")

    html = os.path.join(WORK, "report.html")
    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        rc = cli.main(["report", *traced, "-o", html])
    page = open(html, encoding="utf-8").read() if rc == 0 else ""
    rec["report"] = {"bytes": len(page), "spans": {
        k: page.count(f"<title>{k} [") for k in ("refine_packed",
                                                 "pair_fill")}}
    print(f"[chip_smoke] phase 11 report over {traced}: {rec['report']}",
          flush=True)
    if rc != 0 or "<svg" not in page or not all(rec["report"]["spans"]
                                                .values()):
        raise AssertionError(f"report: rc {rc}, {rec['report']}")

    if big_holes:
        big = os.path.join(WORK, f"big{big_holes}.bam")
        t0 = time.perf_counter()
        if not os.path.exists(big):
            big_corpus(big, big_holes)
        rec["big_made_s"] = time.perf_counter() - t0
        rec["big_bytes"] = os.path.getsize(big)
        one_out = os.path.join(WORK, f"big{big_holes}_one.fa")
        one = rank_record(rank_cli(["--device", device, big, one_out],
                                   one_out + ".jsonl"))
        one_md5 = _md5(open(one_out, "rb").read())
        if cli.main(["--make-index", big, "ignored"]) != 0:
            raise AssertionError("--make-index failed on the big corpus")
        pair = shard_pair(device, big,
                          os.path.join(WORK, f"big{big_holes}.fa"))
        rec["big"] = {"one": one, "one_md5": one_md5, "pair": pair}
        print(f"[chip_smoke] phase 11 {big_holes} holes: one process "
              f"{one}, md5 {one_md5}; two ranks {pair['ranks']}, merge "
              f"{pair['merge_s']:.4f}s, md5 {pair['md5']}", flush=True)
        if pair["md5"] != one_md5:
            raise AssertionError(f"phase 11 {big_holes} holes: the merge "
                                 "differs from the single process")
    return rec


# phase 12: the resident server and its replica fleet, each a real process
# on the card.  The server's own filters pass both corpora (the long
# molecules' subreads total more than -M's default 500,000 bases; SCALE64's
# at most 65,487, so its bytes do not change)
SERVE_FLAGS = ["-M", "4000000"]
# a SCALE64 job: inline prep and a pinned window of 16 holes, so each job's
# slabs are a function of its input alone (two jobs at once hold 32 of the
# fair window's 64 slots: no admission is ever denied)
SERVE_JOB = {"prep_threads": 0, "inflight": 16}
# the OOM pair: the CLI's adaptive window under inline prep, so the
# faulted job's first sweep is phase 8's (where device_oom@2 meets a
# group of more than one request and resplits it)
SERVE_OOM_JOB = {"prep_threads": 0}
# the injected stall of the cancel and drain jobs (server environment)
SERVE_STALL_S = "4"
# the fleet's lease timeout: a killed replica's job goes to the survivor
# at most this long after its last renewal
FLEET_LEASE_S = 8
SERVE_KERNELS = ("banded_global", "banded_local", "traceback_walk")
# the fleet's replicas run --banded-impl rotband: its fill and the walk,
# never the band-local global fill
FLEET_KERNELS = ("banded_rotband", "traceback_walk")


def http_json(method, url, body=None, timeout=30.0):
    """(status, parsed JSON body or raw bytes) of one request; HTTP errors
    are answers, not exceptions."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            code, raw = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw


class ServeProc:
    """One ``python -m ccsx_tpu_torch.cli <argv>`` process (serve or
    gateway), its stderr in a log file; stopped (SIGKILL) by ``close`` if
    still running."""

    def __init__(self, argv, log, env_extra=None):
        env = dict(os.environ, PYTHONPATH=HERE, **(env_extra or {}))
        env.pop("CCSX_FAULTS", None)
        self.log = log
        self.base = None
        self._f = open(log, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ccsx_tpu_torch.cli", *argv], cwd=HERE,
            env=env, stdout=self._f, stderr=subprocess.STDOUT)

    def bound(self):
        """The URL the process printed it serves on, or None yet (a port
        that is taken — a stopped server's, in TIME_WAIT — auto-bumps)."""
        import re

        self._f.flush()
        m = re.findall(r"(?:serve|gateway): http://[^:]+:(\d+) ",
                       open(self.log).read())
        return f"http://127.0.0.1:{m[-1]}" if m else None

    def wait_ready(self, timeout=240.0):
        """Seconds from the process's start to its first /readyz 200; the
        URL it serves on is left in ``base``."""
        while time.perf_counter() - self.t0 < timeout:
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.log}: exited "
                                     f"{self.proc.returncode}:\n"
                                     f"{self.tail()}")
            self.base = self.bound()
            try:
                code = self.base and http_json(
                    "GET", self.base + "/readyz", timeout=2.0)[0]
                if code == 200:
                    return time.perf_counter() - self.t0
            except OSError:
                pass
            time.sleep(0.05)
        raise AssertionError(f"{self.log}: not ready in {timeout}s\n"
                             f"{self.tail()}")

    def stop(self, sig, timeout=180.0):
        import signal

        self.proc.send_signal(getattr(signal, sig))
        rc = self.proc.wait(timeout)
        self._f.close()
        return rc

    def tail(self, n=4000):
        self._f.flush()
        return open(self.log).read()[-n:]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        if not self._f.closed:
            self._f.close()


def serve_wave(base, payloads, timeout=300.0):
    """Submit every job at once, then wait for each: per job its submit to
    done seconds (polled every 20 ms), its final state and counters (GET
    /jobs/<id>), its output's md5."""
    ids, t_sub = [], {}
    for p in payloads:
        code, body = http_json("POST", base + "/jobs", p)
        if code != 201:
            raise AssertionError(f"submit {p}: {code} {body}")
        ids.append(body["id"])
        t_sub[body["id"]] = time.perf_counter()
    out, left = {}, set(ids)
    t0 = time.perf_counter()
    while left and time.perf_counter() - t0 < timeout:
        for jid in sorted(left):
            code, info = http_json("GET", f"{base}/jobs/{jid}")
            if code == 200 and info.get("state") in (
                    "done", "failed", "cancelled", "interrupted"):
                info["submit_to_done_s"] = time.perf_counter() - t_sub[jid]
                out[jid] = info
                left.discard(jid)
        time.sleep(0.02)
    if left:
        raise AssertionError(f"jobs {sorted(left)} not finished in "
                             f"{timeout}s")
    for jid in ids:
        if out[jid]["state"] == "done":
            code, data = http_json("GET", f"{base}/jobs/{jid}/output")
            out[jid]["md5"] = _md5(data if isinstance(data, bytes)
                                   else json.dumps(data).encode())
    return [out[jid] for jid in ids]


def job_record(info):
    """What phase 12 keeps of one served job."""
    m = info.get("metrics") or {}
    return {"id": info["id"], "state": info["state"], "rc": info["rc"],
            "md5": info.get("md5"),
            "submit_to_done_s": info.get("submit_to_done_s"),
            "elapsed_s": m.get("elapsed_s"), "slabs": m.get("slabs"),
            "eager": m.get("eager_dispatches"),
            "replays": m.get("graph_replays"),
            "oom_resplits": m.get("oom_resplits"),
            "failed_steps": m.get("failed_steps"),
            "launches": m.get("launches"), "replica": info.get("replica")}


def check_jobs(tag, recs, md5, steady=False):
    """Each job done to ``md5``, its own launches through SERVE_KERNELS and
    never the rotating-band fill, no step failed over; ``steady``: no eager
    dispatch, every slab a graph replay."""
    kernels, absent = SERVE_KERNELS, ("banded_rotband",)
    bad = []
    for r in recs:
        n = r["launches"] or {}
        if r["state"] != "done" or r["md5"] != md5:
            bad.append(f"{r['id']}: {r['state']} md5 {r['md5']}")
        elif any(n.get(k, 0) <= 0 for k in kernels) or any(
                n.get(k, 0) for k in absent):
            bad.append(f"{r['id']}: launches {n}")
        elif r["failed_steps"]:
            bad.append(f"{r['id']}: failed_steps {r['failed_steps']}")
        elif steady and (r["eager"] != 0 or r["replays"] != r["slabs"]):
            bad.append(f"{r['id']}: eager {r['eager']}, replays "
                       f"{r['replays']}, slabs {r['slabs']}")
    print(f"[chip_smoke] phase 12 {tag}: " + json.dumps(recs), flush=True)
    if bad:
        raise AssertionError(f"phase 12 {tag}: {bad}")


def check_oom(oom):
    """The device_oom@2 job and its clean sibling: both to the md5, the
    OOM resplit in the faulted job only."""
    check_jobs("device_oom@2 beside a clean job", oom, SCALE64_MD5)
    if oom[0]["oom_resplits"] < 1 or oom[1]["oom_resplits"]:
        raise AssertionError(f"phase 12 oom_resplits: {oom}")


def wait_state(base, jid, states, timeout=120.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        code, info = http_json("GET", f"{base}/jobs/{jid}")
        if code == 200 and info.get("state") in states:
            return info
        time.sleep(0.02)
    raise AssertionError(f"job {jid} never reached {states}")


def phase_serve(device, cold=None):
    """Phase 12, the resident server and its replica fleet on the card, each
    a ``python -m ccsx_tpu_torch.cli`` process: a solo ``serve`` (its
    start-to-ready seconds); a warm wave (two SCALE64 jobs at once, each to
    the pinned md5 with its own launches of the default arm's kernels; then
    two long-molecule jobs at once to theirs); a steady wave (four SCALE64
    jobs and one long-molecule job) that builds no refine program on
    ``/progress`` and whose SCALE64 jobs dispatch nothing eagerly (replays
    = slabs); a ``device_oom@2`` job beside a clean one (both to the md5,
    ``oom_resplits`` >= 1 in the faulted job only); a cancel mid-job (a
    ``stall``); SIGTERM with a job in flight (rc 75) and a restart of the
    same command that finishes it to the md5; then two ``serve --fleet``
    replicas under ``--banded-impl rotband`` behind ``gateway``, four
    SCALE64 jobs through the gateway and the replica holding a running job
    SIGKILLed: every job to the md5 with the rotating-band fill launched
    and the band-local one not, exactly one done marker a job.  ``cold``:
    phase 10's cold default CLI process medians, for the report."""
    from ccsx_tpu_torch.utils import synth

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "serve")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    bam = os.path.join(WORK, "in64.bam")
    if not os.path.exists(bam):
        synth.make_big_bam(bam, SCALE64_HOLES, np.random.default_rng(42))
    long_fa = os.path.join(WORK, "long.fa")
    if not os.path.exists(long_fa):
        synth.make_long_fasta(long_fa, 4, 50000, 8, 11)
    s64 = dict(SERVE_JOB, input=bam)
    lng = dict(SERVE_JOB, input=long_fa, format="fasta")
    rec = {"start_to_ready_s": []}
    procs = []
    try:
        argv = ["serve", "--port", str(free_ports(1)), "--spool",
                os.path.join(d, "spool"), "--max-active", "2", "--device",
                device, *SERVE_FLAGS]
        env = {"CCSX_FAULT_STALL_S": SERVE_STALL_S}
        srv = ServeProc(argv, os.path.join(d, "serve.log"), env)
        procs.append(srv)
        rec["start_to_ready_s"].append(srv.wait_ready())
        base = srv.base

        warm = [job_record(i) for i in serve_wave(base, [s64, s64])]
        check_jobs("warm wave, SCALE64", warm, SCALE64_MD5)
        warm_long = [job_record(i) for i in serve_wave(base, [lng, lng])]
        check_jobs("warm wave, long molecules", warm_long, LONG_MD5)
        _, prog = http_json("GET", base + "/progress")
        after_warm = prog["programs"]
        steady = [job_record(i) for i in serve_wave(base, [s64] * 4 + [lng])]
        check_jobs("steady wave, SCALE64", steady[:4], SCALE64_MD5,
                   steady=True)
        check_jobs("steady wave, long molecules", steady[4:], LONG_MD5)
        _, prog = http_json("GET", base + "/progress")
        after_steady = prog["programs"]
        rec.update(warm=warm, warm_long=warm_long, steady=steady,
                   programs={"warm": after_warm, "steady": after_steady})
        print(f"[chip_smoke] phase 12 programs after the warm wave "
              f"{after_warm}, after the steady wave {after_steady}",
              flush=True)
        if after_steady["builds"] != after_warm["builds"]:
            raise AssertionError("phase 12: the steady wave built "
                                 f"{after_steady['builds'] - after_warm['builds']}"
                                 " refine programs")

        pair = dict(SERVE_OOM_JOB, input=bam)
        rec["oom"] = [job_record(i) for i in serve_wave(
            base, [dict(pair, faults="device_oom@2"), pair])]
        check_oom(rec["oom"])

        code, body = http_json("POST", base + "/jobs",
                               dict(s64, faults="stall@1"))
        jid = body["id"]
        wait_state(base, jid, ("running",))
        time.sleep(0.5)
        code, body = http_json("DELETE", f"{base}/jobs/{jid}")
        info = wait_state(base, jid, ("cancelled", "done", "failed"))
        rec["cancel"] = {"delete": code, "state": info["state"],
                         "rc": info["rc"]}
        print(f"[chip_smoke] phase 12 cancel mid-job: {rec['cancel']}",
              flush=True)
        if code != 200 or info["state"] != "cancelled" or info["rc"] != 75:
            raise AssertionError(f"phase 12 cancel: {rec['cancel']}")

        _, prog = http_json("GET", base + "/progress")
        rec["server_launches"] = prog["launches"]
        rec["pool_bytes"] = prog["programs"]["pool_bytes"]
        if any(prog["launches"][k] <= 0 for k in SERVE_KERNELS):
            raise AssertionError(f"phase 12 server launches {prog}")
        code, body = http_json("POST", base + "/jobs",
                               dict(s64, faults="stall@1"))
        jid = body["id"]
        wait_state(base, jid, ("running",))
        time.sleep(0.5)
        rc = srv.stop("SIGTERM")
        state = json.load(open(os.path.join(d, "spool", "state.json")))
        held = {j["id"]: j["state"] for j in state["jobs"]}
        rec["drain"] = {"rc": rc, "state": held[jid]}
        if rc != 75 or held[jid] != "interrupted":
            raise AssertionError(f"phase 12 drain: rc {rc}, {held}\n"
                                 f"{srv.tail()}")
        srv = ServeProc(argv, os.path.join(d, "serve_restart.log"), env)
        procs.append(srv)
        rec["start_to_ready_s"].append(srv.wait_ready())
        base = srv.base
        t0 = time.perf_counter()
        info = wait_state(base, jid, ("done", "failed", "cancelled"), 300)
        code, data = http_json("GET", f"{base}/jobs/{jid}/output")
        rec["restart"] = {"state": info["state"], "md5": _md5(data),
                          "seconds": time.perf_counter() - t0}
        print(f"[chip_smoke] phase 12 drain {rec['drain']}, restart "
              f"{rec['restart']}", flush=True)
        if rec["restart"]["md5"] != SCALE64_MD5:
            raise AssertionError(f"phase 12 restart: {rec['restart']}")
        rc = srv.stop("SIGTERM")
        if rc != 0:
            raise AssertionError(f"phase 12: the restarted server exited "
                                 f"{rc} on SIGTERM\n{srv.tail()}")

        rec["fleet"] = serve_fleet(device, d, s64)
    finally:
        for p in procs:
            p.close()
    rec["phase_s"] = time.perf_counter() - t_phase
    rec["cold_cli"] = cold
    solo = [r["submit_to_done_s"] for r in rec["steady"][:4]]
    print(f"[chip_smoke] phase 12 report: server start-to-ready "
          f"{rec['start_to_ready_s']} s; SCALE64 submit-to-done, warm wave "
          f"{[round(r['submit_to_done_s'], 4) for r in rec['warm']]}, steady "
          f"{[round(x, 4) for x in solo]} s (elapsed_s "
          f"{[r['elapsed_s'] for r in rec['steady'][:4]]}); cold default CLI "
          f"process (phase 10 medians) "
          f"{cold if cold else 'not measured in this run'}; pool bytes "
          f"{rec['pool_bytes']}; phase {rec['phase_s']:.1f} s", flush=True)
    return rec


def serve_fleet(device, d, s64):
    """Phase 12's fleet: ``gateway`` and two ``serve --fleet`` replicas
    (``--banded-impl rotband``) over one spool; four SCALE64 jobs through
    the gateway; the replica holding the first running job SIGKILLed.
    Returns the record; raises on a broken pin."""
    import signal

    spool = os.path.join(d, "fleet")
    os.makedirs(spool)
    base_port = free_ports(3)
    procs = {}
    rec = {}
    try:
        procs["gateway"] = ServeProc(
            ["gateway", "--spool", spool, "--port", str(base_port + 2),
             "--probe", "0.2"], os.path.join(d, "gateway.log"))
        for k in range(2):
            procs[f"r{k}"] = ServeProc(
                ["serve", "--fleet", spool, "--port", str(base_port),
                 "--replica-name", f"r{k}", "--lease-timeout",
                 str(FLEET_LEASE_S), "--poll", "0.2", "--max-active", "2",
                 "--device", device, "--banded-impl", "rotband",
                 *SERVE_FLAGS], os.path.join(d, f"r{k}.log"),
                {"CCSX_FAULT_STALL_S": SERVE_STALL_S})
        t0 = time.perf_counter()
        while procs["gateway"].bound() is None:
            if time.perf_counter() - t0 > 60:
                raise AssertionError(procs["gateway"].tail())
            time.sleep(0.05)
        gw = procs["gateway"].bound()
        while time.perf_counter() - t0 < 240:
            code, body = http_json("GET", gw + "/replicas")
            reps = body.get("replicas", []) if code == 200 else []
            if len(reps) == 2 and all(r.get("ready") for r in reps):
                break
            for name, p in procs.items():
                if p.proc.poll() is not None:
                    raise AssertionError(f"{name} exited:\n{p.tail()}")
            time.sleep(0.1)
        else:
            raise AssertionError(f"phase 12 fleet never ready: {body}")
        rec["ready_s"] = time.perf_counter() - t0
        ports = {r["name"]: r["port"] for r in reps}
        ids, t_sub = [], {}
        # the first job stalls in its first device step, so its holder is
        # killed while the job is in flight (the survivor's resume stalls
        # once more)
        for k in range(4):
            code, body = http_json("POST", gw + "/jobs", dict(
                s64, **({"faults": "stall@1"} if k == 0 else {})))
            if code != 201:
                raise AssertionError(f"gateway submit: {code} {body}")
            ids.append(body["id"])
            t_sub[body["id"]] = time.perf_counter()
        victim, victim_job = None, ids[0]
        t0 = time.perf_counter()
        while victim is None and time.perf_counter() - t0 < 120:
            _, view = http_json("GET", f"{gw}/jobs/{victim_job}")
            if view.get("state") == "running" and view.get("replica"):
                victim = view["replica"]
            time.sleep(0.02)
        if victim is None:
            raise AssertionError("phase 12 fleet: the stalled job was never "
                                 "seen running")
        time.sleep(0.5)
        _, prog = http_json(
            "GET", f"http://127.0.0.1:{ports[victim]}/progress")
        rec["victim"] = {"name": victim, "job": victim_job,
                         "launches": prog["launches"]}
        procs[victim].proc.send_signal(signal.SIGKILL)
        procs[victim].proc.wait(30)
        t_kill = time.perf_counter()
        done, t0 = {}, time.perf_counter()
        while len(done) < len(ids) and time.perf_counter() - t0 < 240:
            for jid in ids:
                if jid in done:
                    continue
                _, view = http_json("GET", f"{gw}/jobs/{jid}")
                if view.get("state") in ("done", "failed", "cancelled"):
                    view["submit_to_done_s"] = time.perf_counter() - \
                        t_sub[jid]
                    done[jid] = view
            time.sleep(0.05)
        survivor = "r1" if victim == "r0" else "r0"
        surv = f"http://127.0.0.1:{ports[survivor]}"
        jobs = []
        for jid in ids:
            view = done.get(jid) or {"id": jid, "state": "lost"}
            if view["state"] == "done":
                _, data = http_json("GET", f"{gw}/jobs/{jid}/output")
                view["md5"] = _md5(data)
                if view.get("replica") == survivor:
                    _, info = http_json("GET", f"{surv}/jobs/{jid}")
                    view["metrics"] = info.get("metrics")
            jobs.append(job_record(view))
        _, prog = http_json("GET", surv + "/progress")
        markers = sorted(n for n in os.listdir(spool)
                         if n.startswith("done.") and n.endswith(".json"))
        rec.update(jobs=jobs, survivor_launches=prog["launches"],
                   markers=markers, requeue_s=time.perf_counter() - t_kill)
        print(f"[chip_smoke] phase 12 fleet: killed {victim} mid "
              f"{victim_job}; " + json.dumps(rec), flush=True)
        bad = [j for j in jobs if j["state"] != "done"
               or j["md5"] != SCALE64_MD5]
        if bad:
            raise AssertionError(f"phase 12 fleet jobs: {bad}")
        if markers != sorted(f"done.{jid}.json" for jid in ids):
            raise AssertionError(f"phase 12 fleet markers: {markers}")
        if done[victim_job]["replica"] != survivor:
            raise AssertionError("phase 12 fleet: the killed replica's job "
                                 "was not finished by the survivor")
        # the victim may die before its first launch (its job stalls in
        # its first device step): it must only never have run the
        # band-local fill
        if rec["victim"]["launches"].get("banded_global"):
            raise AssertionError(f"phase 12 fleet: the killed replica "
                                 f"launched {rec['victim']['launches']}")
        for n in (prog["launches"],) + tuple(
                j["launches"] for j in jobs if j["launches"] is not None):
            if n.get("banded_global") or any(n.get(k, 0) <= 0
                                             for k in FLEET_KERNELS):
                raise AssertionError(f"phase 12 fleet launches {n}")
        if not any(j["launches"] is not None for j in jobs):
            raise AssertionError("phase 12 fleet: no job's own launches")
        rc = procs[survivor].stop("SIGTERM")
        rcg = procs["gateway"].stop("SIGTERM")
        rec["stop_rc"] = {survivor: rc, "gateway": rcg}
        if rc != 0 or rcg != 0:
            raise AssertionError(f"phase 12 fleet stop: {rec['stop_rc']}")
    finally:
        for p in procs.values():
            p.close()
    return rec


# phase 13: the supervisor on the card, each command a ``python -m
# ccsx_tpu_torch.cli shepherd ...`` process.  Its children read the hook
# below from their PYTHONPATH (a sitecustomize: the interpreter imports it
# at start-up): at their exit, os._exit included, each writes its kernel
# launches to its log, so a child's launches are read without a CLI flag
CHILD_HOOK = '''\
import atexit, json, os, sys


def _ccsx_launches():
    m = sys.modules.get("ccsx_tpu_torch.ops.cuda_ext")
    if m is not None:
        sys.stderr.write("[chip_smoke] child %d launches %s\\n"
                         % (os.getpid(), json.dumps(dict(m.LAUNCHES))))
        sys.stderr.flush()


_real_exit = os._exit


def _ccsx_exit(code):
    _ccsx_launches()
    _real_exit(code)


os._exit = _ccsx_exit
atexit.register(_ccsx_launches)
'''
# the retirement at which (a)'s first launches die, the device step at which
# (b)'s stall, and the leased ranges of (c)
SHEP_DEATH_AT = 10
SHEP_STALL_AT = 5
FLEET_RANGES = 8
# (c)'s join trial: the primary's only worker stalls this long in its first
# device step, so the joined worker arrives while ranges are still queued
JOIN_STALL_S = "15"


def child_hook_dir():
    d = os.path.join(WORK, "child_hook")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "sitecustomize.py"), "w") as f:
        f.write(CHILD_HOOK)
    return d


class ShepherdProc:
    """One ``python -m ccsx_tpu_torch.cli shepherd ARGV`` process, with the
    child hook on its (and so its children's) PYTHONPATH; a thread reads
    its stderr, each line stamped with ``time.time()``."""

    def __init__(self, argv, env_extra=None):
        import threading

        env = dict(os.environ)
        env.pop("CCSX_FAULTS", None)
        env.update(env_extra or {})
        env["PYTHONPATH"] = os.pathsep.join([child_hook_dir(), HERE])
        self.t0 = time.time()
        self.lines = []
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ccsx_tpu_torch.cli", "shepherd", *argv],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.time(), line.rstrip("\n")))

    def find(self, pattern):
        """(time, match) of every line matching ``pattern``."""
        import re

        out = []
        for t, line in list(self.lines):
            m = re.search(pattern, line)
            if m:
                out.append((t, m))
        return out

    def text(self):
        return "\n".join(line for _, line in list(self.lines))

    def wait(self, timeout):
        rc = self.proc.wait(timeout)
        self._reader.join(10)
        return rc

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


class MtimeWatch:
    """Every distinct mtime of some files, polled every 20 ms on a thread
    (the heartbeat the shepherd reads): ``seen[path]`` lists them."""

    def __init__(self, paths):
        import threading

        self.seen = {p: [] for p in paths}
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._poll, daemon=True)
        self._t.start()

    def _poll(self):
        while not self._stop.is_set():
            for p, ms in self.seen.items():
                try:
                    m = os.stat(p).st_mtime
                except OSError:
                    continue
                if not ms or ms[-1] != m:
                    ms.append(m)
            self._stop.wait(0.02)

    def first_after(self, paths, t, end=float("inf")):
        """Seconds from ``t`` to the first change of ``paths`` in (t,
        end), or None."""
        ms = [m for p in paths for m in self.seen[p] if t < m < end]
        return min(ms) - t if ms else None

    def close(self):
        self._stop.set()
        self._t.join(5)


def log_attempts(path):
    """A child log's attempts (the launcher's banners split it): for each,
    its text, its last launch counts and its last -v snapshot."""
    text = open(path).read()
    parts = text.split("\n=== ")[1:]
    out = []
    for part in parts:
        launches = [json.loads(ln.split(" ", 4)[4]) for ln in
                    part.splitlines()
                    if ln.startswith("[chip_smoke] child ")]
        snaps = [json.loads(ln.split(" ", 1)[1]) for ln in part.splitlines()
                 if ln.startswith("[ccsx-tpu-torch] {")]
        out.append({"banner": part.splitlines()[0],
                    "launches": launches[-1] if launches else None,
                    "final": snaps[-1] if snaps else None, "text": part})
    return out


def launched(n, kernels, absent=()):
    return bool(n) and all(n.get(k, 0) > 0 for k in kernels) and not any(
        n.get(k, 0) for k in absent)


def rank_startups(p, watch, out, journal, hosts):
    """Per rank and attempt: seconds from the shepherd's launch line to the
    rank's first heartbeat (any of its shard files) and to its first
    journal write (its first retirement)."""
    from ccsx_tpu_torch.pipeline import supervisor

    rows = []
    ups = p.find(r"rank (\d+) up \(pid (\d+), attempt (\d+)")
    for k, (t, m) in enumerate(ups):
        r = int(m.group(1))
        # this launch's beats: up to the rank's next launch
        end = min([u for u, n in ups[k + 1:] if n.group(1) == m.group(1)],
                  default=float("inf"))
        paths = supervisor._beat_paths(out, journal, r)
        rows.append({"rank": r, "attempt": int(m.group(3)),
                     "first_beat_s": watch.first_after(paths, t, end),
                     "first_retirement_s": watch.first_after(paths[:1], t,
                                                             end)})
    return rows


def shepherd_static(device, src, d, tag, argv, env, hosts=2):
    """One static shepherd run of ``src``: returns (rc, wall, the process,
    the heartbeat watch, the output path)."""
    from ccsx_tpu_torch.pipeline import supervisor

    out = os.path.join(d, f"{tag}.fa")
    journal = f"{out}.shepherd.journal"
    watch = MtimeWatch([pth for r in range(hosts)
                        for pth in supervisor._beat_paths(out, journal, r)])
    p = ShepherdProc(["--hosts", str(hosts), "--device", device, *INLINE,
                      *argv, src, out], env)
    try:
        rc = p.wait(600)
    finally:
        p.close()
        watch.close()
    return rc, time.time() - p.t0, p, watch, out


def shepherd_deaths(device, src, d):
    """(a): both ranks' first launches die at their SHEP_DEATH_AT-th
    retirement (rank_death, rc 57, inherited from the shepherd's
    environment); each restart runs clean, resumes from its shard journal
    and launches the default arm's kernels; the merge is the pinned md5.
    The kernels' build directory is emptied first, as in a fresh
    checkout: the two first launches build every kernel at once, and the
    directory must end with one library a source, no temp file left."""
    from ccsx_tpu_torch.ops import cuda_ext

    shutil.rmtree(cuda_ext.BUILD_DIR, ignore_errors=True)
    rc, wall, p, watch, out = shepherd_static(
        device, src, d, "deaths",
        ["-v", "--max-rank-restarts", "2", "--rank-backoff", "0.5"],
        {"CCSX_FAULTS": f"rank_death@{SHEP_DEATH_AT}",
         "CCSX_JOURNAL_FSYNC_S": "0"})
    rec = {"wall_s": wall, "rc": rc,
           "startups": rank_startups(p, watch, out,
                                     f"{out}.shepherd.journal", 2),
           "death_to_relaunch_s": []}
    md5 = _md5(open(out, "rb").read()) if os.path.exists(out) else None
    rec["md5"] = md5
    rec["kernel_libraries"] = sorted(os.listdir(cuda_ext.BUILD_DIR)) \
        if os.path.isdir(cuda_ext.BUILD_DIR) else []
    for r in range(2):
        died = p.find(rf"rank {r} died \(rc 57\)")
        up = p.find(rf"rank {r} up \(pid \d+, attempt 1")
        if died and up:
            rec["death_to_relaunch_s"].append(up[0][0] - died[0][0])
        att = log_attempts(f"{out}.shard{r}.log")
        # a resumed hole is ingested and neither written nor filtered nor
        # failed: the journal's cursor at the death
        rec[f"rank{r}"] = [{"banner": a["banner"],
                            "launches": a["launches"],
                            "resumed_holes": a["final"] and (
                                a["final"]["holes_in"]
                                - a["final"]["holes_out"]
                                - a["final"]["holes_filtered"]
                                - a["final"]["holes_failed"])}
                           for a in att]
    print(f"[chip_smoke] phase 13 (a) rank deaths: {json.dumps(rec)}",
          flush=True)
    if rc != 0 or md5 != SCALE64_MD5:
        raise AssertionError(f"phase 13 (a): rc {rc}, md5 {md5}\n"
                             f"{p.text()[-4000:]}")
    if device == "cuda" and sorted(
            f.split("-")[0] for f in rec["kernel_libraries"]) != sorted(
            cuda_ext.SOURCES):
        raise AssertionError(f"phase 13 (a) kernel libraries: "
                             f"{rec['kernel_libraries']}")
    for r in range(2):
        att = rec[f"rank{r}"]
        if (len(att) != 2 or "attempt 0" not in att[0]["banner"]
                or "attempt 1" not in att[1]["banner"]
                or not p.find(rf"rank {r} died \(rc 57\)")
                or att[1]["resumed_holes"] != SHEP_DEATH_AT
                or not launched(att[1]["launches"], CRASH_KERNELS)):
            raise AssertionError(f"phase 13 (a) rank {r}: {att}")
    return rec


def shepherd_stall(device, src, d, stall_timeout, startups):
    """(b): both ranks' first launches stall in their SHEP_STALL_AT-th
    device step for longer than ``stall_timeout`` (``--inject-faults``,
    forwarded, stripped from restarts); the shepherd kills each wedged
    rank, the restart runs clean, the merge is the pinned md5."""
    stall_s = stall_timeout + 120
    rc, wall, p, watch, out = shepherd_static(
        device, src, d, "stall",
        ["--max-rank-restarts", "2", "--rank-backoff", "0.5",
         "--rank-stall-timeout", str(stall_timeout),
         "--inject-faults", f"stall@{SHEP_STALL_AT}"],
        {"CCSX_FAULT_STALL_S": str(stall_s)})
    md5 = _md5(open(out, "rb").read()) if os.path.exists(out) else None
    kills = p.find(r"rank (\d+) heartbeat stale for >")
    rec = {"wall_s": wall, "rc": rc, "md5": md5,
           "rank_stall_timeout_s": stall_timeout,
           "sized_from_first_retirement_s": startups,
           "killed": sorted(int(m.group(1)) for _, m in kills),
           "startups": rank_startups(p, watch, out,
                                     f"{out}.shepherd.journal", 2)}
    for r in range(2):
        rec[f"rank{r}"] = [{"banner": a["banner"],
                            "launches": a["launches"]}
                           for a in log_attempts(f"{out}.shard{r}.log")]
    print(f"[chip_smoke] phase 13 (b) stalled ranks: {json.dumps(rec)}",
          flush=True)
    if rc != 0 or md5 != SCALE64_MD5 or not kills:
        raise AssertionError(f"phase 13 (b): rc {rc}, md5 {md5}, kills "
                             f"{rec['killed']}\n{p.text()[-4000:]}")
    for r in rec["killed"]:
        att = rec[f"rank{r}"]
        if len(att) != 2 or not launched(att[1]["launches"], CRASH_KERNELS):
            raise AssertionError(f"phase 13 (b) rank {r}: {att}")
    if not p.find(r"rank \d+ stalled; restarting in"):
        raise AssertionError(f"phase 13 (b): no restart\n{p.text()[-4000:]}")
    return rec


def fleet_mid_range(d, worker, m, timeout=300.0):
    """(pid, range, seconds waited) once ``worker`` holds a range's lease
    and has retired a hole of it (the range's journal exists) in the
    fleet directory ``d``."""
    from ccsx_tpu_torch.pipeline import fleet

    t0 = time.time()
    while time.time() - t0 < timeout:
        for i in range(m):
            try:
                rec = fleet.read_lease(d, i)
            except OSError:
                rec = None
            if rec and rec.get("worker") == worker and os.path.exists(
                    os.path.join(d, f"journal.{i}")):
                return int(rec["pid"]), i, time.time() - t0
        time.sleep(0.01)
    raise AssertionError(f"phase 13 (c): {worker} never held a range "
                         "mid-way")


def shepherd_fleet(device, src, d):
    """(c): the elastic fleet, 2 workers over FLEET_RANGES leased ranges
    with no restart budget, w1 SIGKILLed mid-range (it holds a lease and
    has retired a hole of that range): the survivor absorbs its ranges,
    the merge is the pinned md5 and the fleet directory is removed.  Then
    a join trial: one worker (stalled
    JOIN_STALL_S in its first device step) and ``shepherd --join`` adding
    one more mid-run: both rc 0, the md5, the joined worker's launches."""
    import signal

    from ccsx_tpu_torch.pipeline import fleet

    out = os.path.join(d, "fleet.fa")
    fdir = fleet.fleet_dir_for(out)
    p = ShepherdProc(["--hosts", "2", "--fleet-ranges", str(FLEET_RANGES),
                      "--max-rank-restarts", "0", "--rank-backoff", "0.5",
                      "--device", device, *INLINE, src, out],
                     {"CCSX_JOURNAL_FSYNC_S": "0"})
    rec = {}
    try:
        pid, rng_i, waited = fleet_mid_range(fdir, "w1", FLEET_RANGES)
        os.kill(pid, signal.SIGKILL)
        t_kill = time.time()
        rc = p.wait(600)
    finally:
        p.close()
    md5 = _md5(open(out, "rb").read()) if os.path.exists(out) else None
    ups = {m.group(1): t for t, m in p.find(r"worker (w\d) up \(pid")}
    w0 = log_attempts(f"{out}.fleet.w0.log")
    rec["kill"] = {"rc": rc, "md5": md5, "wall_s": time.time() - p.t0,
                   "w1_mid_range_after_start_s": waited,
                   "w1_killed_on_range": rng_i,
                   "kill_to_merge_s": (p.find(r"merged \d+ records")[0][0]
                                       - t_kill) if p.find(
                       r"merged \d+ records") else None,
                   "w1_launch_to_kill_s": t_kill - ups.get("w1", t_kill),
                   "w0_launches": w0[-1]["launches"] if w0 else None,
                   "reclaimed": bool(p.find(r"w1 died \(rc -9\); requeued"))}
    print(f"[chip_smoke] phase 13 (c) fleet, w1 killed: "
          f"{json.dumps(rec['kill'])}", flush=True)
    if (rc != 0 or md5 != SCALE64_MD5 or os.path.exists(fdir)
            or not p.find(rf"merged {SCALE64_HOLES} records from "
                          rf"{FLEET_RANGES} leased ranges")
            or not launched(rec["kill"]["w0_launches"], CRASH_KERNELS)):
        raise AssertionError(f"phase 13 (c): {rec['kill']}\n"
                             f"{p.text()[-4000:]}")

    out = os.path.join(d, "join.fa")
    fdir = fleet.fleet_dir_for(out)
    p = ShepherdProc(["--hosts", "1", "--fleet-ranges", str(FLEET_RANGES),
                      "--device", device, *INLINE, src, out],
                     {"CCSX_FAULTS": "stall@1",
                      "CCSX_FAULT_STALL_S": JOIN_STALL_S})
    j = None
    try:
        t0 = time.time()
        while fleet.load_fleet(fdir) is None:
            if time.time() - t0 > 120 or p.proc.poll() is not None:
                raise AssertionError("phase 13 (c): no fleet to join\n"
                                     + p.text()[-4000:])
            time.sleep(0.05)
        j = ShepherdProc(["--join", fdir, "--hosts", "1"])
        jrc = j.wait(600)
        rc = p.wait(600)
    finally:
        p.close()
        if j is not None:
            j.close()
    md5 = _md5(open(out, "rb").read()) if os.path.exists(out) else None
    names = [m.group(1) for _, m in j.find(r"joined worker (\S+) \(pid")]
    joined = log_attempts(f"{out}.fleet.{names[0]}.log") if names else []
    rec["join"] = {"rc": rc, "join_rc": jrc, "md5": md5,
                   "wall_s": time.time() - p.t0,
                   "joined_launches": joined[-1]["launches"] if joined
                   else None}
    print(f"[chip_smoke] phase 13 (c) join: {json.dumps(rec['join'])}",
          flush=True)
    if (rc != 0 or jrc != 0 or md5 != SCALE64_MD5
            or not launched(rec["join"]["joined_launches"],
                            ("traceback_walk",))):
        raise AssertionError(f"phase 13 (c) join: {rec['join']}\n"
                             f"{p.text()[-3000:]}\n{j.text()[-3000:]}")
    return rec


def shepherd_serve(device, src, d):
    """(d): ``shepherd --serve-replicas 2 --gateway-port P --fleet SPOOL``
    under ``--banded-impl rotband``; four SCALE64 jobs through the gateway,
    the replica holding the first (stalled) job SIGKILLed mid-job: the
    shepherd relaunches it (attempt 1) and it comes back ready, every job
    ends at the md5 with one done marker, every job read launched the
    rotating-band fill and never the band-local one; SIGTERM to the
    shepherd drains every child and the shepherd exits 0, the JAX
    package's rc when no child failed (``serve_fleet_run``)."""
    import re
    import signal

    from ccsx_tpu_torch.pipeline import gateway

    spool = os.path.join(d, "spool")
    gw_port, base = free_ports(1), free_ports(2)
    s64 = dict(SERVE_JOB, input=src)
    p = ShepherdProc(["--serve-replicas", "2", "--gateway-port",
                      str(gw_port), "--replica-backoff", "1", "--fleet",
                      spool, "--port", str(base), "--lease-timeout",
                      str(FLEET_LEASE_S), "--poll", "0.2", "--max-active",
                      "2", "--device", device, "--banded-impl", "rotband",
                      *SERVE_FLAGS], {"CCSX_FAULT_STALL_S": SERVE_STALL_S})
    rec = {}

    def ups(name):
        return [(t, int(m.group(1))) for t, m in
                p.find(rf"serve-fleet: {name} up \(pid (\d+), attempt")]

    def ready_pids():
        return {r["pid"]: r for r in gateway.discover_replicas(spool)
                if r.get("ready")}

    def wait_for(pred, what, timeout=240.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            v = pred()
            if v:
                return v
            if p.proc.poll() is not None:
                break
            time.sleep(0.02)
        raise AssertionError(f"phase 13 (d): {what}\n{p.text()[-4000:]}")

    try:
        wait_for(lambda: ups("s0") and ups("s1"), "replicas launched")
        gw_log = os.path.join(spool, "gateway.log")

        def gw_url():
            try:
                m = re.findall(r"gateway: http://[^:]+:(\d+) ",
                               open(gw_log).read())
            except OSError:
                return None
            return f"http://127.0.0.1:{m[-1]}" if m else None

        gw = wait_for(gw_url, "the gateway's port")
        first = {n: ups(n)[0] for n in ("s0", "s1")}
        wait_for(lambda: {pid for _, pid in first.values()}
                 <= set(ready_pids()), "both replicas ready")
        t_ready = time.time()
        rec["start_to_ready_s"] = {n: t_ready - t for n, (t, _) in
                                   first.items()}
        ids = []
        for k in range(4):
            code, body = http_json("POST", gw + "/jobs", dict(
                s64, **({"faults": "stall@1"} if k == 0 else {})))
            if code != 201:
                raise AssertionError(f"phase 13 (d) submit: {code} {body}")
            ids.append(body["id"])

        def holder():
            _, view = http_json("GET", f"{gw}/jobs/{ids[0]}")
            return view.get("state") == "running" and view.get("replica")

        victim = wait_for(holder, "the stalled job never ran", 120)
        time.sleep(0.5)
        old_pid = ups(victim)[-1][1]
        os.kill(old_pid, signal.SIGKILL)
        t_kill = time.time()
        died = wait_for(lambda: p.find(rf"{victim} died \(rc -9\)"),
                        "the death seen")[0][0]
        t_up, new_pid = wait_for(lambda: len(ups(victim)) > 1 and
                                 ups(victim)[1], "the relaunch")
        wait_for(lambda: new_pid in ready_pids(), "the relaunch ready")
        t_back = time.time()
        rec["victim"] = {"name": victim, "job": ids[0],
                         "kill_to_death_seen_s": died - t_kill,
                         "death_to_relaunch_s": t_up - died,
                         "relaunch_to_ready_s": t_back - t_up}

        def all_done():
            views = {}
            for jid in ids:
                _, v = http_json("GET", f"{gw}/jobs/{jid}")
                if v.get("state") not in ("done", "failed", "cancelled"):
                    return None
                views[jid] = v
            return views

        views = wait_for(all_done, "the jobs", 300)
        rec["jobs_done_after_kill_s"] = time.time() - t_kill
        live = ready_pids()
        jobs = []
        for jid in ids:
            v = views[jid]
            if v["state"] == "done":
                _, data = http_json("GET", f"{gw}/jobs/{jid}/output")
                v["md5"] = _md5(data)
            port = max((r for r in live.values()
                        if r["name"] == v.get("replica")),
                       key=lambda r: r.get("renewed") or 0,
                       default={}).get("port")
            if port:
                _, info = http_json("GET",
                                    f"http://127.0.0.1:{port}/jobs/{jid}")
                v["metrics"] = info.get("metrics")
            jobs.append(job_record(v))
        markers = sorted(n for n in os.listdir(spool)
                         if n.startswith("done.") and n.endswith(".json"))
        rec.update(jobs=jobs, markers=markers)
        attempts = log_attempts(os.path.join(spool, f"{victim}.log"))
        rec["victim"]["attempts"] = [a["banner"] for a in attempts]
        children = [pid for n in ("s0", "s1", "gateway")
                    for _, pid in ups(n)[-1:]]
        p.proc.send_signal(signal.SIGTERM)
        t_term = time.time()
        rc = p.wait(120)
        rec["stop"] = {"rc": rc, "seconds": time.time() - t_term,
                       "children_alive": [pid for pid in children
                                          if os.path.exists(
                                              f"/proc/{pid}")]}
        for n in ("s0", "s1"):
            last = log_attempts(os.path.join(spool, f"{n}.log"))[-1]
            rec["stop"][n] = {"launches": last["launches"],
                              "drained": "SIGTERM" in last["text"]}
    finally:
        p.close()
    print(f"[chip_smoke] phase 13 (d) serve fleet: {json.dumps(rec)}",
          flush=True)
    bad = [j for j in rec["jobs"] if j["state"] != "done"
           or j["md5"] != SCALE64_MD5 or not launched(
               j["launches"], FLEET_KERNELS, ("banded_global",))]
    if bad or rec["markers"] != sorted(f"done.{jid}.json" for jid in ids):
        raise AssertionError(f"phase 13 (d) jobs: {bad or rec['markers']}")
    if len(rec["victim"]["attempts"]) != 2 or \
            "attempt 1" not in rec["victim"]["attempts"][1]:
        raise AssertionError(f"phase 13 (d) relaunch: {rec['victim']}")
    stop = rec["stop"]
    if stop["rc"] != 0 or stop["children_alive"] or not all(
            stop[n]["drained"] and stop[n]["launches"] is not None
            for n in ("s0", "s1")):
        raise AssertionError(f"phase 13 (d) stop: {stop}")
    return rec


def phase_supervisor(device):
    """Phase 13, the supervisor on the card: (a) rank deaths restarted and
    resumed, (b) stalled ranks killed at a ``--rank-stall-timeout`` sized
    from (a)'s measured start-ups, (c) the elastic fleet with a killed
    worker and a mid-run join, (d) the supervised serve fleet with a killed
    replica relaunched; each on the SCALE64 BGZF BAM with its hole index,
    each to the pinned md5."""
    import math

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.io import bamindex
    from ccsx_tpu_torch.utils import synth

    t_phase = time.perf_counter()
    d = os.path.join(WORK, "supervisor")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    bam = os.path.join(WORK, "in64.bam")
    if not os.path.exists(bam):
        synth.make_big_bam(bam, SCALE64_HOLES, np.random.default_rng(42))
    src = os.path.join(d, "in64.bam")
    shutil.copy2(bam, src)
    if cli.main(["--make-index", src, "ignored"]) != 0 or \
            bamindex.load_index(src)["n_holes"] != SCALE64_HOLES:
        raise AssertionError("phase 13: the scale corpus's index")
    rec = {"deaths": shepherd_deaths(device, src, d)}
    # the stall timeout: twice the slowest first launch's seconds from its
    # launch to its first retirement (start-up plus the first sweep)
    first = [r["first_retirement_s"] for r in rec["deaths"]["startups"]
             if r["attempt"] == 0 and r["first_retirement_s"]]
    if not first:
        raise AssertionError(f"phase 13: no first retirement seen: "
                             f"{rec['deaths']['startups']}")
    timeout = math.ceil(2 * max(first))
    rec["stall"] = shepherd_stall(device, src, d, timeout, first)
    rec["fleet"] = shepherd_fleet(device, src, d)
    rec["serve"] = shepherd_serve(device, src, d)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[chip_smoke] phase 13 in {rec['phase_s']:.1f}s", flush=True)
    return rec


# ---- phase 14: the resilience plane ------------------------------------

# the injected hang of (a) and (d): far past every run of the phase, so the
# abandoned calls never wake inside it (no late launches in the counts)
RESIL_HANG_S = "600"
# (b)'s second run: the card "heals" when the half-open probe is due (a
# hook of this script alone: the schedule device_oom@1+ stops at the first
# probe), so the probe's success closes the breaker
PROBE_HEALS = """
from ccsx_tpu_torch.pipeline import resilience as _resil
from ccsx_tpu_torch.utils import faultinject as _fi
_admit = _resil.CircuitBreaker.admit
def _heal_at_probe(self):
    mode = _admit(self)
    if mode == "probe":
        _fi.disarm()
    return mode
_resil.CircuitBreaker.admit = _heal_at_probe
"""
# a process that exits while a daemon thread waits for a spinning kernel
# (argv[1]: the spin's cycles, argv[2]: "exit" or "os_exit"); it prints the
# moment it starts to exit
EXIT_PARKED = """
import os, sys, threading, time
import torch
x = torch.zeros(1, device="cuda")
torch.cuda.synchronize()
torch.cuda._sleep(int(sys.argv[1]))
y = x + 1
parked = threading.Event()
def wait():
    parked.set()
    y.cpu()
threading.Thread(target=wait, daemon=True).start()
parked.wait()
time.sleep(0.2)
print("exiting", time.time(), flush=True)
if sys.argv[2] == "os_exit":
    os._exit(0)
"""


def spin_cycles(seconds):
    """The cycles of ``torch.cuda._sleep`` that spin about ``seconds`` on
    this card (timed with CUDA events on a 2e7-cycle probe)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    probe = int(2e7)
    a.record()
    torch.cuda._sleep(probe)
    b.record()
    torch.cuda.synchronize()
    return int(probe * seconds * 1e3 / a.elapsed_time(b))


def _resil_final(r):
    f = r["final"] or {}
    return {k: f.get(k) for k in (
        "device_hangs", "degraded", "host_fallbacks", "failed_steps",
        "breaker_trips", "breaker_probes", "breaker_state", "oom_resplits",
        "holes_out", "holes_failed")}


def resilience_cli(device, name, extra, env=None, runner=None):
    """One CLI process of phase 14 on the scale corpus under inline prep:
    rc, wall, md5, its launches and the resilience counters of its final
    snapshot."""
    bam = os.path.join(WORK, "in64.bam")
    out = os.path.join(WORK, f"resil_{name}.fa")
    if os.path.exists(out):
        os.remove(out)
    r = crash_cli(["--device", device, *INLINE, *extra, bam, out], env,
                  runner=runner or CRASH_RUNNER)
    data = open(out, "rb").read() if os.path.exists(out) else b""
    rec = {"name": name, "argv": extra, "rc": r["rc"],
           "seconds": r["seconds"], "md5": _md5(data),
           "launches": r["launches"], **_resil_final(r)}
    print(f"[chip_smoke] phase 14 {name}: {json.dumps(rec)}", flush=True)
    if "Traceback" in r["stderr"]:
        rec["traceback"] = r["stderr"][-3000:]
    return rec


def _launched(n, want, absent=()):
    n = n or {}
    return all(n.get(k, 0) > 0 for k in want) and not any(
        n.get(k, 0) for k in absent)


def check_resil(rec, problems, want, absent=(), **conds):
    """Append what ``rec`` (resilience_cli's) breaks: rc 0, the md5, no
    traceback, its launches through ``want`` and never ``absent``, and each
    ``conds`` entry (a counter's name -> a predicate)."""
    name = rec["name"]
    if rec["rc"] != 0 or rec["md5"] != SCALE64_MD5 or "traceback" in rec:
        problems.append(f"{name}: rc {rec['rc']}, md5 {rec['md5']}, "
                        f"{rec.get('traceback', '')}")
    if not _launched(rec["launches"], want, absent):
        problems.append(f"{name}: launches {rec['launches']}")
    for k, ok in conds.items():
        if not ok(rec.get(k)):
            problems.append(f"{name}: {k} {rec.get(k)!r}")


def resil_processes(device):
    """(a) and (b): four CLI processes, at once — the injected permanent
    hang under both global-fill arms, the tripped breaker, and the tripped
    breaker healed by its probe."""
    from concurrent.futures import ThreadPoolExecutor

    hang = {"CCSX_FAULT_HANG_S": RESIL_HANG_S}
    jobs = [
        ("hang", ["--dispatch-deadline", "2", "--inject-faults",
                  "device_hang@1"], hang, None),
        ("hang_rotband", ["--dispatch-deadline", "2", "--inject-faults",
                          "device_hang@1", "--banded-impl", "rotband"],
         hang, None),
        ("breaker", ["--breaker-strikes", "2", "--inject-faults",
                     "device_oom@1+"], None, None),
        ("breaker_probe", ["--breaker-strikes", "2", "--breaker-probe-s",
                           "0.2", "--inject-faults", "device_oom@1+"],
         None, PROBE_HEALS + CRASH_RUNNER),
    ]
    with ThreadPoolExecutor(len(jobs)) as ex:
        recs = list(ex.map(lambda j: resilience_cli(device, *j), jobs))
    return dict(zip((j[0] for j in jobs), recs))


def spun_dispatch(device, extra=(), hangs=1, seconds=3.0, deadline=1.0):
    """(c): a real kernel past its deadline.  In this process, in phase
    10's eager arm (graphs.CAPTURE_AT past every shape, a program cache of
    its own: every refine dispatch eager, so no dispatch builds a program
    behind the spin) after one warm-up run of that arm with ``extra``, the
    first eager refine dispatch queues a ``torch.cuda._sleep`` of about
    ``seconds`` ahead of its work (a hook of this script), under
    ``--dispatch-deadline deadline`` and a grace of 1: the materialize wait
    is abandoned at the deadline, and the group's per-request replay,
    queued behind the spin on the same card, finishes once it ends, with
    the md5.  ``hangs``: the expiries the run must book (None: at least
    one)."""
    import threading

    import torch

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.ops import cuda_ext
    from ccsx_tpu_torch.pipeline import graphs

    cycles = spin_cycles(seconds)
    real = graphs._run_eager
    spun = []

    def run_eager(key, seen, dev, host):
        if not spun:
            spun.append((threading.current_thread().name,
                         time.perf_counter()))
            torch.cuda._sleep(cycles)
        return real(key, seen, dev, host)

    bam = os.path.join(WORK, "in64.bam")
    out = os.path.join(WORK, "resil_spun.fa")
    m = os.path.join(WORK, "resil_spun_metrics.jsonl")
    for f in (out, m):
        if os.path.exists(f):
            os.remove(f)
    old = os.environ.get("CCSX_DEADLINE_GRACE")
    with dispatch_arm(EAGER):
        warm_s = phase_scale64(device, [*INLINE, *extra])[0]
        os.environ["CCSX_DEADLINE_GRACE"] = "1"
        graphs._run_eager = run_eager
        cuda_ext.reset_counts()
        try:
            t0 = time.perf_counter()
            rc = cli.main(["--device", device, *INLINE, *extra,
                           "--dispatch-deadline", str(deadline),
                           "--metrics", m, bam, out])
            wall = time.perf_counter() - t0
        finally:
            graphs._run_eager = real
            if old is None:
                os.environ.pop("CCSX_DEADLINE_GRACE", None)
            else:
                os.environ["CCSX_DEADLINE_GRACE"] = old
    counts = dict(cuda_ext.LAUNCHES)
    t1 = time.perf_counter()
    for t in threading.enumerate():
        if t.name.startswith("ccsx-bounded-"):
            t.join(60)
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ccsx-bounded-")]
    fin = [e for e in read_jsonl(m) if e["event"] == "final"][0]
    rec = {"argv": list(extra), "spin_s": seconds, "deadline_s": deadline,
           "rc": rc,
           "wall_s": wall, "eager_arm_warm_s": warm_s,
           "spin_thread": spun[0][0] if spun else None,
           "spin_queued_at_s": spun[0][1] - t0 if spun else None,
           "md5": _md5(open(out, "rb").read()) if rc == 0 else None,
           "launches": counts, "abandoned_joined_s": time.perf_counter() - t1,
           "threads_left": left,
           **{k: fin.get(k) for k in ("device_hangs", "host_fallbacks",
                                      "failed_steps", "degraded")}}
    print(f"[chip_smoke] phase 14 (c) a spinning kernel past its deadline: "
          f"{json.dumps(rec)}", flush=True)
    problems = []
    if rc != 0 or rec["md5"] != SCALE64_MD5:
        problems.append(f"rc {rc}, md5 {rec['md5']}")
    if rec["spin_thread"] != "ccsx-bounded-dispatch":
        problems.append(f"the spin was queued on {rec['spin_thread']}")
    if (rec["device_hangs"] or 0) < 1 or not rec["host_fallbacks"] or (
            hangs is not None and rec["device_hangs"] != hangs):
        problems.append(f"device_hangs {rec['device_hangs']}, host_fallbacks "
                        f"{rec['host_fallbacks']}")
    if not rec["spin_queued_at_s"] or \
            wall < rec["spin_queued_at_s"] + 0.9 * seconds:
        problems.append(f"the run ended before the spin could: {wall:.3f}s")
    if left or not _launched(counts, CRASH_KERNELS):
        problems.append(f"threads left {left}, launches {counts}")
    if problems:
        raise AssertionError(f"phase 14 (c): {problems}")
    return rec


def exit_parked(seconds=6.0):
    """A process exiting (sys.exit, then os._exit) while a daemon thread
    waits in a device-to-host copy queued behind a kernel that spins
    ``seconds``: the seconds from its start of exit to its end."""
    cycles = spin_cycles(seconds)
    rec = {"spin_s": seconds}
    for how in ("exit", "os_exit"):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", EXIT_PARKED, str(cycles),
                            how], cwd=HERE, capture_output=True, text=True,
                           timeout=300, env=dict(os.environ,
                                                 PYTHONPATH=HERE))
        t_end = time.time()
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("exiting ")]
        rec[how] = {"rc": r.returncode, "process_s": time.perf_counter() - t0,
                    "exit_s": (t_end - float(lines[0].split()[1])
                               if lines else None)}
    print(f"[chip_smoke] phase 14 (c) exit with a thread parked in a CUDA "
          f"wait: {json.dumps(rec)}", flush=True)
    for how in ("exit", "os_exit"):
        if rec[how]["rc"] != 0 or rec[how]["exit_s"] is None:
            raise AssertionError(f"phase 14 (c) exit: {rec}")
    return rec


def served_hang(device):
    """(d): one ``serve`` process, two SCALE64 jobs at once, one with
    ``{"faults": "device_hang@1", "dispatch_deadline_s": 1.5}``: both to the
    md5, the hang and its replays booked in that job alone, its own
    launches through the three kernels, the server ready throughout and
    drained to rc 0 with the abandoned call still parked."""
    d = os.path.join(WORK, "resil_serve")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    bam = os.path.join(WORK, "in64.bam")
    s64 = dict(SERVE_JOB, input=bam)
    argv = ["serve", "--port", str(free_ports(1)), "--spool",
            os.path.join(d, "spool"), "--max-active", "2", "--device",
            device, *SERVE_FLAGS]
    srv = ServeProc(argv, os.path.join(d, "serve.log"),
                    {"CCSX_FAULT_HANG_S": RESIL_HANG_S})
    try:
        ready = srv.wait_ready()
        infos = serve_wave(srv.base, [
            dict(s64, faults="device_hang@1", dispatch_deadline_s=1.5), s64])
        code, _ = http_json("GET", srv.base + "/readyz")
        t0 = time.perf_counter()
        rc = srv.stop("SIGTERM")
        stop_s = time.perf_counter() - t0
    finally:
        srv.close()
    jobs = []
    for info in infos:
        m = info.get("metrics") or {}
        jobs.append({**job_record(info), **{k: m.get(k) for k in (
            "device_hangs", "host_fallbacks", "degraded")}})
    rec = {"start_to_ready_s": ready, "jobs": jobs, "readyz_after": code,
           "sigterm_rc": rc, "sigterm_to_exit_s": stop_s}
    print(f"[chip_smoke] phase 14 (d) served jobs: {json.dumps(rec)}",
          flush=True)
    bad, good = jobs
    problems = []
    for j in jobs:
        if j["state"] != "done" or j["md5"] != SCALE64_MD5 or \
                not _launched(j["launches"], SERVE_KERNELS):
            problems.append(f"{j['id']}: {j['state']} {j['md5']} "
                            f"{j['launches']}")
    if not (bad["device_hangs"] or 0) >= 1 or not bad["host_fallbacks"] \
            or not bad["degraded"]:
        problems.append(f"the faulted job: {bad}")
    if good["device_hangs"] or good["host_fallbacks"] or good["degraded"]:
        problems.append(f"the clean job: {good}")
    if code != 200 or rc != 0:
        problems.append(f"/readyz {code}, SIGTERM rc {rc}")
    if problems:
        raise AssertionError(f"phase 14 (d): {problems}\n{srv.tail()}")
    return rec


def deadline_cost(device, runs=7):
    """(e): the scale corpus in process under inline prep, deadlines off
    and at 60 s, alternating: walls, and the host milliseconds of each
    bounded dispatch and materialize call (``batch._bounded``, timed around
    in both arms); medians and quartiles, after one untimed run.  The
    refine programs' pins must be equal in both arms.  Reported, not
    gated."""
    from ccsx_tpu_torch.pipeline import batch

    real = batch._bounded
    host = {}

    def timed(resil, label, phase, fn):
        t = time.perf_counter()
        try:
            return real(resil, label, phase, fn)
        finally:
            host.setdefault(phase, []).append(time.perf_counter() - t)

    arms = {"off": INLINE, "on_60s": INLINE + ["--dispatch-deadline", "60"]}
    walls = {a: [] for a in arms}
    per_call = {a: {"dispatch": [], "materialize": []} for a in arms}
    pins = {a: [] for a in arms}
    keep = ("shapes", "builds", "eager", "replays", "rounds",
            "slabs_per_shape", "warm_replays")
    # one untimed run first: both arms start from the same program cache
    # (shapes dispatched once so far build their programs here)
    phase_scale64(device, INLINE)
    batch._bounded = timed
    try:
        for _ in range(runs):
            for arm, extra in arms.items():
                host.clear()
                secs, _, _ = phase_scale64(device, extra)
                walls[arm].append(secs)
                for ph in per_call[arm]:
                    per_call[arm][ph].append(
                        1e3 * statistics.mean(host.get(ph, [0.0])))
                pins[arm].append({k: LAST["pins"][k] for k in keep})
    finally:
        batch._bounded = real
    rec = {"runs": runs, "walls_s": walls,
           "walls_quartiles": {a: quartiles(w) for a, w in walls.items()},
           "host_ms_per_call": per_call,
           "host_ms_quartiles": {a: {ph: quartiles(v) for ph, v in d.items()}
                                 for a, d in per_call.items()},
           "pins": pins["on_60s"][-1]}
    print(f"[chip_smoke] phase 14 (e) deadlines off / at 60 s, {runs} runs "
          f"each: wall (q1, median, q3) {rec['walls_quartiles']}; host ms a "
          f"bounded call {rec['host_ms_quartiles']}", flush=True)
    if any(p != pins["off"][0] for a in arms for p in pins[a]):
        raise AssertionError(f"phase 14 (e): the refine programs' pins "
                             f"differ: {pins}")
    return rec


def phase_resilience(device):
    """Phase 14, the resilience plane on the card: (a) an injected
    permanent hang under ``--dispatch-deadline 2`` in both global-fill
    arms, (b) a tripped breaker and one healed by its probe, (c) a real
    spinning kernel past a 1 s deadline and a process exiting with a
    thread parked in a CUDA wait, (d) a served job's hang beside a clean
    job, (e) the deadline's cost when on."""
    t_phase = time.perf_counter()
    rec = resil_processes(device)
    problems = []
    hung = dict(device_hangs=lambda v: (v or 0) >= 1, degraded=bool,
                host_fallbacks=lambda v: (v or 0) >= 1,
                seconds=lambda v: v < 0.25 * float(RESIL_HANG_S))
    check_resil(rec["hang"], problems, CRASH_KERNELS, ("banded_rotband",),
                **hung)
    check_resil(rec["hang_rotband"], problems,
                ("banded_rotband", "banded_local", "traceback_walk"),
                ("banded_global",), **hung)
    check_resil(rec["breaker"], problems, CRASH_KERNELS,
                breaker_trips=lambda v: (v or 0) >= 1,
                breaker_state=lambda v: v == "open",
                host_fallbacks=lambda v: (v or 0) >= 1)
    check_resil(rec["breaker_probe"], problems, CRASH_KERNELS,
                breaker_trips=lambda v: (v or 0) >= 1,
                breaker_probes=lambda v: (v or 0) >= 1,
                breaker_state=lambda v: v == "closed")
    if problems:
        raise AssertionError(f"phase 14 (a)/(b): {problems}")
    # one hole a sweep: the spun group is alone in its sweep; then the
    # adaptive window, where later dispatches of the same sweep may wait
    # behind the spin too (reported)
    rec["spun"] = spun_dispatch(device, ["--inflight", "1"])
    rec["spun_window"] = spun_dispatch(device, hangs=None)
    rec["exit_parked"] = exit_parked()
    rec["served"] = served_hang(device)
    rec["cost"] = deadline_cost(device)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"[chip_smoke] phase 14 in {rec['phase_s']:.1f}s", flush=True)
    return rec


MESH_SHAPES = ((4, 2), (2, 4), (8, 1))
# phase 15 (a)'s slab budget: at the default 128 rows SCALE64's plans hold
# at most 2 slabs, so a wave of 4 would leave entries idle; at this one
# every entry of a wave of 4 takes slabs of a shape several times (eager,
# capture, replays)
FUSED_ROWS = ["--slab-rows", "16"]


def logical_devices(k):
    """For the duration, the port sees the card ``k`` times
    (utils/device.local_devices): ``k`` logical devices, each with its own
    stream."""
    import contextlib

    import torch

    from ccsx_tpu_torch.utils import device as device_mod

    @contextlib.contextmanager
    def patched():
        real = device_mod.local_devices
        device_mod.local_devices = lambda device: [torch.device("cuda",
                                                                0)] * k
        try:
            yield
        finally:
            device_mod.local_devices = real
    return patched()


def captured(fn, *a, **k):
    """fn(*a, **k) with its stderr captured and echoed; (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            out = fn(*a, **k)
    finally:
        sys.stderr.write(buf.getvalue())
    return out, buf.getvalue()


def lanes_now():
    from ccsx_tpu_torch.ops import cuda_ext

    return {i: dict(v) for i, v in sorted(cuda_ext.LANE_LAUNCHES.items())}


def planned(device, extra):
    """One single-device run of the scale corpus under ``extra``: (its
    phase_scale64 record, the slab count of each (sweep, group) plan).
    Each sweep's shape groups plan their slabs once (a single-device
    dispatch never plans again)."""
    from ccsx_tpu_torch.pipeline import pack as pack_mod

    plans = []
    real_plan = pack_mod.plan_slabs

    def recording(*a, **k):
        plan = real_plan(*a, **k)
        plans.append(len(plan))
        return plan

    pack_mod.plan_slabs = recording
    try:
        return phase_scale64(device, extra), plans
    finally:
        pack_mod.plan_slabs = real_plan


def lane_programs(stats):
    """lane -> the summed stats of its packed refine programs (a fused
    program's key ends with its lane, graphs.py; lane 0 is a single
    device's)."""
    out = {}
    for key, v in stats.items():
        if key[0] != "refine_packed":
            continue
        ln = key[-1] if isinstance(key[-1], int) else 0
        acc = out.setdefault(ln, {"builds": 0, "eager": 0, "replays": 0,
                                  "warm_replays": 0})
        for name in acc:
            acc[name] += v[name]
    return out


def fused_arm(device, k, extra, plans, ref):
    """One fused run of the scale corpus over k logical devices (phase
    15 (a)): its record; raises on a broken pin.  Every entry launches
    kernels and replays its own captured programs; under ``--warmup`` the
    warmup plane built every program a wave ran (no eager dispatch) and
    warmed each on its entry."""
    with logical_devices(k):
        secs, counts, driver = phase_scale64(device, extra)
    lanes = lanes_now()
    progs = lane_programs(LAST["graphs"])
    waves = sum(-(-n // k) for n in plans)
    problems = []
    if sorted(progs) != list(range(1, k + 1)):
        problems.append(f"refine programs of lanes {sorted(progs)}")
    warm = "--warmup" in extra
    for ln, v in progs.items():
        if not v["replays"] or not v["builds"] or (
                v["eager"] if warm else not v["eager"]) or (
                warm and not v["warm_replays"]):
            problems.append(f"lane {ln} programs {v}")
    if driver["fused_waves"] != waves:
        problems.append(f"fused_waves {driver['fused_waves']} != {waves}")
    fill = round(sum(plans) / (k * waves), 4)
    if driver["fused_slot_fill"] != fill or driver["slabs"] != sum(plans):
        problems.append(f"fused_slot_fill {driver['fused_slot_fill']} / "
                        f"slabs {driver['slabs']} != {fill} / {sum(plans)}")
    if counts != ref[1]:
        problems.append(f"launches {counts} != one device's {ref[1]}")
    for name in ("banded_global", "banded_rotband", "traceback_walk"):
        if sum(v[name] for v in lanes.values()) != counts[name]:
            problems.append(f"{name}: lanes {lanes} do not add up to "
                            f"{counts[name]}")
    if sorted(lanes) != list(range(k)) or not all(
            v["traceback_walk"] for v in lanes.values()):
        problems.append(f"lanes {lanes} for k = {k}")
    if problems:
        raise AssertionError(f"phase 15 fused k={k} {extra}: {problems}")
    print(f"[chip_smoke] phase 15 fused k={k} {extra}: {secs:.3f}s, "
          f"{waves} waves, entries' launches {lanes}, lanes' programs "
          f"{progs}", flush=True)
    return {"seconds": secs, "fused_waves": waves, "fused_slots": k * waves,
            "slabs": sum(plans), "launches": counts,
            "lane_launches": lanes, "lane_programs": progs}


def mesh_arm(device, shape, ref):
    """The scale corpus under --mesh D,P over D x P logical devices
    (phase 15 (b)): its record; raises on a broken pin."""
    from ccsx_tpu_torch.ops import cuda_ext

    bam = os.path.join(WORK, "in64.bam")
    out = os.path.join(WORK, "mesh64.fa")
    d, p = shape
    with logical_devices(d * p):
        (secs, counts, driver), text = captured(
            run_cli, ["--device", device, *INLINE, "--mesh", f"{d},{p}",
                      bam, out], f"--mesh {d},{p} over {d * p} entries")
    lanes = lanes_now()
    md5 = _md5(open(out, "rb").read())
    problems = []
    if md5 != SCALE64_MD5:
        problems.append(f"md5 {md5}")
    if "pass packing disabled under --mesh" not in text:
        problems.append("no 'pass packing disabled' line")
    if driver["slabs"] or not driver["bucketed_groups"]:
        problems.append(f"grouping slabs {driver['slabs']}, bucketed "
                        f"{driver['bucketed_groups']}")
    for name in ("banded_global", "traceback_walk"):
        per = [lanes.get(i, {}).get(name, 0) for i in range(d * p)]
        if per != [ref[1][name]] * (d * p):
            problems.append(f"{name}: entries {per} != the bucketed single "
                            f"device's {ref[1][name]} each")
        if counts[name] != d * p * ref[1][name]:
            problems.append(f"{name}: {counts[name]} launches")
    if counts["banded_local"] != ref[1]["banded_local"] or \
            counts["banded_rotband"]:
        problems.append(f"launches {counts}")
    if problems:
        raise AssertionError(f"phase 15 --mesh {d},{p}: {problems}")
    print(f"[chip_smoke] phase 15 --mesh {d},{p}: {secs:.3f}s, md5 {md5}, "
          f"entries' launches {lanes}", flush=True)
    return {"seconds": secs, "md5": md5, "launches": counts,
            "lane_launches": lanes,
            "bucketed_dispatches": driver["bucketed_dispatches"]}


def phase_mesh(device):
    """Phase 15: the device mesh on one card (see the module docstring)."""
    from ccsx_tpu_torch.pipeline import graphs

    rec = {"card": card_line()}
    rot = ["--banded-impl", "rotband"]
    # the single-device runs, (a)'s at its slab budget with their plans
    one, plans = {}, {}
    for arm, extra in (("default", []), ("rotband", rot)):
        one[arm], plans[arm] = planned(device, INLINE + FUSED_ROWS + extra)
    one["default_128"] = phase_scale64(device, INLINE)
    one["bucketed"] = phase_scale64(device, INLINE + BUCKETS)
    rec["plans"] = {"slab_rows": int(FUSED_ROWS[1]),
                    "groups": len(plans["default"]),
                    "slabs": sum(plans["default"]),
                    "max_slabs_per_group": max(plans["default"]),
                    "groups_of_4_or_more": sum(
                        n >= 4 for n in plans["default"])}
    rec["fused"] = {f"k{k}_{arm}": fused_arm(
        device, k, INLINE + FUSED_ROWS + extra, plans[arm], one[arm])
        for k in (2, 4) for arm, extra in (("default", []),
                                           ("rotband", rot))}
    # the warmup plane builds and warms every entry's programs (k = 2's
    # were built by the run above: dropped first)
    graphs.clear()
    rec["fused"]["k2_warmup"] = fused_arm(
        device, 2, INLINE + FUSED_ROWS + ["--warmup"], plans["default"],
        one["default"])
    rec["mesh"] = {f"{d},{p}": mesh_arm(device, (d, p), one["bucketed"])
                   for d, p in MESH_SHAPES}
    # (c) the real CLI: one visible card ignores --mesh
    rec["one_card"] = {}
    for flag in ("4,2", "16,2"):
        (secs, counts, driver), text = captured(
            phase_scale64, device, INLINE + ["--mesh", flag])
        if counts != one["default_128"][1]:
            raise AssertionError(f"phase 15 --mesh {flag} on one card: "
                                 f"launches {counts}")
        if "--mesh ignored: single device visible" not in text:
            raise AssertionError(f"phase 15 --mesh {flag} on one card: no "
                                 "'--mesh ignored' line")
        rec["one_card"][flag] = {"seconds": secs, "launches": counts}
    # (d) two ranks joined by a gloo process group
    port = free_ports(1)
    pair = shard_pair(device, os.path.join(WORK, "in64.bam"),
                      os.path.join(WORK, "coord.fa"),
                      extra=INLINE + ["--coordinator", f"127.0.0.1:{port}"])
    if pair["md5"] != SCALE64_MD5:
        raise AssertionError(f"phase 15 --coordinator: merged md5 "
                             f"{pair['md5']}")
    rec["coordinator"] = {
        "md5": pair["md5"], "merge_s": pair["merge_s"],
        "ranks": [{"process_s": r["process_s"],
                   "elapsed_s": r["elapsed_s"],
                   "startup_s": r["process_s"] - r["elapsed_s"],
                   "launches": r["launches"]} for r in pair["ranks"]]}
    # (e) walls, not gated: the logical devices share one card
    rec["walls_s"] = {"one_device": {k: v[0] for k, v in one.items()}}
    rec["walls_s"].update({k: v["seconds"] for k, v in rec["fused"].items()})
    rec["walls_s"].update({f"mesh {k}": v["seconds"]
                           for k, v in rec["mesh"].items()})
    print("[chip_smoke] phase 15 walls (" + rec["card"] + "): "
          + json.dumps(rec["walls_s"]), flush=True)
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
    ap.add_argument("--host-planes-only", action="store_true",
                    help="build, run the scale corpus once, then phase 9 "
                         "(the host planes) alone, printing its record")
    ap.add_argument("--warmup-only", action="store_true",
                    help="build, run the scale corpus once, then phase 10 "
                         "(the warmup plane and the refine programs) "
                         "alone, printing its record")
    ap.add_argument("--shards-only", action="store_true",
                    help="build, run the scale corpus once and traced once, "
                         "then phase 11 (the index, sharded runs, "
                         "telemetry, report) alone, printing its record")
    ap.add_argument("--serve-only", action="store_true",
                    help="build, run the scale corpus once, then phase 12 "
                         "(the resident server and its replica fleet) "
                         "alone, printing its record")
    ap.add_argument("--supervisor-only", action="store_true",
                    help="build, run the scale corpus once, then phase 13 "
                         "(the supervisor: shepherd, the elastic fleet, "
                         "the supervised serve fleet) alone, printing its "
                         "record")
    ap.add_argument("--resilience-only", action="store_true",
                    help="build, run the scale corpus once, then phase 14 "
                         "(the resilience plane: dispatch deadlines, the "
                         "circuit breaker, a served job's hang) alone, "
                         "printing its record")
    ap.add_argument("--mesh-only", action="store_true",
                    help="build, run the scale corpus once, then phase 15 "
                         "(the device mesh: fused logical devices, --mesh, "
                         "--coordinator) alone, printing its record")
    ap.add_argument("--scale-walls", type=int, default=0, metavar="N",
                    help="build, run the scale corpus once, then N more "
                         "times under inline prep, printing the walls (for "
                         "an A/B: this script copied into another checkout "
                         "and run there in turns with this one's)")
    ap.add_argument("--cold-holes", type=int, default=0, metavar="N",
                    help="with --warmup-only: also two cold CLI processes "
                         "of each dispatch arm on a corpus of N holes")
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
    if args.scale_walls:
        phase_scale64("cuda", INLINE)
        walls = [phase_scale64("cuda", INLINE)[0]
                 for _ in range(args.scale_walls)]
        print(json.dumps({"scale_walls": {
            "checkout": HERE, "card": card, "walls_s": walls,
            "median_s": statistics.median(walls)}}))
        return 0
    nstate = native_state()
    if args.host_planes_only:
        phase_scale64("cuda", INLINE)
        print(json.dumps({"host_planes": phase_host_planes("cuda", nstate)}))
        return 0
    if args.shards_only:
        phase_scale64("cuda", INLINE)
        _, first = traced_scale64("cuda", "t1")
        print(json.dumps({"shards": phase_shards(
            "cuda", (first["trace"], first["metrics"]))}))
        return 0
    if args.serve_only:
        phase_scale64("cuda", INLINE)
        print(json.dumps({"serve": phase_serve("cuda")}))
        return 0
    if args.supervisor_only:
        phase_scale64("cuda", INLINE)
        print(json.dumps({"supervisor": phase_supervisor("cuda")}))
        return 0
    if args.resilience_only:
        phase_scale64("cuda", INLINE)
        print(json.dumps({"resilience": phase_resilience("cuda")}))
        return 0
    if args.mesh_only:
        phase_scale64("cuda", INLINE)
        print(json.dumps({"mesh": phase_mesh("cuda")}))
        return 0
    if args.warmup_only:
        phase_scale64("cuda", INLINE)
        print(json.dumps({"warmup": phase_warmup(
            "cuda", cold=3, big_holes=args.cold_holes)}))
        return 0

    records = phase_kernels("cuda")
    if args.kernels_only:
        print(json.dumps({"kernels": records}))
        return 0
    # a first run loads the CUDA modules of the torch ops the drivers use
    # (lazily, on first launch): the cold run a user's first CLI call sees,
    # reported apart from the warm reruns
    groups = []
    cold_s, _, cold_driver = phase_scale64("cuda", INLINE, record=groups)
    print(f"[chip_smoke] cold first run of the scale corpus: {cold_s:.3f}s "
          f"(recording its {len(groups)} local-fill groups)", flush=True)
    # the local fill's launch choices on the scale corpus's own group with
    # the most query rows
    big = max(groups, key=lambda g: int(g[1].sum()))
    records["banded_local"]["warps_ms"][
        f"SCALE64 group, {len(big[0])} pairs, qmax {big[0].shape[1]}"] = \
        time_choices(torch.device("cuda"), big[:4], big[4])
    # the batched arms under inline prep (a fixed schedule: equal launch
    # counts between reruns); "pooled" is the default flags, the prep pool
    # on, whose counts follow the threads' schedule
    arms = {"batched": INLINE, "pooled": [],
            "rotband": INLINE + ["--banded-impl", "rotband"],
            "bucketed": INLINE + BUCKETS, "per_hole": ["--batch", "off"]}
    reps = {k: [] for k in arms}
    for _ in range(2):     # alternating, so a drift falls on every arm alike
        for k, extra in arms.items():
            reps[k].append(phase_scale64("cuda", extra))
    for k, rr in reps.items():
        if k != "pooled" and rr[0][1] != rr[1][1]:
            raise AssertionError(f"SCALE64 {k}: launch counts differ between "
                                 f"reruns: {rr[0][1]} vs {rr[1][1]}")
    for _, counts, _ in reps["pooled"]:
        if any(counts[k] <= 0 for k in CRASH_KERNELS):
            raise AssertionError(f"SCALE64 pooled: launches {counts} miss a "
                                 "kernel of the default arm")
    runs = {k: rr[0] for k, rr in reps.items()}
    # the fused packed dispatch over two logical devices on the card at
    # phase 15 (a)'s slab budget (phase 15 runs the rest under
    # --mesh-only): the md5, the single-device run's launches, split
    # between the two, each replaying its own programs
    ref, plans = planned("cuda", INLINE + FUSED_ROWS)
    fused2 = fused_arm("cuda", 2, INLINE + FUSED_ROWS, plans, ref)
    # the bucketed path under the other global-fill arm, once
    buck_rot = phase_scale64("cuda", arms["rotband"] + BUCKETS)
    prof = phase_profile("cuda", INLINE)
    prof_rot = phase_profile("cuda", arms["rotband"])
    hifi_s, hifi_bases, idents = phase_hifi("cuda")
    long_arms, long_prof = phase_long("cuda")
    recorder = phase_recorder("cuda", [r[0] for r in reps["batched"]])
    crash = phase_crash("cuda", cold_driver)
    planes = phase_host_planes("cuda", nstate, {
        arm: long_arms[arm]["seconds"] for arm in ("default", "screen")})
    # phase 10's cold CLI processes (reported only) run under
    # --warmup-only alone, which keeps the full script within its time
    # with phase 14
    warm = phase_warmup("cuda", cold=0)
    # the 2048-hole pair of phase 11 runs under --shards-only alone, which
    # keeps the full script within its time with phase 13
    shards = phase_shards("cuda", (os.path.join(WORK, "rec_t1_trace.jsonl"),
                                   os.path.join(WORK,
                                                "rec_t1_metrics.jsonl")),
                          big_holes=0)
    served = phase_serve("cuda", None)
    supervised = phase_supervisor("cuda")
    resil = phase_resilience("cuda")
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
                                        "profiles": long_prof},
                      "flight_recorder": recorder,
                      "crash_resume": crash,
                      "host_planes": planes,
                      "warmup": warm,
                      "shards": shards,
                      "serve": served,
                      "supervisor": supervised,
                      "resilience": resil,
                      "fused_2_logical": fused2}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
