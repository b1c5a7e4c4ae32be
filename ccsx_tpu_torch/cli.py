"""ccsx-compatible CLI of the PyTorch/CUDA port.

Same conventions as the JAX package's CLI and the reference's getopt loop:
positional INPUT OUTPUT with '-' for stdin/stdout, -A for FASTA/Q input,
-P for whole-read mode, -X hole exclusion, -c >= 3 enforced.  The run goes
to the card; ``--device cpu`` runs the plain PyTorch versions instead.
``--batch auto`` (the default) selects the batched driver on the card and
the per-hole driver on the CPU, as the JAX package does for an accelerator
and for its CPU backend; ``--pass-buckets`` switches the batched driver
from packed slabs to the bucketed (Z, P) grouping.  The tuning knobs keep
the JAX package's spellings, defaults and error messages, and so do the
recording flags (``--metrics``, ``--trace``, ``--stall-timeout``,
``--profile``), ``--max-failed-holes``, the resilience flags
(``--dispatch-deadline``, ``--breaker-strikes``, ``--breaker-probe-s``),
the crash-safety flags
(``--journal``, ``--salvage``, ``--max-record-bytes``, ``--inject-faults``),
``--prep-threads`` (the batched driver's prep pool), ``--no-warmup``,
``--bam``, ``--telemetry-port``, the sharded-run flags (``--hosts``,
``--host-id``, ``--merge-shards``, ``--merge-unmarked``),
``--make-index`` and the fleet pull worker's ``--fleet-dir`` and
``--fleet-worker``.  On the card the warmup plane is off unless ``--warmup``
is given (the JAX CLI's is on unless ``--no-warmup``, and so is the
port's on the CPU): no run measured so far had it paying for itself on
the card (PERF.md).

    python -m ccsx_tpu_torch.cli [options] <INPUT> <OUTPUT>
    python -m ccsx_tpu_torch.cli stats <trace/metrics JSONL>...
    python -m ccsx_tpu_torch.cli blackbox <ring file or dir>...
    python -m ccsx_tpu_torch.cli top <host:port|metrics JSONL>...
    python -m ccsx_tpu_torch.cli report <trace/metrics JSONL>... [-o HTML]
    python -m ccsx_tpu_torch.cli serve [serve options] [options]
    python -m ccsx_tpu_torch.cli gateway --spool DIR [options]
    python -m ccsx_tpu_torch.cli shepherd --hosts N [options] <INPUT> <OUTPUT>
    python -m ccsx_tpu_torch.cli lint [--json] [paths]...

The subcommands are dispatched before the run's arguments are parsed.
``stats``, ``blackbox``, ``top``, ``report`` and ``gateway`` load neither
torch nor jax: they read a run's files or endpoints, or route a fleet's
jobs, on a host whose card is wedged.  ``lint`` (lint/) is the port's own
static analysis over ``ccsx_tpu_torch/``, pure ``ast``, against
``lint_baseline_torch.json``.  ``serve`` is the resident server
(pipeline/serve.py): its own options, then the run's, which configure
every job.

A sharded run is one process per rank, ``--hosts N --host-id R`` each
(several ranks may share one card), then ``--merge-shards N`` once;
``shepherd`` (pipeline/supervisor.py) launches, restarts and merges them,
runs an elastic fleet of leased ranges (``--fleet-ranges``, ``--join``),
or supervises serve replicas (``--serve-replicas``).  It loads no torch;
its children run on the card unless ``--device cpu`` is forwarded.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Optional

from ccsx_tpu_torch import exitcodes
from ccsx_tpu_torch.config import CcsConfig

USAGE = """\
Program: ccsx-tpu-torch
Version: 1.0.0
Usage  : ccsx-tpu-torch  [options] <INPUT> <OUTPUT>
Generate circular consensus sequences (ccs) from subreads.

Options:
-h             Output this help
-v             debug
-m     <int>   Minimum total length of subreads in a hole to use for generating CCS. [5000]
-M     <int>   Maximum total length of subreads in a hole to use for generating CCS. [500000]
-c     <int>   Minimum number of subreads required to generate CCS. [3]
-A             For fasta/fastq input,gzip allowed
-P             primitive bsalign,subread shred by default
-X\t\t<str>   Exclude ZMWs from output file,a comma-separated list of ID
-j     <int>   Number of threads to use. [1]

Arguments:
input          Input file.
output         Output file.

Port options (long):
--device {cuda,cpu}   the card (default) or the plain CPU path
--batch {auto,on,off} batched packed driver (on) or per-hole driver (off);
                      auto: on for cuda, off for cpu [auto]
--mesh D,P            the batched driver's device mesh, data x pass (e.g.
                      4,2): holes split over D, each hole's passes over P,
                      pass packing off; default: every card on the data
                      axis (the fused packed dispatch).  One visible card
                      ignores it (a stderr line); no effect with --batch
                      off
--inflight <int>      pin the batched driver's admission window to N holes
                      (default: adaptive, zmw_microbatch/16 growing x4 up
                      to zmw_microbatch, the reference's chunk policy)
--banded-impl {scan,pallas,rotband}
                      global-fill arm: scan and pallas (the default) run the
                      band-local kernel on the card, rotband the
                      rotating-band kernel; same output bytes either way.
                      With --device cpu each arm runs its plain version
--fastq               write FASTQ with per-base vote-margin qualities
--bam                 write unaligned BAM (qual fields + rq aux tag;
                      implies --fastq's quality computation)
--refine-iters <int>  speculative refinement rounds per window [2]
--max-passes <int>    passes beyond this are dropped [32]
--pass-buckets A,B,...
                      the bucketed A/B control: no pass packing, each
                      hole's passes padded to these buckets (ascending
                      ints, the last covering --max-passes); same output
                      bytes either way
--slab-rows <int>     pass-packing slab row budget (power of two) [128]
--slab-shape-ladder <int>
                      canonical tail-slab heights per packed shape group,
                      1-8 [2]
--warmup              capture each packed group's predicted refine
                      programs (CUDA graphs) on a background thread
                      ahead of their first dispatch (pipeline/warmup.py);
                      without it a shape's first slab runs eagerly and
                      its second captures [off on cuda, on on cpu]
--no-warmup           turn the warmup plane off (the JAX CLI's spelling;
                      the default on cuda)
--prefilter {on,off}  reject hopeless strand-walk pairs before the local
                      fill (device screen + seed statistics); off also
                      stops the walk's fwd+RC speculation.  Same output
                      bytes either way [on]
--window-growth {flush,grow}
                      at the largest window with no breakpoint: force a
                      flush, or keep growing like the reference [flush]
--prep-threads <int>  overlapped prep plane: background threads ingest
                      and run the orientation walk ahead of the admission
                      window so host prep overlaps device compute; 0 =
                      inline prep on the driver thread; output bytes
                      identical either way [auto: min(4, cores/2)]
--seed-device-min-t <int>
                      templates of at least this many bases seed on the
                      device (ops/seed_device.py), shorter ones on the
                      host; 0 seeds every pair on the host [16384]
--metrics <path>      append JSON-lines metrics events to this path
--trace <path>        flight recorder: span JSONL here (+ a Chrome
                      trace-event export at close); device spans close
                      after their CUDA work has run, and the per-group
                      table rides every metrics event
--stall-timeout <sec> hang watchdog: dump thread stacks and the in-flight
                      shape group when a device step stays open this long,
                      and mark the run degraded (0 disables; the first
                      step of each shape gets 10x this budget) [120]
--profile <dir>       run under torch.profiler (CPU and CUDA activities)
                      and write its Chrome trace into this directory
--dispatch-deadline <sec>
                      bound every batched device step's dispatch and its
                      device-to-host read: a call open past this deadline
                      is abandoned (its thread parked, its result
                      discarded) and its group replays per request on the
                      per-hole path, on the same card; the run ends rc 0
                      marked degraded.  The first call of each shape gets
                      10x.  0 = off [0]
--breaker-strikes <int>
                      circuit breaker: this many device failures (hangs,
                      OOM ladder bottoms) within 60 s trip it open, and
                      the remaining groups run per request.  0 disables
                      [3]
--breaker-probe-s <sec>
                      half-open re-probe interval of a tripped breaker:
                      one group dispatches as a probe and its success
                      closes it.  0 = stay open for the rest of the run
                      [0]
--max-failed-holes <V>
                      failure budget: an integer count (>= 0, checked per
                      failure) or a fraction of processed holes in (0, 1)
                      (checked at the end); exceeding it exits rc 2
                      [unbounded]
--journal <path>      progress journal for resumable runs: a killed run
                      re-run with the same command continues to the same
                      bytes; SIGTERM/SIGINT drain the run to rc 75
--salvage             hostile-input salvage: classified input corruption
                      (torn BGZF blocks, corrupt BAM records, truncated
                      FASTQ, bad ZMW names) is booked, the reader
                      resyncs, and every undamaged hole still emits; the
                      run exits 0 marked degraded, corrupt holes spend
                      the --max-failed-holes budget.  Off = fail-fast
                      rc 1 on the first corrupt byte
--max-record-bytes <n>
                      allocation bound on one BAM record: a corrupt
                      length field larger than this is rejected before
                      allocating [268435456]
--inject-faults p@N,...
                      deterministic fault injection; testing only
                      (points: ingest, compute, device_oom, stall,
                      device_hang, rank_death, write, journal,
                      input_corrupt, disk_full, sigterm; CCSX_FAULTS env
                      equivalent; injected kills exit rc 57)
--telemetry-port <p>  serve live telemetry for this run on a daemon
                      thread: GET /metrics (Prometheus text), /healthz
                      (ok|degraded + stall/fallback detail), /progress
                      (JSON, windowed-rate ETA); the port auto-bumps
                      when taken, sharded runs offset per rank; 0 = off
                      [0]
--hosts <int>         total ranks in a sharded run
--host-id <int>       this rank, in [0, --hosts)
--coordinator <host:port>
                      with --hosts: rendezvous the ranks through a
                      torch.distributed process group (gloo) at this
                      address; a rank that cannot reach it ends at rc 1
--merge-shards <N>    merge OUTPUT.shard0..N-1 into OUTPUT and exit
--merge-unmarked      with --merge-shards: merge a shard set that has no
                      completion markers at all
--make-index          build INPUT's BGZF hole index sidecar
                      (<INPUT>.ccsx_idx) for byte-range sharded ingest,
                      then exit

Subcommands:
stats <jsonl>...      summarize trace/metrics JSONL files
blackbox <path>...    render CCSX_BLACKBOX ring dumps
top <source>...       live dashboard over telemetry endpoints (host:port)
                      and --metrics JSONL files, ranks aggregated
report <jsonl>...     self-contained HTML report of a run's trace and
                      metrics (--fleet DIR: a spool's jobs)
serve [opts]          resident multi-tenant server: HTTP job API (POST
                      /jobs, GET /jobs/<id>[/output], DELETE /jobs/<id>,
                      /healthz, /readyz, /metrics, /progress); --fleet
                      SPOOL makes it one replica of a fleet; the run's
                      options after its own configure every job
gateway --spool DIR   balancer over a serve fleet's spool (no torch)
lint [--json] [paths] the port's static analysis over ccsx_tpu_torch/
                      against lint_baseline_torch.json; rc 0 iff clean
shepherd --hosts N [opts] <INPUT> <OUTPUT>
                      supervisor of a sharded run: launches the N ranks
                      as subprocesses (on the card unless --device cpu),
                      watches their shard-journal heartbeats (and
                      per-rank /healthz with --telemetry-port), restarts
                      a dead or stalled rank with exponential backoff
                      (it resumes from its shard journal), then merges.
                      --max-rank-restarts N [2], --rank-backoff SEC [1.0],
                      --rank-stall-timeout SEC (0 = off; size it above a
                      rank's start-up plus its first retirement) [0].
                      --fleet-ranges M: the elastic scheduler instead:
                      M leased ranges pulled by the N workers, a dead
                      worker's ranges requeued to the survivors, a
                      drained one (rc 75) a voluntary leave, stale
                      leases expired after --lease-timeout SEC [10];
                      `shepherd --join <OUTPUT>.fleet --hosts K` adds K
                      workers to a running fleet.
                      --serve-replicas N [--gateway-port P]
                      [--max-replica-restarts N] [--replica-backoff SEC]
                      --fleet SPOOL [serve and run options]: N `serve
                      --fleet` replicas and the gateway as children,
                      relaunched with backoff when they crash; SIGTERM
                      drains every child

Fleet pull worker (long):
--fleet-dir <dir>     pull leased ranges of a fleet directory (its
                      fleet.json names the input, output and ranges)
                      through the batched driver until every range is
                      retired
--fleet-worker <name> the worker's name in leases and range markers
                      [w<pid>]
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ccsx-tpu-torch", add_help=False)
    p.add_argument("-h", "--help", action="store_true", dest="help")
    p.add_argument("input", nargs="?", default="-")
    p.add_argument("output", nargs="?", default="-")
    p.add_argument("-m", type=int, default=5000, dest="min_len")
    p.add_argument("-M", type=int, default=500000, dest="max_len")
    p.add_argument("-c", type=int, default=3, dest="min_count")
    p.add_argument("-A", action="store_true", dest="fastx")
    p.add_argument("-P", action="store_true", dest="primitive")
    p.add_argument("-X", default=None, dest="exclude")
    p.add_argument("-j", type=int, default=1, dest="threads")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--mesh", default=None, metavar="D,P",
                   help="Batched-pipeline device mesh as data,pass (e.g. "
                        "4,2); default: all devices on the data axis")
    p.add_argument("--inflight", type=int, default=None)
    p.add_argument("--banded-impl", default="", dest="banded_impl",
                   choices=["", "scan", "pallas", "rotband"])
    p.add_argument("--fastq", action="store_true", dest="fastq")
    p.add_argument("--bam", action="store_true", dest="bam_out")
    p.add_argument("--prep-threads", type=int, default=None,
                   dest="prep_threads", metavar="N")
    p.add_argument("--refine-iters", type=int, default=2)
    p.add_argument("--max-passes", type=int, default=32)
    p.add_argument("--pass-buckets", default=None, metavar="A,B,...")
    p.add_argument("--slab-rows", type=int, default=None, metavar="R")
    p.add_argument("--slab-shape-ladder", type=int, default=None,
                   metavar="N", dest="slab_shape_ladder")
    p.add_argument("--warmup", action="store_true",
                   help="capture each packed group's predicted refine "
                        "programs on a background thread ahead of their "
                        "first dispatch (pipeline/warmup.py) [off on cuda, "
                        "on on cpu]")
    p.add_argument("--no-warmup", action="store_true", dest="no_warmup",
                   help="turn the warmup plane off (the default on cuda)")
    p.add_argument("--prefilter", default="on", choices=["on", "off"])
    p.add_argument("--window-growth", default="flush",
                   choices=["flush", "grow"])
    p.add_argument("--seed-device-min-t", type=int, default=None,
                   dest="seed_device_min_t", metavar="N")
    p.add_argument("--metrics", default=None)
    p.add_argument("--trace", default=None)
    p.add_argument("--stall-timeout", type=float, default=120.0,
                   dest="stall_timeout", metavar="SEC")
    p.add_argument("--profile", default=None, metavar="DIR")
    # resilient execution (pipeline/resilience.py)
    p.add_argument("--dispatch-deadline", type=float, default=0.0,
                   dest="dispatch_deadline", metavar="SEC",
                   help="Bounded-wait device dispatch: abandon a call "
                        "open past this deadline (thread parked, result "
                        "discarded) and replay its group per request on "
                        "the per-hole path; the first call of each shape "
                        "gets 10x.  0 = off [0]")
    p.add_argument("--breaker-strikes", type=int, default=None,
                   dest="breaker_strikes", metavar="N",
                   help="Circuit breaker: N device failures (hangs, OOM "
                        "ladder-bottoms) within 60s trip it open — the "
                        "remaining work runs per request.  0 disables [3]")
    p.add_argument("--breaker-probe-s", type=float, default=None,
                   dest="breaker_probe_s", metavar="SEC",
                   help="Half-open re-probe interval for a tripped "
                        "breaker: one group dispatches as a probe and "
                        "success closes it.  0 = stay open for the rest "
                        "of the run [0]")
    p.add_argument("--max-failed-holes", default=None,
                   dest="max_failed_holes", metavar="V")
    p.add_argument("--journal", default=None,
                   help="Progress journal path for resumable runs")
    p.add_argument("--salvage", action="store_true", dest="salvage")
    p.add_argument("--max-record-bytes", type=int, default=None,
                   dest="max_record_bytes", metavar="N")
    p.add_argument("--inject-faults", default=None, metavar="SPEC")
    p.add_argument("--telemetry-port", type=int, default=0,
                   dest="telemetry_port", metavar="PORT",
                   help="Serve live telemetry for this run on a daemon "
                        "thread: GET /metrics (Prometheus text), "
                        "/healthz (ok|degraded + stall/fallback "
                        "detail), /progress (JSON, windowed-rate ETA). "
                        "The port auto-bumps when taken; sharded runs "
                        "offset per rank.  0 = off [0]")
    # sharded runs (parallel/distributed.py): one process per rank with
    # --hosts N --host-id R, then merge with --merge-shards N
    p.add_argument("--hosts", type=int, default=None,
                   help="Total hosts in a sharded run")
    p.add_argument("--host-id", type=int, default=None,
                   help="This host's rank in [0, --hosts)")
    p.add_argument("--coordinator", default=None,
                   help="torch.distributed (gloo) rendezvous address "
                        "host:port of a sharded run's process group")
    p.add_argument("--merge-shards", type=int, default=None, metavar="N",
                   help="Merge OUTPUT.shard0..N-1 into OUTPUT and exit")
    p.add_argument("--merge-unmarked", action="store_true",
                   help="With --merge-shards: merge a shard set that has "
                        "NO completion markers at all (a legacy set "
                        "predating markers; indistinguishable from a "
                        "node-wide mid-run kill, so never assumed)")
    p.add_argument("--make-index", action="store_true",
                   help="Build INPUT's BGZF hole index sidecar "
                        "(<INPUT>.ccsx_idx) for byte-range sharded "
                        "multi-host ingest, then exit")
    # the fleet pull worker (pipeline/fleet.py): leased ranges of a fleet
    # directory, each through the batched driver
    p.add_argument("--fleet-dir", default=None, dest="fleet_dir",
                   metavar="DIR",
                   help="Run as a fleet pull worker against this fleet "
                        "directory: acquire a range lease, stream it, "
                        "retire it, pull the next until the queue drains")
    p.add_argument("--fleet-worker", default=None, dest="fleet_worker",
                   metavar="NAME",
                   help="Worker name recorded in leases and range done "
                        "markers (with --fleet-dir; defaults to w<pid>)")
    return p


def config_from_args(args) -> CcsConfig:
    if args.min_count < 3:
        print(f"Error! min fulllen count=[{args.min_count}] (>=3) !",
              file=sys.stderr)
        raise SystemExit(-1)
    exclude = None
    if args.exclude:
        exclude = frozenset(x for x in args.exclude.split(",") if x)
    mesh_shape = None
    if args.mesh:
        try:
            mesh_shape = tuple(int(x) for x in args.mesh.split(","))
            if len(mesh_shape) != 2 or min(mesh_shape) < 1:
                raise ValueError
        except ValueError:
            print(f"Error: --mesh expects D,P integers, got {args.mesh!r}",
                  file=sys.stderr)
            raise SystemExit(1)
    pass_buckets = None
    if args.pass_buckets:
        try:
            pass_buckets = tuple(
                int(x) for x in args.pass_buckets.split(","))
            if (not pass_buckets or min(pass_buckets) < 1
                    or list(pass_buckets) != sorted(set(pass_buckets))):
                raise ValueError
        except ValueError:
            print("Error: --pass-buckets expects ascending positive "
                  f"integers, got {args.pass_buckets!r}", file=sys.stderr)
            raise SystemExit(1)
        if pass_buckets[-1] < args.max_passes:
            print(f"Error: --pass-buckets last bucket "
                  f"{pass_buckets[-1]} must cover --max-passes "
                  f"{args.max_passes}", file=sys.stderr)
            raise SystemExit(1)
    if args.slab_rows is not None and args.slab_rows < 1:
        print(f"Error: --slab-rows must be >= 1, got {args.slab_rows}",
              file=sys.stderr)
        raise SystemExit(1)
    ladder = args.slab_shape_ladder
    if ladder is not None and not 1 <= ladder <= 8:
        print(f"Error: --slab-shape-ladder must be in [1, 8], got "
              f"{ladder}", file=sys.stderr)
        raise SystemExit(1)
    prep_threads = args.prep_threads
    if prep_threads is not None and not 0 <= prep_threads <= 64:
        print(f"Error: --prep-threads must be in [0, 64], got "
              f"{prep_threads}", file=sys.stderr)
        raise SystemExit(1)
    min_t = args.seed_device_min_t
    if min_t is not None and min_t < 0:
        print(f"Error: --seed-device-min-t must be >= 0, got {min_t}",
              file=sys.stderr)
        raise SystemExit(1)
    if args.stall_timeout < 0:
        print(f"Error: --stall-timeout must be >= 0, got "
              f"{args.stall_timeout}", file=sys.stderr)
        raise SystemExit(1)
    if args.dispatch_deadline < 0:
        print(f"Error: --dispatch-deadline must be >= 0, got "
              f"{args.dispatch_deadline}", file=sys.stderr)
        raise SystemExit(1)
    breaker_strikes = args.breaker_strikes
    if breaker_strikes is not None and breaker_strikes < 0:
        print(f"Error: --breaker-strikes must be >= 0, got "
              f"{breaker_strikes}", file=sys.stderr)
        raise SystemExit(1)
    breaker_probe = args.breaker_probe_s
    if breaker_probe is not None and breaker_probe < 0:
        print(f"Error: --breaker-probe-s must be >= 0, got "
              f"{breaker_probe}", file=sys.stderr)
        raise SystemExit(1)
    max_failed = args.max_failed_holes
    if max_failed is not None:
        try:
            max_failed = float(max_failed)
            # non-finite, negative and non-integer counts above 1 are
            # refused; 0 is a valid count: no failure tolerated
            if (not math.isfinite(max_failed) or max_failed < 0
                    or (max_failed >= 1
                        and max_failed != int(max_failed))):
                raise ValueError
        except ValueError:
            print("Error: --max-failed-holes expects an integer count "
                  ">= 0 or a fraction in (0, 1), got "
                  f"{args.max_failed_holes!r}", file=sys.stderr)
            raise SystemExit(1)
    max_record_bytes = args.max_record_bytes
    if max_record_bytes is not None and max_record_bytes < 4096:
        # a bound below any real record would reject every input; 4096
        # still lets tests drive the oversize classification cheaply
        print(f"Error: --max-record-bytes must be >= 4096, got "
              f"{max_record_bytes}", file=sys.stderr)
        raise SystemExit(1)
    return CcsConfig(
        min_subread_len=args.min_len,
        max_subread_len=args.max_len,
        min_fulllen_count=args.min_count,
        split_subread=not args.primitive,
        is_bam=not args.fastx,
        exclude_holes=exclude,
        threads=max(args.threads, 1),
        verbose=args.verbose,
        emit_quality=args.fastq or args.bam_out,
        bam_out=args.bam_out,
        prep_threads=prep_threads,
        warmup_compile=not args.no_warmup and (args.warmup
                                               or args.device != "cuda"),
        device=args.device,
        banded_impl=args.banded_impl,
        mesh_shape=mesh_shape,
        refine_iters=args.refine_iters,
        max_passes=args.max_passes,
        window_growth=args.window_growth,
        prefilter=args.prefilter != "off",
        metrics_path=args.metrics,
        trace_path=args.trace,
        stall_timeout_s=args.stall_timeout,
        dispatch_deadline_s=args.dispatch_deadline,
        max_failed_holes=max_failed,
        salvage=args.salvage,
        telemetry_port=args.telemetry_port,
        # an explicit bucket list selects the bucketed control path; the
        # default is pass packing (pipeline/pack.py)
        pass_packing=pass_buckets is None,
        **({"pass_buckets": pass_buckets} if pass_buckets else {}),
        **({"slab_rows": args.slab_rows} if args.slab_rows else {}),
        **({"slab_shape_ladder": ladder} if ladder is not None else {}),
        **({"seed_device_min_t": min_t} if min_t is not None else {}),
        **({"max_record_bytes": max_record_bytes}
           if max_record_bytes is not None else {}),
        **({"breaker_strikes": breaker_strikes}
           if breaker_strikes is not None else {}),
        **({"breaker_probe_s": breaker_probe}
           if breaker_probe is not None else {}),
    )


def main(argv: Optional[list] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "shepherd":
        # the supervisor (pipeline/supervisor.py): subprocess ranks,
        # fleet workers or serve replicas; no torch import here
        from ccsx_tpu_torch.pipeline.supervisor import shepherd_main

        return shepherd_main(argv[1:])
    if argv and argv[0] == "stats":
        # trace/metrics JSONL summarizer: no torch import, no card
        from ccsx_tpu_torch.utils import trace as trace_mod

        return trace_mod.stats_main(argv[1:])
    if argv and argv[0] == "blackbox":
        # crash-persistent ring renderer: no torch import, so it reads a
        # dead process' last events on a host whose card is wedged
        from ccsx_tpu_torch.utils import blackbox

        return blackbox.blackbox_main(argv[1:])
    if argv and argv[0] == "top":
        # live telemetry dashboard (no torch import, as stats)
        from ccsx_tpu_torch.utils import telemetry

        return telemetry.top_main(argv[1:])
    if argv and argv[0] == "report":
        # static HTML run report from trace/metrics JSONL artifacts
        from ccsx_tpu_torch.utils import report as report_mod

        return report_mod.report_main(argv[1:])
    if argv and argv[0] == "serve":
        # the resident multi-tenant server (pipeline/serve.py)
        from ccsx_tpu_torch.pipeline.serve import serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "gateway":
        # the serve fleet's balancer (pipeline/gateway.py): no torch
        # import, so it keeps routing while every replica's card is wedged
        from ccsx_tpu_torch.pipeline.gateway import gateway_main

        return gateway_main(argv[1:])
    if argv and argv[0] == "lint":
        # the port's static analysis (lint/): pure ast, no torch import
        from ccsx_tpu_torch.lint.core import lint_main

        return lint_main(argv[1:])
    args = build_parser().parse_args(argv)
    if args.help:
        print(USAGE, end="")
        return exitcodes.RC_FATAL  # like the reference's usage()
    try:
        cfg = config_from_args(args)
    except SystemExit as e:
        return int(e.code or 0)
    if args.inject_faults:
        from ccsx_tpu_torch.utils import faultinject

        try:
            faultinject.arm(args.inject_faults)
        except ValueError as e:
            print(f"Error: --inject-faults: {e}", file=sys.stderr)
            return exitcodes.RC_FATAL
    if args.fleet_dir is not None:
        # the fleet directory's state file is the authority on input,
        # output and ranges; the static topology flags cannot combine
        if (args.hosts is not None or args.host_id is not None
                or args.merge_shards is not None or args.make_index):
            print("Error: --fleet-dir is a pull worker; it cannot "
                  "combine with --hosts/--host-id/--merge-shards/"
                  "--make-index (the fleet scheduler owns those)",
                  file=sys.stderr)
            return exitcodes.RC_FATAL
        if args.bam_out:
            print("Error: --bam is not supported with --fleet-dir "
                  "(use --fastq and convert the merged output)",
                  file=sys.stderr)
            return exitcodes.RC_FATAL
        if args.batch == "off":
            print("Error: --batch off is not supported with "
                  "--fleet-dir", file=sys.stderr)
            return exitcodes.RC_FATAL
        from ccsx_tpu_torch.pipeline.fleet import run_fleet_worker

        return run_fleet_worker(args.fleet_dir, cfg,
                                worker=args.fleet_worker,
                                inflight=args.inflight)
    if args.make_index:
        if not cfg.is_bam:
            print("Error: --make-index requires BAM input (BGZF "
                  "container)", file=sys.stderr)
            return exitcodes.RC_FATAL
        from ccsx_tpu_torch.io import bam as bam_mod
        from ccsx_tpu_torch.io import bamindex

        try:
            idx = bamindex.build_index(
                args.input, max_record_bytes=cfg.max_record_bytes)
        except (OSError, bam_mod.BamError) as e:
            print(f"Error: --make-index failed: {e}", file=sys.stderr)
            return exitcodes.RC_FATAL
        print(f"[ccsx-tpu-torch] indexed {idx['n_holes']} holes / "
              f"{idx['n_records']} records -> "
              f"{args.input}{bamindex.INDEX_SUFFIX}", file=sys.stderr)
        return exitcodes.RC_OK
    if args.merge_shards is not None:
        from ccsx_tpu_torch.parallel.distributed import merge_shards

        try:
            n = merge_shards(args.output, args.merge_shards,
                             allow_unmarked=args.merge_unmarked)
        except (OSError, ValueError) as e:
            # incomplete or mixed-mode shards, unreadable files: an
            # expected refusal, rc 1 without a traceback
            print(f"Error: {e}", file=sys.stderr)
            return exitcodes.RC_FATAL
        print(f"[ccsx-tpu-torch] merged {n} records from "
              f"{args.merge_shards} shards", file=sys.stderr)
        return exitcodes.RC_OK
    if args.bam_out and args.fastq:
        print("Error: --fastq and --bam are mutually exclusive",
              file=sys.stderr)
        return exitcodes.RC_FATAL
    if args.bam_out and args.journal is not None:
        # the BGZF container is written whole at close, so a journal could
        # never be resumed — refused up front
        print("Error: --bam does not support --journal (the BAM "
              "container cannot be appended on resume)", file=sys.stderr)
        return exitcodes.RC_FATAL
    sharded = args.hosts is not None and args.hosts > 1
    if sharded:
        if args.host_id is None:
            print("Error: --hosts requires --host-id", file=sys.stderr)
            return exitcodes.RC_FATAL
        if args.bam_out:
            # shard files are text FASTA/FASTQ merged by merge_shards
            print("Error: --bam is not supported with --hosts "
                  "(use --fastq and convert the merged output)",
                  file=sys.stderr)
            return exitcodes.RC_FATAL
        if args.batch == "off":
            # the shard writer needs per-hole ordinals, which only the
            # batched driver gives
            print("Error: --batch off is not supported with --hosts",
                  file=sys.stderr)
            return exitcodes.RC_FATAL
    batch = args.batch
    if batch == "auto":
        batch = "on" if args.device == "cuda" else "off"
    if cfg.mesh_shape is not None and batch == "off" and not sharded:
        # (a sharded rank always runs the batched driver, mesh included)
        print("[ccsx-tpu-torch] --mesh has no effect with --batch off",
              file=sys.stderr)
    from ccsx_tpu_torch.pipeline.run import run_pipeline

    def _run():
        if sharded:
            from ccsx_tpu_torch.parallel import distributed

            if args.coordinator is not None:
                try:
                    distributed.init_distributed(
                        args.coordinator, args.hosts, args.host_id)
                except distributed.RendezvousError as e:
                    print(f"Error: --coordinator: {e}", file=sys.stderr)
                    return exitcodes.RC_FATAL
            try:
                return distributed.run_pipeline_sharded(
                    args.input, args.output, cfg, args.host_id, args.hosts,
                    journal_path=args.journal, inflight=args.inflight)
            finally:
                distributed.shutdown_distributed()
        return run_pipeline(args.input, args.output, cfg, batch=args.batch,
                            inflight=args.inflight,
                            journal_path=args.journal)

    if args.profile:
        # the counterpart of the JAX package's jax.profiler.trace(DIR)
        import torch
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(args.profile)):
            return _run()
    return _run()


if __name__ == "__main__":
    sys.exit(main())
