"""Resident consensus service: multi-tenant ``ccsx-tpu-torch serve`` (a copy
of the JAX package's pipeline/serve.py).

A CLI process pays its start-up — the torch import, the CUDA context, the
kernels' load — and captures its refine programs (pipeline/graphs.py) once
PER RUN, and throws the programs away at its exit; a lab submitting many
small jobs pays that once per JOB.  This module keeps one warm process
resident and runs every job through the same entry the CLI uses
(``run.run_pipeline``, batched, with the job's own Metrics and the server's
runtime), so a served job's output is byte-identical to the CLI run of the
same input by construction, while jobs 2..N replay the programs job 1
captured: the server's ``/progress`` carries the process's cumulative
program counts (``programs``: builds, eager dispatches, replays), and no
build after the first wave of a shape set is the steady-state criterion.

**Job API** (mounted on the telemetry HTTP stack, utils/telemetry.py —
one server, one port):

  POST   /jobs            submit: JSON {"input": path, ...overrides}
                          or a streamed BAM/FASTQ request body
                          (?format=bam|fastq|fasta); 201 {"id": ...},
                          429 + Retry-After at the queue-depth cap
  GET    /jobs            all jobs (id, state, rc, counters)
  GET    /jobs/<id>        one job's status and its own counters: the
                          run's, the port's step counters (slabs, ...),
                          and its kernel launches, eager refine
                          dispatches and graph replays, counted for that
                          job alone (ops/cuda_ext.scope)
  GET    /jobs/<id>/output stream the finished FASTA/FASTQ
  DELETE /jobs/<id>        cancel (running jobs drain via their guard)
  GET    /healthz          LIVENESS: 200 while the process serves
  GET    /readyz           READINESS: 503 {"ready": false, reason}
                          while warming, draining, at the queue cap, or
                          after a device fault ("device_fault")
  GET    /metrics          server Prometheus series + per-job
                          ccsx_job_*{job="..."} series
  GET    /progress         the server Metrics snapshot, with the
                          cumulative refine-program counts

**Per-job fault domains under shared capacity.**  Each job gets its own
journal, its own Metrics (labeled ``job=<id>``), its own failure budget
and corruption accounting, its own Resilience (pipeline/resilience.py,
built from the job's config in the batched driver: its
``dispatch_deadline_s`` and ``breaker_strikes`` overrides apply to it
alone, so a job whose device step hangs is degraded and replayed per
request without touching its siblings), its own drain guard
(utils/drain.FlagGuard — cancel, deadline and server drain all route
through the driver's rc-75 drain path) and its own fault-injection scope
(utils/faultinject.scope_arm).  What jobs SHARE is capacity: the
FairWindow below splits the device admission window (cfg.zmw_microbatch
slots) fairly, and the window-size invariance of the batched driver's
output is what makes fair sharing safe for byte identity.  A device OOM
stays in its job's resplit ladder (it drops every job's refine programs;
the other jobs rebuild theirs).

**Where the port differs.**  A fault of the card or of a kernel
(cuda_ext.is_device_fault) is sticky — it may leave the CUDA context
unusable for every job — so it STOPS the server: ``/readyz`` answers 503
``device_fault``, no further job starts, every running job drains (its
journal settles), the queue and the interrupted jobs persist to
``state.json``, and ``serve_main`` exits rc 1; restarting the same command
requeues and resumes every job byte-identically.  A fleet replica stops the
same way, handing its jobs' leases back to the survivors.

**Lifecycle.**  Transient failures (rc 1: ENOSPC, torn writes) retry with
exponential backoff up to --job-retries — the per-job journal makes a
retry resume, not recompute.  rc 2 (failure budget) and cancellation are
terminal.  --job-deadline bounds a job's wall clock across attempts.
SIGTERM drains the SERVER: stop accepting, drain running jobs (their
journals settle), persist the queue to <spool>/state.json, exit rc 75 —
restarting the same command requeues unfinished jobs and completes them
byte-identically.

**Fleet mode.**  ``serve --fleet <spool>`` makes this process one REPLICA
of a fleet sharing <spool> as a job LEASE DOMAIN (pipeline/gateway.py is
the spool protocol, utils/lease.py the machinery): a queued job is
acquired with the O_EXCL lease and heartbeat renewal, cross-replica
cancel and deadline marks are observed at each renewal tick, and the
terminal state commits through an EXCLUSIVE done marker — marker before
lease release, so a zombie replica that survived expiry can never
double-emit.  Replica death is requeue by construction: the lease
expires, the job's journal survives in the spool, and the next scanning
replica RESUMES it.  Jobs with at least --fanout-holes holes fan out
across replicas through the range queue (pipeline/fleet.py; helpers pull
ranges into their warm runtime).  Each replica claims slot ``r<k>`` and
serves on base_port + k, advertising the bound port in its slot
heartbeat; ``ccsx-tpu-torch gateway`` balances on the replicas'
``/readyz``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import socket
import sys
import threading
import time
from typing import Dict, List, Optional

from ccsx_tpu_torch import exitcodes
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.pipeline import gateway as spoolproto
from ccsx_tpu_torch.utils import faultinject
from ccsx_tpu_torch.utils import lease as leaselib
from ccsx_tpu_torch.utils.drain import FlagGuard
from ccsx_tpu_torch.utils.journal import write_json_atomic
from ccsx_tpu_torch.utils.metrics import Metrics, size_class
from ccsx_tpu_torch.utils.run_metrics import PORT_KEYS, RunMetrics

STATE_FILE = "state.json"
# terminal-for-this-process states ("interrupted" is resumable by a
# server restart, but this process will not touch the job again)
TERMINAL = ("done", "failed", "cancelled", "interrupted")
# job cfg overrides accepted from a submission, with their coercions —
# every one is journal-non-semantic (pipeline/journal _NON_SEMANTIC) or
# consumed before the journal fingerprint, so an override can never
# poison a resume
_CFG_OVERRIDES = {
    "salvage": ("salvage", lambda v: _truthy(v)),
    "max_failed_holes": ("max_failed_holes", float),
    "dispatch_deadline_s": ("dispatch_deadline_s", float),
    "breaker_strikes": ("breaker_strikes", int),
    "prep_threads": ("prep_threads", int),
}
# job-level (non-cfg) override keys
_JOB_OVERRIDES = ("format", "output", "deadline_s", "faults", "inflight")


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


class QueueFull(Exception):
    """Submission refused at the queue-depth cap (HTTP 429)."""


class Draining(Exception):
    """Submission refused because the server is draining (HTTP 503)."""


# ---- fair shared admission ------------------------------------------------

class FairWindow:
    """The device admission window as a shared resource: ``capacity``
    slots (cfg.zmw_microbatch — the same cap a solo run's window grows
    to) split fairly across registered jobs.

    Fairness rule: a job may always take a free slot UNLESS it already
    holds its fair share (ceil(capacity / registered jobs)) while some
    OTHER job is wanting (was denied and has not succeeded since) — a
    lone tenant gets the whole window, and a second tenant's first
    denial immediately caps the first at half.  Slots track holes that
    are admitted AND still computing (pipeline/batch.drive_batched
    releases on hole completion, before emission), so a job with an
    out-of-order emission tail is not charged for holes the device is
    done with.

    A stale "wanting" mark (a job denied once that then stopped
    asking) can cap siblings below the full window until that job
    releases to zero or unregisters — a bounded throughput nick, never
    a correctness issue: output bytes are invariant to window size
    (the pinned invariance that makes fair sharing safe at all)."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._cv = threading.Condition()
        self._held: Dict[str, int] = {}
        self._want: set = set()

    def register(self, jid: str) -> None:
        with self._cv:
            self._held.setdefault(jid, 0)
            self._cv.notify_all()

    def unregister(self, jid: str) -> None:
        with self._cv:
            self._held.pop(jid, None)
            self._want.discard(jid)
            self._cv.notify_all()

    def try_acquire(self, jid: str) -> bool:
        with self._cv:
            held = self._held.get(jid, 0)
            if sum(self._held.values()) >= self.capacity:
                self._want.add(jid)
                return False
            share = -(-self.capacity // max(1, len(self._held)))
            if held >= share and any(j != jid for j in self._want):
                self._want.add(jid)
                return False
            self._held[jid] = held + 1
            self._want.discard(jid)
            return True

    def release(self, jid: str) -> None:
        with self._cv:
            n = self._held.get(jid, 0)
            if n > 0:
                self._held[jid] = n - 1
            self._cv.notify_all()

    def release_all(self, jid: str) -> None:
        with self._cv:
            if self._held.get(jid):
                self._held[jid] = 0
            self._want.discard(jid)
            self._cv.notify_all()

    def wait(self, timeout: Optional[float]) -> None:
        with self._cv:
            self._cv.wait(timeout)

    def pressure(self) -> float:
        """Held fraction of the admission window [0, 1] — the per-
        replica autoscale gauge the slot lease advertises (a fleet
        whose replicas all sit near 1.0 wants more boxes)."""
        with self._cv:
            return round(sum(self._held.values())
                         / float(self.capacity), 4)


class JobAdmission:
    """One job's handle on the FairWindow — the duck-typed
    ``admission`` attribute drive_batched consumes (try_acquire /
    release / wait / reset)."""

    def __init__(self, window: FairWindow, jid: str):
        self._w = window
        self._jid = jid
        window.register(jid)

    def try_acquire(self) -> bool:
        return self._w.try_acquire(self._jid)

    def release(self) -> None:
        self._w.release(self._jid)

    def wait(self, timeout: Optional[float] = None) -> None:
        self._w.wait(timeout)

    def reset(self) -> None:
        self._w.release_all(self._jid)

    def close(self) -> None:
        self._w.unregister(self._jid)


class _JobRuntime:
    """The ``shared`` object handed to drive_batched: the server-owned
    pieces (warm, warm_cache) plus the job-owned ones (guard,
    admission)."""

    def __init__(self, warm, warm_cache, guard, admission):
        self.warm = warm
        self.warm_cache = warm_cache
        self.guard = guard
        self.admission = admission
        # a device fault the run met (run.run_pipeline leaves it here)
        self.fault = None


class ServeMetrics(RunMetrics):
    """The server's Metrics: every snapshot also carries the refine
    programs' cumulative counts for the process (``programs``, from
    pipeline/graphs.totals: builds, eager dispatches, replays, warm
    replays, and the shared pool's bytes on the card) — the port's
    counterpart of the JAX server's cumulative compile table, which
    ``/progress`` serves — and the process's kernel launches
    (``launches``, ops/cuda_ext.LAUNCHES)."""

    def snapshot(self) -> dict:
        from ccsx_tpu_torch.ops import cuda_ext
        from ccsx_tpu_torch.pipeline import graphs

        snap = super().snapshot()
        snap["programs"] = graphs.totals()
        snap["launches"] = dict(cuda_ext.LAUNCHES)
        return snap


# ---- jobs -----------------------------------------------------------------

class Job:
    def __init__(self, jid: str, in_path: str, out_path: str,
                 journal_path: str, cfg: CcsConfig,
                 overrides: Optional[dict] = None):
        self.id = jid
        self.in_path = in_path
        self.out_path = out_path
        self.journal_path = journal_path
        self.cfg = cfg
        self.raw_overrides = dict(overrides or {})
        self.state = "queued"
        self.rc: Optional[int] = None
        self.error: Optional[str] = None
        self.attempts = 0
        self.deadline_s = 0.0
        self.faults: Optional[str] = None
        self.inflight: Optional[int] = None
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.stop_reason: Optional[str] = None
        self.metrics: Optional[Metrics] = None
        self.snap: Optional[dict] = None
        self.guard: Optional[FlagGuard] = None
        self.thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()
        # fleet mode: the spool job lease this replica holds for the
        # job (utils/lease.py record), lost-lease flag, and the hole
        # count that triggered cross-replica fan-out (0 = solo)
        self.lease: Optional[dict] = None
        self.lease_lost = False
        self.fanout_holes_n = 0
        # the fleet-wide correlation id (minted at submission —
        # gateway.submit_job for spooled jobs, ServeCore.submit for
        # solo ones); every span/metrics event this job causes in any
        # process carries it
        self.cid: Optional[str] = None
        # this job's own kernel launches, eager refine dispatches and
        # graph replays (its cuda_ext.scope(), across its threads)
        self.counts: Optional[dict] = None

    def info(self) -> dict:
        snap = self.snap
        if snap is None and self.metrics is not None:
            snap = self.metrics.snapshot()
        d = {
            "id": self.id, "state": self.state, "rc": self.rc,
            "input": self.in_path, "output": self.out_path,
            "journal": self.journal_path, "error": self.error,
            "attempts": self.attempts, "stop_reason": self.stop_reason,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at,
            "cid": self.cid,
        }
        if snap:
            d["metrics"] = {k: snap.get(k) for k in (
                "holes_in", "holes_out", "holes_failed", "holes_corrupt",
                "holes_filtered", "device_hangs", "breaker_trips",
                "host_fallbacks", "zmws_per_sec", "elapsed_s",
                "degraded", "oom_resplits", *PORT_KEYS)}
        counts = self.counts
        if counts is not None:
            d.setdefault("metrics", {}).update(
                launches=dict(counts["launches"]),
                eager_dispatches=counts["eager_dispatches"],
                graph_replays=counts["graph_replays"])
        return d


class ServeCore:
    """The resident server: one warm runtime, N tenant jobs.

    Owns the process-global pieces exactly one owner may hold — the
    installed tracer (one group table across jobs, in ``self.metrics``,
    whose snapshot also carries the refine programs' cumulative counts),
    the server-lifetime WarmupCompiler (with ``--warmup``) and the
    FairWindow.  Jobs run on daemon threads (at most ``max_active``
    concurrently) through run.run_pipeline with a _JobRuntime.

    The HTTP layer (_ServeHandler) is a thin client of this object;
    tests drive ServeCore directly for the byte-identity and isolation
    cases and through HTTP for the API cases."""

    def __init__(self, cfg: CcsConfig, spool: str,
                 max_queue: int = 16, max_active: int = 2,
                 retries: int = 1, backoff_s: float = 0.5,
                 job_deadline_s: float = 0.0,
                 fleet: bool = False, replica: Optional[str] = None,
                 lease_timeout: float = 10.0, fanout_holes: int = 0,
                 fanout_ranges: int = 0, poll_s: float = 0.25):
        from ccsx_tpu_torch.utils import trace

        self.cfg = cfg
        self.spool = spool
        os.makedirs(spool, exist_ok=True)
        self.max_queue = max(1, int(max_queue))
        self.max_active = max(1, int(max_active))
        self.retries = max(0, int(retries))
        self.backoff_s = max(0.0, float(backoff_s))
        self.job_deadline_s = max(0.0, float(job_deadline_s))
        # fleet mode: the spool is a SHARED lease domain (pipeline/
        # gateway.py spool protocol) — jobs are leased, not owned, and
        # state.json is replaced by per-job records + markers
        self.fleet = bool(fleet)
        self.replica = replica or f"s{os.getpid()}"
        self.lease_timeout = max(0.2, float(lease_timeout))
        self.fanout_holes = max(0, int(fanout_holes))
        self.fanout_ranges = max(0, int(fanout_ranges))
        self.poll_s = max(0.05, float(poll_s))
        self.hostname = socket.gethostname()
        self.addr = os.environ.get("CCSX_ADVERTISE_HOST", "127.0.0.1")
        self.advertised_port = 0
        self._slot: Optional[int] = None
        self._slot_rec: Optional[dict] = None
        self._expiry_seq = 0
        self._helpers: Dict[str, threading.Thread] = {}
        self.metrics = ServeMetrics(verbose=0, stream=None)
        # set by the first device fault a job meets: the server stops
        self.device_fault: Optional[str] = None
        self._lock = threading.RLock()
        self._persist_lock = threading.Lock()
        self._jobs: Dict[str, Job] = {}
        self._queue: List[Job] = []
        self._seq = 0
        self._n_running = 0
        self.accepting = True
        self.draining = False
        self._completed_any = False
        self._closed = False
        # the server-lifetime warm plane (one capture worker across
        # jobs — WarmupCompiler dedupes on key; warm_cache is the JAX
        # package's inline-warm dedupe, unused by this package's driver)
        self.warm = None
        if getattr(cfg, "warmup_compile", True):
            from ccsx_tpu_torch.pipeline.warmup import WarmupCompiler

            self.warm = WarmupCompiler()
        self.warm_cache: set = set()
        self.window = FairWindow(int(getattr(cfg, "zmw_microbatch", 64)))
        # the server tracer: installed for the process lifetime, group
        # table in self.metrics.  A --trace path makes it a per-PROCESS
        # span JSONL (every job's spans, cid-stamped) — give each fleet
        # replica its own path and `ccsx-tpu-torch report --fleet
        # <spool>` stitches them into one timeline per job
        self._tracer = trace.Tracer(cfg.trace_path or None,
                                    stall_timeout=cfg.stall_timeout_s,
                                    metrics=self.metrics)
        trace.install(self._tracer)
        if not self.fleet:
            self._restore_state()
        self._mon_stop = threading.Event()
        self._mon = threading.Thread(target=self._monitor, daemon=True,
                                     name="ccsx-serve-monitor")
        self._mon.start()
        self._scan_stop = threading.Event()
        self._scan: Optional[threading.Thread] = None
        if self.fleet:
            self._scan = threading.Thread(target=self._spool_scan,
                                          daemon=True,
                                          name="ccsx-serve-spool")
            self._scan.start()
        self._pump()

    # ---- fleet plumbing ---------------------------------------------------

    def register_replica(self) -> int:
        """Claim a replica slot lease (``r<k>``) in the shared spool:
        the deterministic port assignment (serve on base_port + k) and
        the discovery record gateway/top scan.  The scan loop renews
        it with readiness + load refreshed each heartbeat."""
        slot, rec = spoolproto.acquire_replica_slot(
            self.spool, self.replica,
            extra={"addr": self.addr, "host": self.hostname,
                   "port": self.advertised_port,
                   "replica": self.replica},
            lease_timeout=self.lease_timeout)
        self._slot, self._slot_rec = slot, rec
        return slot

    def set_advertised(self, port: int,
                       addr: Optional[str] = None) -> None:
        self.advertised_port = int(port)
        if addr:
            self.addr = addr

    # ---- submission -------------------------------------------------------

    def submit(self, input_path: Optional[str] = None,
               body_stream=None, body_len: int = 0,
               overrides: Optional[dict] = None):
        overrides = dict(overrides or {})
        unknown = [k for k in overrides
                   if k not in _CFG_OVERRIDES and k not in _JOB_OVERRIDES]
        if unknown:
            raise ValueError(f"unknown job option(s): {unknown}")
        if self.fleet:
            return self._submit_fleet(input_path, body_stream,
                                      body_len, overrides)
        with self._lock:
            if not self.accepting:
                raise Draining("server is draining")
            queued = sum(1 for j in self._jobs.values()
                         if j.state == "queued")
            if queued >= self.max_queue:
                raise QueueFull(
                    f"job queue full ({queued}/{self.max_queue})")
            self._seq += 1
            jid = f"j{self._seq:04d}"
        fmt = str(overrides.get("format") or "").lower()
        if fmt and fmt not in ("bam", "fastq", "fasta"):
            raise ValueError(f"unknown input format {fmt!r}")
        if body_stream is not None:
            # streamed submission: spool the body before the job exists
            # (a torn upload must not leave a half-readable queued job)
            suffix = fmt or "bam"
            input_path = os.path.join(self.spool, f"{jid}.input.{suffix}")
            with open(input_path, "wb") as f:
                left = int(body_len)
                while left > 0:
                    chunk = body_stream.read(min(left, 1 << 16))
                    if not chunk:
                        raise ValueError("short request body")
                    f.write(chunk)
                    left -= len(chunk)
        if not input_path:
            raise ValueError("job needs an input path or a request body")
        job = self._build_job(jid, input_path, overrides)
        # solo jobs never pass through the gateway: mint their
        # correlation id here, at the same point in the lifecycle
        job.cid = f"c{os.urandom(6).hex()}"
        with self._lock:
            self._jobs[jid] = job
            self._queue.append(job)
        self._persist()
        self._pump()
        return job

    def _submit_fleet(self, input_path, body_stream, body_len,
                      overrides):
        """Fleet-mode submit: write the job into the SHARED spool (the
        spool is the queue — any replica, this one included, may lease
        it) and return a lightweight queued handle.  Validation
        matches solo submit; capacity is the fleet-wide spool depth,
        not a local queue."""
        fmt = str(overrides.get("format") or "").lower()
        if fmt and fmt not in ("bam", "fastq", "fasta"):
            raise ValueError(f"unknown input format {fmt!r}")
        with self._lock:
            if not self.accepting:
                raise Draining("server is draining")
        counts = spoolproto.spool_counts(self.spool)
        depth = counts["queued"] + counts["cancelling"]
        if depth >= self.max_queue:
            raise QueueFull(
                f"fleet spool full ({depth}/{self.max_queue})")
        # overrides are validated here but coerced by whichever
        # replica acquires the job (_build_job) — fail fast on the
        # obviously bad ones so the submitter gets the 400, not a
        # failed job
        self._build_job("probe", input_path or "unspooled", overrides)
        jid = spoolproto.submit_job(self.spool, input_path=input_path,
                                    body_stream=body_stream,
                                    body_len=body_len,
                                    overrides=overrides)
        class _Handle:
            pass

        h = _Handle()
        h.id, h.state = jid, "queued"
        return h

    def _build_job(self, jid: str, input_path: str,
                   overrides: dict) -> Job:
        cfg_kw = {}
        for key, (field, coerce) in _CFG_OVERRIDES.items():
            if key in overrides and overrides[key] is not None:
                try:
                    cfg_kw[field] = coerce(overrides[key])
                except (TypeError, ValueError):
                    raise ValueError(f"bad value for {key!r}: "
                                     f"{overrides[key]!r}")
        fmt = str(overrides.get("format") or "").lower()
        if fmt:
            cfg_kw["is_bam"] = fmt == "bam"
        # the job must not fight the server for process-global planes:
        # no second telemetry server, no second metrics stream, no
        # per-job trace file (the server tracer records every job)
        cfg = dataclasses.replace(self.cfg, telemetry_port=0,
                                  metrics_path=None, trace_path=None,
                                  **cfg_kw)
        out = str(overrides.get("output") or
                  os.path.join(self.spool, f"{jid}.out.fasta"))
        job = Job(jid, input_path, out,
                  os.path.join(self.spool, f"{jid}.journal"), cfg,
                  overrides=overrides)
        job.deadline_s = float(overrides.get("deadline_s")
                               or self.job_deadline_s or 0.0)
        job.faults = overrides.get("faults") or None
        if overrides.get("inflight") is not None:
            job.inflight = int(overrides["inflight"])
        return job

    # ---- scheduling -------------------------------------------------------

    def _pump(self) -> None:
        with self._lock:
            if self.draining:
                return
            while self._n_running < self.max_active and self._queue:
                job = self._queue.pop(0)
                if job.state != "queued":
                    continue
                job.state = "running"
                if job.started_at is None:
                    job.started_at = time.time()
                    self.metrics.observe(
                        "queue_wait_s",
                        max(0.0, job.started_at - job.submitted_at),
                        size_class(job.fanout_holes_n))
                self._n_running += 1
                t = threading.Thread(target=self._job_main, args=(job,),
                                     daemon=True,
                                     name=f"ccsx-job-{job.id}")
                job.thread = t
                t.start()

    def _job_main(self, job: Job) -> None:
        from ccsx_tpu_torch.ops import cuda_ext
        from ccsx_tpu_torch.utils import blackbox, trace

        stop: Optional[threading.Event] = None
        try:
            if self.fleet and job.lease is not None:
                stop = threading.Event()
                t = threading.Thread(target=self._job_renewer,
                                     args=(job, stop), daemon=True,
                                     name=f"ccsx-renew-{job.id}")
                t.start()
            # every span/metrics record the job causes carries its
            # correlation id; the black-box inflight/done pair is what
            # names this job in a SIGKILLed replica's dump; its launches
            # and refine dispatches count into its own scope
            with trace.cid_scope(job.cid), \
                    cuda_ext.scope() as job.counts:
                blackbox.note("inflight", what="job", id=job.id,
                              **({"cid": job.cid} if job.cid else {}))
                err = True
                try:
                    self._run_job(job)
                    err = False
                finally:
                    # pair the note even when _run_job raises: only a
                    # genuine process death may leave the job open in
                    # a live replica's ring
                    blackbox.note("done", what="job", id=job.id,
                                  **({"error": True} if err else {}))
        finally:
            if stop is not None:
                stop.set()
            with self._lock:
                self._n_running -= 1
            self._persist()
            self._pump()

    # ---- the fleet scan loop ----------------------------------------------

    def _fleet_capacity(self) -> int:
        with self._lock:
            active = sum(1 for j in self._jobs.values()
                         if j.state in ("queued", "running"))
        active += sum(1 for t in self._helpers.values()
                      if t.is_alive())
        return self.max_active - active

    def _spool_scan(self) -> None:
        while not self._scan_stop.wait(self.poll_s):
            try:
                self._scan_once()
            except Exception as e:  # the scan loop must survive churn
                print(f"[ccsx-tpu-torch] serve: spool scan error: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)

    def _scan_once(self) -> None:
        self._renew_slot()
        jids = spoolproto.list_job_ids(self.spool)
        for jid in jids:
            if os.path.exists(
                    spoolproto.done_marker_path(self.spool, jid)):
                continue
            rec = spoolproto.read_job_record(self.spool, jid) or {}
            hold = leaselib.read_lease(self.spool, jid)
            if hold is not None:
                if (hold and hold.get("pid") == os.getpid()
                        and hold.get("worker") == self.replica):
                    continue  # ours: its renewer observes the record
                # stale foreign holder: KILL-BEFORE-STEAL, but only
                # when the lease names OUR host — a pid from another
                # box must never be shot here
                self._expiry_seq += 1
                kill = (hold or {}).get("host") in (None, self.hostname)
                evicted = leaselib.expire_lease(
                    self.spool, jid, self.lease_timeout, kill=kill,
                    seq=self._expiry_seq)
                if evicted is not None:
                    print(f"[ccsx-tpu-torch] serve: {self.replica} requeued "
                          f"job {jid} from "
                          f"{evicted.get('worker') or 'unknown'} "
                          "(lease expired)", file=sys.stderr)
                continue
            if rec.get("cancel"):
                # cancelled while queued: any replica may retire it
                # (the exclusive marker arbitrates racers)
                if spoolproto.retire_job(self.spool, jid, "cancelled",
                                         exitcodes.RC_INTERRUPTED,
                                         self.replica):
                    print(f"[ccsx-tpu-torch] serve: {self.replica} retired "
                          f"cancelled queued job {jid}",
                          file=sys.stderr)
                continue
            with self._lock:
                accepting = self.accepting and not self.draining
            if not accepting or self._fleet_capacity() <= 0:
                continue
            lease_rec = leaselib.try_acquire(
                self.spool, jid, self.replica,
                extra={"replica": self.replica, "host": self.hostname,
                       "addr": self.addr,
                       "port": self.advertised_port,
                       "cid": rec.get("cid")},
                kind="job")
            if lease_rec is not None:
                self._admit_fleet_job(jid, rec, lease_rec)
        if self._fleet_capacity() > 0:
            self._maybe_help_fanout(jids)

    def _renew_slot(self) -> None:
        if self._slot_rec is None:
            return
        ready, reason = self.readiness()
        with self._lock:
            held = sum(1 for j in self._jobs.values()
                       if j.state in ("queued", "running"))
        ok = leaselib.renew(
            self.spool, f"{spoolproto.SLOT_PREFIX}{self._slot}",
            self._slot_rec,
            extra={"addr": self.addr, "host": self.hostname,
                   "port": self.advertised_port,
                   "replica": self.replica, "ready": ready,
                   "reason": reason,
                   "pressure": self.window.pressure(),
                   "leases": held})
        if not ok:
            # evicted as presumed dead: re-register rather than serve
            # undiscoverable (the bound port stays valid; the fresh
            # slot record advertises it)
            try:
                self.register_replica()
                self._renew_slot()
            except RuntimeError as e:
                print(f"[ccsx-tpu-torch] serve: {self.replica} lost its "
                      f"slot and could not re-register: {e}",
                      file=sys.stderr)
                self._slot_rec = None

    def _admit_fleet_job(self, jid: str, rec: dict,
                         lease_rec: dict) -> None:
        try:
            job = self._build_job(jid, rec.get("input") or "",
                                  rec.get("overrides") or {})
        except ValueError as e:
            spoolproto.retire_job(self.spool, jid, "failed", 1,
                                  self.replica, error=str(e))
            leaselib.release(self.spool, jid, lease_rec)
            return
        job.lease = lease_rec
        job.cid = rec.get("cid")
        try:
            # queue-wait must measure from SUBMISSION, not from this
            # replica's admit tick
            job.submitted_at = float(rec["submitted_at"])
        except (KeyError, TypeError, ValueError):
            pass
        if self.fanout_holes > 0:
            try:
                from ccsx_tpu_torch.pipeline.run import count_raw_holes

                n = count_raw_holes(job.in_path, job.cfg)
            except (OSError, RuntimeError, ValueError):
                n = 0
            if n >= self.fanout_holes:
                job.fanout_holes_n = n
        with self._lock:
            self._jobs[jid] = job
            self._queue.append(job)
        self._pump()

    def _job_renewer(self, job: Job, stop: threading.Event) -> None:
        """Heartbeat-renew the job lease; every renewal also OBSERVES
        the spool record — the cross-replica control channel: a cancel
        (or tightened deadline) marked at the gateway lands here and
        aborts through the job's own guard (its drain path, nothing
        else touched).  A failed renewal means we were expired as presumed
        dead: stop emitting (the exclusive done marker stays the last
        fence against a zombie double-commit)."""
        interval = max(0.05, self.lease_timeout / 3.0)
        while not stop.wait(interval):
            rec = spoolproto.read_job_record(self.spool, job.id) or {}
            if rec.get("cancel"):
                with self._lock:
                    if job.state == "running" and not job.stop_reason:
                        self._signal_locked(job, "cancel")
            dl = (rec.get("overrides") or {}).get("deadline_s")
            if dl is not None:
                try:
                    job.deadline_s = float(dl)
                except (TypeError, ValueError):
                    pass
            if not leaselib.renew(self.spool, job.id, job.lease):
                job.lease_lost = True
                with self._lock:
                    if not job.stop_reason:
                        self._signal_locked(job, "drain")
                return

    # ---- cross-replica fan-out --------------------------------------------

    def _fanout_dir(self, jid: str) -> str:
        return os.path.join(self.spool, f"fanout.{jid}")

    def _run_fanout(self, job: Job) -> None:
        """Run one big job through the range queue (pipeline/fleet.py)
        INSIDE the spool: the holder splits the input into M leased ranges
        (fleet.init_fleet — re-opening after a holder death RESUMES
        the same table, so a mid-fan-out kill costs ~one range), pulls
        ranges alongside any helping sibling replicas, and merges
        under the range-table fence.  Ranges run with the replica's
        warm runtime (shared=) so fan-out rebuilds no refine program."""
        from ccsx_tpu_torch.parallel import distributed
        from ccsx_tpu_torch.pipeline import fleet

        guard = FlagGuard()
        with self._lock:
            job.attempts += 1
            job.guard = guard
            if job.stop_reason:
                guard.request(job.stop_reason)
        n = job.fanout_holes_n
        m = self.fanout_ranges or min(n, max(2, 2 * self.max_active))
        d = self._fanout_dir(job.id)
        metrics = Metrics(verbose=0, stream=None)
        metrics.job = job.id
        metrics.cid = job.cid
        job.metrics = metrics
        try:
            state = fleet.init_fleet(d, job.in_path, job.out_path, n,
                                     m, self.lease_timeout,
                                     cid=job.cid)
        except (OSError, ValueError) as e:
            job.error = f"fan-out init failed: {e}"
            self._finish(job, "failed", 1)
            return
        rec = spoolproto.read_job_record(self.spool, job.id) or {}
        if rec.get("fanout") != m:
            # advertise the fan-out so sibling replicas pull ranges
            rec["fanout"] = m
            write_json_atomic(
                spoolproto.job_record_path(self.spool, job.id), rec)
        adm = JobAdmission(self.window, job.id)
        rt = _JobRuntime(self.warm, self.warm_cache, guard, adm)
        renew_s = max(0.05, self.lease_timeout / 3.0)
        rc = 0
        try:
            while True:
                if guard.requested:
                    rc = exitcodes.RC_INTERRUPTED
                    break
                progressed = pending = False
                for i in range(m):
                    if guard.requested:
                        break
                    if os.path.exists(
                            distributed.done_path(job.out_path, i)):
                        continue
                    pending = True
                    lr = fleet.try_acquire(d, i, self.replica,
                                           cid=job.cid)
                    if lr is None:
                        # a helper (or a dead helper) holds it: expiry
                        # keeps a killed sibling from pinning a range
                        self._expiry_seq += 1
                        fleet.expire_lease(d, i, self.lease_timeout,
                                           seq=self._expiry_seq)
                        continue
                    stop = threading.Event()
                    t = threading.Thread(
                        target=fleet._renewer,
                        args=(d, i, lr, renew_s, stop), daemon=True)
                    t.start()
                    try:
                        rrc = fleet.run_range(d, state, job.cfg, i,
                                              self.replica,
                                              inflight=job.inflight,
                                              shared=rt)
                    finally:
                        stop.set()
                        t.join(timeout=1.0)
                    fleet.release(d, i, lr)
                    if rrc != 0:
                        rc = rrc
                        break
                    progressed = True
                if rc:
                    break
                if not pending:
                    break
                if not progressed:
                    time.sleep(0.2)  # helpers hold the remaining ranges
            if rc == 0:
                try:
                    distributed.merge_shards(
                        job.out_path, m, expect_table=state["table"])
                except (OSError, ValueError) as e:
                    job.error = f"fan-out merge failed: {e}"
                    rc = 1
        finally:
            adm.close()
            job.snap = metrics.snapshot()
        if rt.fault is not None:
            self._device_stop(job, rt.fault)
            return
        if rc == 0:
            self._finish(job, "done", exitcodes.RC_OK)
            shutil.rmtree(d, ignore_errors=True)
        elif rc == exitcodes.RC_INTERRUPTED:
            reason = job.stop_reason or guard.reason or "drain"
            if reason == "cancel":
                self._finish(job, "cancelled", rc)
            elif reason == "deadline":
                job.error = (f"job deadline "
                             f"({job.deadline_s:g}s) exceeded")
                self._finish(job, "failed", rc)
            else:
                self._finish(job, "interrupted", rc)
        elif rc == exitcodes.RC_FAILED_HOLES:
            job.error = job.error or "failure budget exceeded"
            self._finish(job, "failed", rc)
        else:
            job.error = job.error or f"rc {rc}"
            self._finish(job, "failed", rc)

    def _maybe_help_fanout(self, jids: List[str]) -> None:
        """Idle capacity pulls ranges of ANOTHER replica's fan-out job
        — the cross-replica half of the fan-out story.  At most one
        new helper per scan tick keeps admission fair."""
        for jid in jids:
            if os.path.exists(
                    spoolproto.done_marker_path(self.spool, jid)):
                continue
            rec = spoolproto.read_job_record(self.spool, jid) or {}
            if not rec.get("fanout") or rec.get("cancel"):
                continue
            hold = leaselib.read_lease(self.spool, jid)
            if not hold or hold.get("pid") == os.getpid():
                continue
            t = self._helpers.get(jid)
            if t is not None and t.is_alive():
                continue
            t = threading.Thread(target=self._help_fanout, args=(jid,),
                                 daemon=True, name=f"ccsx-help-{jid}")
            self._helpers[jid] = t
            t.start()
            return

    def _help_fanout(self, jid: str) -> None:
        from ccsx_tpu_torch.parallel import distributed
        from ccsx_tpu_torch.pipeline import fleet

        d = self._fanout_dir(jid)
        state = fleet.load_fleet(d)
        if state is None:
            return
        m = len(state["ranges"])
        rec = spoolproto.read_job_record(self.spool, jid) or {}
        try:
            # the record's overrides rebuild the HOLDER's exact cfg —
            # identical fingerprint, so helper shards interleave with
            # holder shards under one table
            job = self._build_job(jid, rec.get("input")
                                  or state["input"],
                                  rec.get("overrides") or {})
        except ValueError:
            return
        guard = FlagGuard()
        adm = JobAdmission(self.window, f"{jid}/help")
        rt = _JobRuntime(self.warm, self.warm_cache, guard, adm)
        renew_s = max(0.05, self.lease_timeout / 3.0)
        try:
            while True:
                with self._lock:
                    if self.draining:
                        return
                cur = spoolproto.read_job_record(self.spool, jid) or {}
                if (cur.get("cancel") or os.path.exists(
                        spoolproto.done_marker_path(self.spool, jid))):
                    return
                got = False
                for i in range(m):
                    if os.path.exists(
                            distributed.done_path(state["output"], i)):
                        continue
                    try:
                        lr = fleet.try_acquire(d, i, self.replica,
                                               cid=state.get("cid"))
                    except FileNotFoundError:
                        return  # holder merged and cleaned up: done
                    if lr is None:
                        continue
                    stop = threading.Event()
                    t = threading.Thread(
                        target=fleet._renewer,
                        args=(d, i, lr, renew_s, stop), daemon=True)
                    t.start()
                    try:
                        rrc = fleet.run_range(d, state, job.cfg, i,
                                              self.replica,
                                              inflight=job.inflight,
                                              shared=rt)
                    finally:
                        stop.set()
                        t.join(timeout=1.0)
                    fleet.release(d, i, lr)
                    if rrc != 0:
                        if rt.fault is not None:
                            self._device_stop(None, rt.fault)
                        return  # recovery belongs to the holder
                    got = True
                    break  # recheck cancel/drain between ranges
                if not got:
                    return  # nothing free: the holder is finishing
        finally:
            adm.close()

    def _run_job(self, job: Job) -> None:
        from ccsx_tpu_torch.ops import cuda_ext
        from ccsx_tpu_torch.pipeline.run import run_pipeline

        if self.fleet and job.fanout_holes_n:
            self._run_fanout(job)
            return
        while True:
            guard = FlagGuard()
            with self._lock:
                job.attempts += 1
                job.guard = guard
                if job.stop_reason:
                    # a cancel/drain that raced the attempt start
                    guard.request(job.stop_reason)
            # the job's fault domain: its own spec (or an EMPTY scope —
            # even a faultless job must be isolated from any
            # server-level global plan)
            token = faultinject.scope_arm(job.faults)
            metrics = RunMetrics(verbose=0, stream=None)
            metrics.job = job.id
            metrics.cid = job.cid
            job.metrics = metrics
            adm = JobAdmission(self.window, job.id)
            rt = _JobRuntime(self.warm, self.warm_cache, guard, adm)
            rc: Optional[int] = None
            try:
                rc = run_pipeline(
                    job.in_path, job.out_path, job.cfg, batch="on",
                    journal_path=job.journal_path,
                    inflight=job.inflight, metrics=metrics, shared=rt)
            except SystemExit as e:  # argparse-style refusals downstream
                rc = int(e.code or 0) or 1
            except BaseException as e:
                job.error = f"{type(e).__name__}: {e}"
                if cuda_ext.is_device_fault(e):
                    rt.fault = e
            finally:
                adm.close()
                faultinject.scope_reset(token)
                job.snap = metrics.snapshot()
            if rt.fault is not None:
                # sticky for every job: no retry, the server stops
                self._device_stop(job, rt.fault)
                return
            if rc == exitcodes.RC_OK:
                self._finish(job, "done", rc)
                return
            if rc == exitcodes.RC_INTERRUPTED:
                reason = job.stop_reason or guard.reason or "drain"
                if reason == "cancel":
                    self._finish(job, "cancelled", rc)
                elif reason == "deadline":
                    job.error = (f"job deadline "
                                 f"({job.deadline_s:g}s) exceeded")
                    self._finish(job, "failed", rc)
                else:
                    # server drain: journal settled, resumable by the
                    # next server process
                    self._finish(job, "interrupted", rc)
                return
            if rc == exitcodes.RC_FAILED_HOLES:
                job.error = job.error or "failure budget exceeded"
                self._finish(job, "failed", rc)
                return
            # rc 1 / unexpected exception: the transient class (ENOSPC,
            # torn write, wedged backend refusal).  The journal makes a
            # retry a RESUME — completed holes are not recomputed and
            # the final bytes stay identical — so bounded
            # retry-and-backoff is cheap and safe.
            if job.attempts > self.retries or job.stop_reason:
                job.error = job.error or f"rc {rc}"
                self._finish(job, "failed",
                             rc if rc is not None else 1)
                return
            delay = self.backoff_s * (2 ** (job.attempts - 1))
            print(f"[ccsx-tpu-torch] serve: job {job.id} attempt "
                  f"{job.attempts} failed ({job.error or f'rc {rc}'}); "
                  f"retrying in {delay:g}s", file=sys.stderr)
            job.error = None
            if job._stop_ev.wait(delay):
                reason = job.stop_reason or "cancel"
                if reason == "cancel":
                    self._finish(job, "cancelled",
                                 exitcodes.RC_INTERRUPTED)
                elif reason == "drain":
                    self._finish(job, "interrupted",
                                 exitcodes.RC_INTERRUPTED)
                else:
                    job.error = (f"job deadline "
                                 f"({job.deadline_s:g}s) exceeded")
                    self._finish(job, "failed",
                                 exitcodes.RC_INTERRUPTED)
                return

    def _finish(self, job: Job, state: str, rc: Optional[int]) -> None:
        with self._lock:
            job.state = state
            job.rc = rc
            job.finished_at = time.time()
            if state == "done":
                self._completed_any = True
            wall = (job.finished_at - job.started_at
                    if job.started_at is not None else None)
        if wall is not None:
            self.metrics.observe("job_wall_s", max(0.0, wall),
                                 size_class(job.fanout_holes_n))
        if job.snap and job.snap.get("hist"):
            # fold the job's fault-domain observations (first dispatch
            # etc.) into the server-lifetime families /metrics serves
            self.metrics.merge_hists(job.snap["hist"])
        if self.fleet and job.lease is not None:
            self._retire_fleet_job(job, state, rc)

    def _retire_fleet_job(self, job: Job, state: str,
                          rc: Optional[int]) -> None:
        """Commit the terminal state to the spool (marker BEFORE lease
        release — the same crash-window ordering as range retirement:
        a kill between the two leaves a done job with a releasable
        lease, never a lost one).  'interrupted' writes NO marker: the
        journal is durable and a survivor resumes the job."""
        if state in spoolproto.MARKER_STATES:
            committed = spoolproto.retire_job(
                self.spool, job.id, state, rc, self.replica,
                error=job.error, output=job.out_path,
                attempts=job.attempts)
            if not committed:
                # the exclusive fence lost: a survivor already retired
                # this job while we were presumed dead — its marker
                # vouches, ours must not
                print(f"[ccsx-tpu-torch] serve: job {job.id} was already "
                      "retired by another replica; yielding to its "
                      "marker", file=sys.stderr)
                with self._lock:
                    job.state = "interrupted"
        leaselib.release(self.spool, job.id, job.lease)

    # ---- control plane ----------------------------------------------------

    def _signal_locked(self, job: Job, reason: str) -> None:
        if not job.stop_reason:
            job.stop_reason = reason
        job._stop_ev.set()
        if job.guard is not None:
            job.guard.request(reason)

    def _device_stop(self, job: Optional[Job], exc: BaseException) -> None:
        """A fault of the card or of a kernel met by ``job`` (None: a
        fan-out helper's range): the CUDA context may be unusable for every
        job, so the server stops taking work.  ``/readyz`` turns 503
        ``device_fault``, no further job starts, every other running job is
        drained (its journal settles), and the faulted job ends
        ``interrupted`` with rc 1 — resumable, as a drained job is (a
        replica hands its lease back).  The queue persists; serve_main
        exits rc 1 once the drain is done."""
        with self._lock:
            first = self.device_fault is None
            if first:
                self.device_fault = f"{type(exc).__name__}: {exc}"
            self.accepting = False
            self.draining = True
            for other in self._jobs.values():
                if other is not job and other.state == "running":
                    self._signal_locked(other, "drain")
        if first:
            print(f"[ccsx-tpu-torch] serve: device fault"
                  f"{f' in job {job.id}' if job is not None else ''}: "
                  f"{exc}; no further job starts, running jobs drain",
                  file=sys.stderr)
        if job is not None:
            job.error = f"device fault: {exc}"
            self._finish(job, "interrupted", exitcodes.RC_FATAL)
        self._persist()

    def cancel(self, jid: str):
        """-> (state, changed).  KeyError for an unknown id.  In fleet
        mode a job this replica does NOT hold is cancelled by marking
        the shared spool record — the holder's next heartbeat renewal
        observes the mark and aborts (the cross-replica cancel path
        the gateway uses too)."""
        with self._lock:
            job = self._jobs.get(jid)
            if job is None:
                pass  # fall through to the spool mark below
            elif job.state in TERMINAL:
                return job.state, False
            elif job.state == "queued":
                if job in self._queue:
                    self._queue.remove(job)
                job.state = "cancelled"
                job.rc = exitcodes.RC_INTERRUPTED
                job.finished_at = time.time()
            else:
                self._signal_locked(job, "cancel")
        if job is None:
            if self.fleet:
                return spoolproto.mark_cancel(self.spool, jid)
            raise KeyError(jid)
        if job.state == "cancelled" and self.fleet and job.lease:
            # cancelled before its thread started: retire + release
            # here — no _run_job will do it for us
            self._retire_fleet_job(job, "cancelled", job.rc)
        self._persist()
        return job.state, True

    def _monitor(self) -> None:
        # the deadline tick: --job-deadline (or a per-job deadline_s)
        # bounds wall clock across attempts; exceeding it drains the
        # job through its guard (journal settles — the operator can
        # resubmit with a bigger deadline and it RESUMES)
        while not self._mon_stop.wait(0.2):
            now = time.time()
            with self._lock:
                for job in self._jobs.values():
                    if (job.state == "running" and job.deadline_s > 0
                            and job.started_at is not None
                            and now - job.started_at > job.deadline_s
                            and job.stop_reason is None):
                        self._signal_locked(job, "deadline")

    def drain(self, timeout: float = 600.0) -> int:
        """SIGTERM semantics: stop accepting, drain running jobs
        (their journals settle), persist the queue, report the exit
        rc — 75 (resumable) when unfinished jobs remain, else 0."""
        with self._lock:
            self.accepting = False
            self.draining = True
            running = [j for j in self._jobs.values()
                       if j.state == "running"]
            queued_leased = [j for j in self._jobs.values()
                             if j.state == "queued"
                             and j.lease is not None]
            for job in running:
                self._signal_locked(job, "drain")
            for job in queued_leased:
                # acquired but never started: hand the lease straight
                # back so a survivor picks the job up NOW, not after a
                # timeout
                job.state = "interrupted"
                job.rc = exitcodes.RC_INTERRUPTED
                job.finished_at = time.time()
        if self.fleet:
            self._scan_stop.set()
        for job in queued_leased:
            leaselib.release(self.spool, job.id, job.lease)
        deadline = time.monotonic() + max(0.0, timeout)
        for job in running:
            t = job.thread
            if t is not None:
                t.join(max(0.1, deadline - time.monotonic()))
        for t in list(self._helpers.values()):
            t.join(max(0.1, deadline - time.monotonic()))
        if self._slot_rec is not None:
            leaselib.release(self.spool,
                             f"{spoolproto.SLOT_PREFIX}{self._slot}",
                             self._slot_rec)
            self._slot_rec = None
        self._persist()
        with self._lock:
            resumable = any(j.state in ("queued", "running",
                                        "interrupted")
                            for j in self._jobs.values())
        return exitcodes.RC_INTERRUPTED if resumable else exitcodes.RC_OK

    def close(self) -> None:
        from ccsx_tpu_torch.utils import trace

        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._mon_stop.set()
        self._scan_stop.set()
        self._mon.join(timeout=5.0)
        if self._scan is not None:
            self._scan.join(timeout=5.0)
        if self.warm is not None:
            self.warm.close()
        trace.uninstall()
        self._tracer.close()

    # ---- introspection ----------------------------------------------------

    def job(self, jid: str) -> Optional[Job]:
        with self._lock:
            return self._jobs.get(jid)

    def jobs(self) -> List[dict]:
        with self._lock:
            items = list(self._jobs.values())
        return [j.info() for j in items]

    def job_snapshots(self) -> Dict[str, dict]:
        """job id -> Metrics snapshot, for the ccsx_job_* series."""
        with self._lock:
            items = list(self._jobs.items())
        out = {}
        for jid, job in items:
            snap = job.snap
            if snap is None and job.metrics is not None:
                snap = job.metrics.snapshot()
            if snap:
                out[jid] = snap
        return out

    def counts(self) -> dict:
        with self._lock:
            c = {"jobs": len(self._jobs), "running": self._n_running,
                 "queued": sum(1 for j in self._jobs.values()
                               if j.state == "queued")}
        return c

    def wait(self, jid: str, timeout: float = 120.0) -> str:
        """Block until the job reaches a terminal state (tests).  In
        fleet mode a job not held locally is waited on through the
        spool view — it may be running on ANY replica."""
        deadline = time.monotonic() + timeout
        state = None
        while time.monotonic() < deadline:
            job = self.job(jid)
            if job is not None:
                state = job.state
                if state in TERMINAL:
                    return state
            elif self.fleet:
                view = spoolproto.job_view(self.spool, jid)
                if view is None:
                    raise KeyError(jid)
                state = view["state"]
                if state in spoolproto.MARKER_STATES:
                    return state
            else:
                raise KeyError(jid)
            time.sleep(0.02)
        return state

    def readiness(self):
        """The /readyz hook: (ready, reason).  NOT tied to a job's
        degraded mark; a device fault (``device_fault``) stops the
        server for good."""
        with self._lock:
            if self.device_fault is not None:
                return False, "device_fault"
            if self.draining:
                return False, "draining"
            queued = sum(1 for j in self._jobs.values()
                         if j.state == "queued")
            if queued >= self.max_queue:
                return False, "queue full"
            cold = not self._completed_any
        if cold and self.warm is not None and self.warm.busy():
            return False, "warming"
        return True, "ok"

    # ---- restart persistence ----------------------------------------------

    def _persist(self) -> None:
        if self.fleet:
            # fleet mode has no state.json: the spool records, leases
            # and markers ARE the durable state, shared by all replicas
            return
        with self._lock:
            recs = []
            for j in self._jobs.values():
                recs.append({
                    "id": j.id, "state": j.state, "rc": j.rc,
                    "input": j.in_path, "output": j.out_path,
                    "journal": j.journal_path, "error": j.error,
                    "attempts": j.attempts,
                    "overrides": j.raw_overrides,
                    "submitted_at": j.submitted_at,
                    "finished_at": j.finished_at,
                })
            state = {"version": 1, "seq": self._seq, "jobs": recs}
        try:
            # serialized: concurrent job threads persisting at once
            # would race on the same .tmp sidecar
            with self._persist_lock:
                write_json_atomic(os.path.join(self.spool, STATE_FILE),
                                  state)
        except OSError as e:
            print(f"[ccsx-tpu-torch] serve: state persist failed: {e}",
                  file=sys.stderr)

    def _restore_state(self) -> None:
        path = os.path.join(self.spool, STATE_FILE)
        try:
            with open(path, encoding="utf-8") as f:
                state = json.load(f)
        except (OSError, ValueError):
            return
        self._seq = int(state.get("seq") or 0)
        for rec in state.get("jobs") or []:
            try:
                job = self._build_job(rec["id"], rec["input"],
                                      rec.get("overrides") or {})
            except (KeyError, ValueError):
                continue
            job.out_path = rec.get("output") or job.out_path
            job.journal_path = rec.get("journal") or job.journal_path
            job.rc = rec.get("rc")
            job.error = rec.get("error")
            job.attempts = int(rec.get("attempts") or 0)
            job.submitted_at = rec.get("submitted_at") or time.time()
            job.finished_at = rec.get("finished_at")
            prev = rec.get("state")
            if prev in ("done", "failed", "cancelled"):
                job.state = prev  # history only
            else:
                # queued / running / interrupted at the old server's
                # exit: requeue — the per-job journal resumes them to
                # byte-identical outputs
                job.state = "queued"
                job.attempts = 0
                job.finished_at = None
            self._jobs[job.id] = job
            if job.state == "queued":
                self._queue.append(job)


# ---- the HTTP layer -------------------------------------------------------

def _serve_handler():
    """Build the serve request handler lazily (keeps telemetry.py
    import-light paths — stats/top — from importing this module)."""
    from ccsx_tpu_torch.utils import telemetry
    from ccsx_tpu_torch.utils.metrics import resource_gauges

    class _ServeHandler(telemetry._Handler):
        server_version = "ccsx-tpu-serve"

        def _core(self) -> ServeCore:
            return self.server.ccsx_core  # type: ignore[attr-defined]

        def _send_json(self, code: int, obj, extra=None) -> None:
            data = json.dumps(obj, default=str).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (extra or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(data)

        def _send_file(self, path: str) -> None:
            try:
                size = os.path.getsize(path)
                f = open(path, "rb")
            except OSError as e:
                self._send_json(404, {"error": f"no output: {e}"})
                return
            with f:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(size))
                self.end_headers()
                while True:
                    chunk = f.read(1 << 16)
                    if not chunk:
                        break
                    self.wfile.write(chunk)

        def do_GET(self):  # noqa: N802
            core = self._core()
            path, _, _q = self.path.partition("?")
            try:
                if path == "/healthz":
                    # LIVENESS: answers "is the process serving?" —
                    # always 200 while it is.  Per-job degradation
                    # lives in /jobs/<id> and the ccsx_job_* series;
                    # routability lives in /readyz.
                    self._send_json(200, {"status": "alive",
                                          **core.counts()})
                elif path == "/metrics":
                    body = telemetry.render_prometheus(
                        core.metrics.snapshot(), resource_gauges())
                    body += telemetry.render_job_series(
                        core.job_snapshots())
                    self._send(200, body,
                               "text/plain; version=0.0.4; "
                               "charset=utf-8")
                elif path == "/jobs":
                    if core.fleet:
                        from ccsx_tpu_torch.pipeline import gateway as gw

                        jobs = [gw.job_view(core.spool, jid)
                                for jid in gw.list_job_ids(core.spool)]
                        self._send_json(200, {"jobs": jobs})
                    else:
                        self._send_json(200, {"jobs": core.jobs()})
                elif path.startswith("/jobs/"):
                    parts = path.split("/")
                    job = core.job(parts[2])
                    view = None
                    if job is None and core.fleet:
                        # a fleet job another replica holds (or no one
                        # does yet): answer from the shared spool
                        from ccsx_tpu_torch.pipeline import gateway as gw

                        view = gw.job_view(core.spool, parts[2])
                    if job is None and view is None:
                        self._send_json(404, {"error": "unknown job"})
                    elif len(parts) == 3:
                        self._send_json(200, job.info() if job
                                        else view)
                    elif len(parts) == 4 and parts[3] == "output":
                        state = job.state if job else view["state"]
                        if state != "done":
                            self._send_json(
                                409, {"error": "job not done",
                                      "state": state})
                        else:
                            self._send_file(job.out_path if job
                                            else view.get("output")
                                            or "")
                    else:
                        self._send_json(404, {"error": "unknown path"})
                else:
                    super().do_GET()
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_POST(self):  # noqa: N802
            core = self._core()
            path, _, query = self.path.partition("?")
            try:
                if path != "/jobs":
                    self._send_json(404, {"error": "unknown path"})
                    return
                import urllib.parse

                params = {k: v[-1] for k, v in
                          urllib.parse.parse_qs(query).items()}
                length = int(self.headers.get("Content-Length") or 0)
                ctype = (self.headers.get("Content-Type") or
                         "").split(";")[0].strip().lower()
                try:
                    if ctype == "application/json":
                        raw = self.rfile.read(length)
                        body = json.loads(raw or b"{}")
                        if not isinstance(body, dict):
                            raise ValueError("JSON body must be an "
                                             "object")
                        params.update(body)
                        input_path = params.pop("input", None)
                        job = core.submit(input_path=input_path,
                                          overrides=params)
                    else:
                        # streamed BAM/FASTQ body (?format=... names
                        # the container; default bam)
                        job = core.submit(body_stream=self.rfile,
                                          body_len=length,
                                          overrides=params)
                except QueueFull as e:
                    self._send_json(429, {"error": str(e)},
                                    extra={"Retry-After": 5})
                    return
                except Draining as e:
                    self._send_json(503, {"error": str(e)})
                    return
                except (ValueError, OSError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                self._send_json(201, {"id": job.id,
                                      "state": job.state,
                                      "status": f"/jobs/{job.id}",
                                      "output":
                                      f"/jobs/{job.id}/output"})
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_DELETE(self):  # noqa: N802
            core = self._core()
            path, _, _q = self.path.partition("?")
            try:
                parts = path.split("/")
                if len(parts) != 3 or parts[1] != "jobs":
                    self._send_json(404, {"error": "unknown path"})
                    return
                try:
                    state, changed = core.cancel(parts[2])
                except KeyError:
                    self._send_json(404, {"error": "unknown job"})
                    return
                self._send_json(200 if changed else 409,
                                {"id": parts[2], "state": state,
                                 "cancelled": changed})
            except (BrokenPipeError, ConnectionResetError):
                pass

    return _ServeHandler


# ---- the subcommand -------------------------------------------------------

def serve_main(argv) -> int:
    """`ccsx-tpu-torch serve`: parse serve flags, hand the rest to the
    normal CLI parser for the compute config, run until SIGTERM (rc 75
    with unfinished jobs, else 0) or a device fault (rc 1).  On the card
    (the default; ``--device cpu`` asks for the CPU) the CUDA context
    and every kernel come up before the port is bound: no card, or a
    kernel that does not build, is rc 1 with nothing served."""
    import argparse

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.utils.drain import DrainGuard
    from ccsx_tpu_torch.utils import telemetry

    ap = argparse.ArgumentParser(
        prog="ccsx-tpu-torch serve",
        description="Resident multi-tenant consensus server: one warm "
                    "runtime, per-job fault isolation, HTTP job API "
                    "on the telemetry stack.  Unrecognized flags are "
                    "the compute config (same flags as a plain run).")
    ap.add_argument("--port", type=int, default=8855,
                    help="HTTP port (auto-bumps when taken; 0 = one "
                         "ephemeral port) [8855]")
    ap.add_argument("--serve-host", default="",
                    help="bind host [CCSX_TELEMETRY_HOST or 0.0.0.0]")
    ap.add_argument("--spool", default=".ccsx_serve",
                    help="spool directory: job inputs/outputs/journals "
                         "+ state.json (restart resumes it) "
                         "[.ccsx_serve]")
    ap.add_argument("--max-queue", type=int, default=16,
                    help="queued-job cap; submissions beyond it get "
                         "HTTP 429 + Retry-After [16]")
    ap.add_argument("--max-active", type=int, default=2,
                    help="concurrently running jobs (they share the "
                         "admission window fairly) [2]")
    ap.add_argument("--job-retries", type=int, default=1,
                    help="retry budget for transient (rc 1) job "
                         "failures; retries RESUME from the job "
                         "journal [1]")
    ap.add_argument("--retry-backoff", type=float, default=0.5,
                    help="base backoff seconds between retries "
                         "(doubles per attempt) [0.5]")
    ap.add_argument("--job-deadline", type=float, default=0.0,
                    help="default per-job wall-clock deadline in "
                         "seconds, across retries (0 = none; jobs can "
                         "set their own deadline_s) [0]")
    ap.add_argument("--fleet", default=None, metavar="SPOOL",
                    help="run as one replica of a serve FLEET sharing "
                         "SPOOL as a job lease domain (replaces "
                         "--spool; jobs are leased, replica death "
                         "requeues them, `ccsx-tpu-torch gateway` balances)")
    ap.add_argument("--replica-name", default=None,
                    help="replica identity in leases/markers "
                         "[s<pid>]")
    ap.add_argument("--lease-timeout", type=float, default=10.0,
                    help="job-lease heartbeat timeout seconds (fleet "
                         "mode) [10]")
    ap.add_argument("--fanout-holes", type=int, default=0,
                    help="fan a job out across replicas through the "
                         "range queue when it has at least this many "
                         "holes (0 = never) [0]")
    ap.add_argument("--fanout-ranges", type=int, default=0,
                    help="range count M for fan-out jobs (0 = auto; "
                         "must match across replicas) [0]")
    ap.add_argument("--poll", type=float, default=0.25,
                    help="fleet spool scan interval seconds [0.25]")
    a, rest = ap.parse_known_args(argv)
    cli_args = cli.build_parser().parse_args(rest)
    if cli_args.help:
        ap.print_help()
        return 1
    for flag, bad in (("--bam", cli_args.bam_out),
                      ("--hosts", cli_args.hosts is not None),
                      ("--fleet-dir", cli_args.fleet_dir is not None),
                      ("--merge-shards",
                       cli_args.merge_shards is not None),
                      ("--make-index", cli_args.make_index)):
        if bad:
            print(f"Error: {flag} is not supported under serve",
                  file=sys.stderr)
            return 1
    try:
        cfg = cli.config_from_args(cli_args)
    except SystemExit as e:
        return int(e.code or 0)
    if cli_args.inject_faults:
        # server-level chaos plan (benchmarks/serve_chaos.py): fires
        # only on threads OUTSIDE any job scope — jobs are isolated in
        # their own (possibly empty) fault domains
        try:
            faultinject.arm(cli_args.inject_faults)
        except ValueError as e:
            print(f"Error: --inject-faults: {e}", file=sys.stderr)
            return 1

    # no fallback: the card and the kernels, or no server
    from ccsx_tpu_torch.ops import cuda_ext
    from ccsx_tpu_torch.utils.device import resolve_device

    try:
        if resolve_device(cfg.device).type == "cuda":
            cuda_ext.load_all()
    except (RuntimeError, OSError) as e:
        print(f"Error: serve: {e}", file=sys.stderr)
        return exitcodes.RC_FATAL
    guard = DrainGuard.install()
    spool = a.fleet or a.spool
    core = ServeCore(cfg, spool=spool, max_queue=a.max_queue,
                     max_active=a.max_active, retries=a.job_retries,
                     backoff_s=a.retry_backoff,
                     job_deadline_s=a.job_deadline,
                     fleet=bool(a.fleet), replica=a.replica_name,
                     lease_timeout=a.lease_timeout,
                     fanout_holes=a.fanout_holes,
                     fanout_ranges=a.fanout_ranges, poll_s=a.poll)
    port = a.port
    if a.fleet:
        # deterministic co-hosted ports: replica in slot k serves on
        # base_port + k, and the slot lease advertises the ACTUAL
        # bound port — gateway/top discover it, never guess it
        slot = core.register_replica()
        if port:
            port = port + slot
    try:
        srv = telemetry.TelemetryServer(
            core.metrics, port, host=a.serve_host,
            handler=_serve_handler(),
            attrs={"ccsx_core": core, "ccsx_ready": core.readiness})
    except OSError as e:
        print(f"Error: serve: {e}", file=sys.stderr)
        core.close()
        guard.restore()
        return 1
    core.set_advertised(srv.port)
    mode = (f"fleet replica {core.replica} slot {core._slot}"
            if a.fleet else "solo")
    print(f"[ccsx-tpu-torch] serve: http://{srv.host}:{srv.port} "
          "(POST /jobs, GET /jobs/<id>, /readyz, /metrics; "
          f"spool {spool}; {mode})", file=sys.stderr)
    try:
        while not guard.requested and core.device_fault is None:
            time.sleep(0.2)
        if core.device_fault is None:
            print("[ccsx-tpu-torch] serve: draining — no new jobs, "
                  "settling in-flight journals (resumable rc 75)",
                  file=sys.stderr)
        rc = core.drain()
    finally:
        srv.close()
        core.close()
        guard.restore()
    if core.device_fault is not None:
        print(f"[ccsx-tpu-torch] serve: stopped on a device fault "
              f"({core.device_fault}); the jobs are persisted: restart the "
              "same command to resume them", file=sys.stderr)
        return exitcodes.RC_FATAL
    if rc == exitcodes.RC_INTERRUPTED:
        print("[ccsx-tpu-torch] serve: drained with unfinished jobs; "
              "restart the same command to resume them",
              file=sys.stderr)
    return rc
