"""Counters and structured logging (a copy of the JAX package's
utils/metrics.py; only ``resource_gauges`` and the text differ).

The reference has no observability beyond -v stderr prints; this is the
replacement: cheap counters, a ZMWs/sec rate, and optional JSON-lines
emission.  The snapshot keeps every key of the JAX package's, including
those whose planes the port does not have yet (they stay at their rest
values); the port's own step counters ride it through
``utils/run_metrics.RunMetrics``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import sys
import threading
import time
from typing import Optional, TextIO


def resource_gauges() -> dict:
    """Peak host RSS + the device memory this process holds, best effort
    (0 when unknown).  Stamped on the metrics "final" event.
    ``device_buffer_bytes`` is ``torch.cuda.memory_reserved`` summed over
    the devices: the buffers the caching allocator holds on the card,
    live or cached for reuse.  (``memory_allocated``, the live tensors
    alone, reads 0 here: the final event comes after the drivers have
    freed every tensor.)  Read only when torch is already loaded and CUDA
    already initialised: this never *imports* torch and never initialises
    CUDA, so a process that avoided both (the stats and blackbox
    subcommands on a host whose card is wedged) stays free of them."""
    peak = 0
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KiB on Linux, bytes on macOS
        if sys.platform != "darwin":
            peak *= 1024
    except (ImportError, OSError, ValueError):
        peak = 0
    dev = 0
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                dev = sum(int(torch.cuda.memory_reserved(d))
                          for d in range(torch.cuda.device_count()))
        except Exception:
            dev = 0
    return {"peak_rss_bytes": int(peak), "device_buffer_bytes": int(dev)}


# ---- latency histograms ----------------------------------------------------
#
# ONE fixed log-spaced bucket ladder for every latency family.  Fixed
# (not per-family) so multi-source aggregation can merge by summing
# per-`le` counts unconditionally — `ccsx-tpu top` and the gateway
# merge replica histograms without negotiating bucket layouts, and a
# replica restarted on a newer build still merges with its older
# peers.  Spans ~5ms (a warm lease acquire) to 5min (a cold-compile
# job wall); observations past the top land in +Inf only.
HIST_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


class Histogram:
    """A fixed-bucket latency histogram (Prometheus-shaped: cumulative
    `le` buckets + sum + count).  NOT thread-safe on its own — callers
    go through Metrics.observe(), which serializes under _count_lock
    (the same discipline as bump())."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self):
        # one slot per bucket bound + the +Inf overflow slot; stored
        # NON-cumulative (per-bucket increments) — the renderer
        # accumulates, which keeps merge() a plain elementwise sum
        self.counts = [0] * (len(HIST_BUCKETS) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = max(float(value), 0.0)
        i = 0
        for b in HIST_BUCKETS:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def snapshot(self) -> dict:
        return {"counts": list(self.counts),
                "sum": round(self.sum, 6), "count": self.count}


def merge_hist(snaps) -> dict:
    """Merge histogram SNAPSHOTS by summing per-`le` counts — never by
    averaging quantiles (quantiles do not compose; summed buckets do).
    Tolerates torn/foreign dicts by skipping them."""
    out = {"counts": [0] * (len(HIST_BUCKETS) + 1), "sum": 0.0,
           "count": 0}
    for s in snaps:
        try:
            counts = s["counts"]
            if len(counts) != len(out["counts"]):
                continue
            for i, c in enumerate(counts):
                out["counts"][i] += int(c)
            out["sum"] += float(s["sum"])
            out["count"] += int(s["count"])
        except (KeyError, TypeError, ValueError):
            continue
    out["sum"] = round(out["sum"], 6)
    return out


def hist_quantile(snap: dict, q: float):
    """Estimate the q-quantile from a histogram snapshot the way
    Prometheus' histogram_quantile does: find the bucket where the
    cumulative count crosses q*count and interpolate linearly inside
    it.  None when empty."""
    try:
        total = int(snap["count"])
        counts = snap["counts"]
    except (KeyError, TypeError, ValueError):
        return None
    if total <= 0:
        return None
    target = q * total
    cum = 0
    lo = 0.0
    for i, b in enumerate(HIST_BUCKETS):
        prev = cum
        cum += counts[i]
        if cum >= target:
            frac = ((target - prev) / counts[i]) if counts[i] else 0.0
            return round(lo + (b - lo) * frac, 6)
        lo = b
    # target lands in +Inf: the top bound is the honest answer
    return float(HIST_BUCKETS[-1])


def size_class(holes_total) -> str:
    """The per-size-class label for job latency families: queue-wait
    and wall distributions are only comparable within a size band (a
    large job legitimately waits and runs longer).  Bands are in RAW
    input holes; unknown totals get their own class rather than
    polluting a band."""
    if not holes_total:
        return "unknown"
    if holes_total <= 16:
        return "small"
    if holes_total <= 256:
        return "medium"
    return "large"


class FailureBudgetExceeded(RuntimeError):
    """Raised by check_failure_budget when --max-failed-holes is
    exceeded: the run aborts with RC_FAILED_HOLES (exitcodes.py)
    instead of quarantining its way to a near-empty output at rc 0."""


def check_failure_budget(metrics: "Metrics", cfg, final: bool = False):
    """Enforce cfg.max_failed_holes (None = unbounded, the historical
    behavior).  A value >= 1 is an absolute COUNT, checked the moment a
    hole fails (exceeding it aborts immediately); a value in (0, 1) is
    a FRACTION of processed holes (failed + emitted), checked at end of
    run — mid-run the denominator is still growing, so a fraction can
    only be judged early against a KNOWN total (the BGZF index
    sidecar's holes_total), where no future success can dilute it back
    under budget."""
    budget = getattr(cfg, "max_failed_holes", None)
    if budget is None:
        return
    # corrupt holes (salvage-mode input damage) spend the same budget
    # as quarantined ones: both are holes the output will not carry.
    # Structural-only events (corruption.NON_BUDGET_REASONS, e.g. a
    # missing BGZF EOF marker on an otherwise-complete file) degrade
    # the run but lose no hole, so they must not rc-2 a full output
    from ccsx_tpu_torch.io.corruption import NON_BUDGET_REASONS

    corrupt = metrics.holes_corrupt - sum(
        metrics.corrupt_reasons.get(r, 0) for r in NON_BUDGET_REASONS)
    failed = metrics.holes_failed + max(corrupt, 0)
    if not 0 < budget < 1:   # absolute count (0 = abort on any failure)
        if failed > int(budget):
            raise FailureBudgetExceeded(
                f"failed-hole budget exceeded: {failed} holes failed "
                f"or corrupt (--max-failed-holes {int(budget)})")
        return
    total = metrics.holes_total
    if total and failed > budget * total:
        raise FailureBudgetExceeded(
            f"failed-hole budget exceeded: {failed} of {total} input "
            f"holes failed (> {budget:.0%}, --max-failed-holes "
            f"{budget:g})")
    if final:
        # the denominator spans the whole LOGICAL run: this session's
        # emissions plus prior sessions' journaled ones (holes_failed
        # is already cumulative via the journal restore — judging old
        # failures against only a short resume tail's successes would
        # spuriously abort an overwhelmingly-healthy run)
        done = (failed + metrics.holes_out
                + metrics.holes_prior_emitted)
        if done and failed > budget * done:
            raise FailureBudgetExceeded(
                f"failed-hole budget exceeded: {failed} of {done} "
                f"processed holes failed (> {budget:.0%}, "
                f"--max-failed-holes {budget:g})")


@dataclasses.dataclass
class Metrics:
    verbose: int = 0
    stream: Optional[TextIO] = None
    # multi-tenant label (pipeline/serve.py): the job id this Metrics
    # object accounts for.  None outside the serving plane.  Rides
    # every snapshot/event so a job's JSONL stream and its
    # ccsx_job_*{job="..."} series are attributable without relying on
    # file paths.
    job: Optional[str] = None
    # fleet-wide correlation id (ISSUE 18): minted at job submission
    # (gateway.submit_job / serve solo submit) and propagated through
    # replica leases, fan-out range leases, and every span/metrics
    # event — the key `ccsx-tpu report --fleet` stitches per-process
    # JSONL files by.  None outside the serving plane.
    cid: Optional[str] = None
    holes_in: int = 0
    holes_out: int = 0
    holes_failed: int = 0
    # holes dropped by the ingest filters (main.c:659-672 semantics),
    # with per-reason buckets (few_passes / too_short / too_long /
    # excluded).  Fed by BOTH ingest paths: io/zmw.stream_zmws counts
    # live, and the native C++ streamer — which filters in-library and
    # used to report nothing — surfaces its counts at stream EOF
    # (native/io.py, ccsx_filter_counts)
    holes_filtered: int = 0
    filtered_reasons: dict = dataclasses.field(default_factory=dict)
    # salvage-mode ingest (io/corruption.py, --salvage): classified
    # input-corruption events the readers resynced past (~ holes lost
    # to damage), with per-reason buckets from the pinned taxonomy.
    # Fed by both reader stacks (Python sinks live; the native reader
    # polls an atomic event count live + reason buckets at EOF) and by
    # the drivers' injected-fault rung.  Counts toward the
    # --max-failed-holes budget and marks the run degraded.
    holes_corrupt: int = 0
    corrupt_reasons: dict = dataclasses.field(default_factory=dict)
    windows: int = 0
    pair_alignments: int = 0   # batched prep strand_match pairs
    # pre-alignment plane (ISSUE 11, ops/sketch.py + ops/seed_device.py):
    # candidate pairs scored by the batched device screen, pairs it
    # rejected BEFORE seeding/DP (prefilter_share in snapshot() is
    # rejected/screened — the long-template regime's removed waste),
    # and the device-vs-host k-mer seeding split (--seed-device-min-t
    # crossover).  All bumped by PairExecutor, possibly from the pair
    # gate's pump thread.
    pairs_screened: int = 0
    pairs_prefiltered: int = 0
    pairs_seeded_device: int = 0
    pairs_seeded_host: int = 0
    device_dispatches: int = 0
    # per-implementation banded DP-fill attribution (consensus/star.
    # banded_impl dispatch): {"scan"|"pallas"|"rotband": dispatches}.
    # Makes an A/B run or a breaker/compile-forced scan pin visible in
    # top/stats//metrics (ccsx_banded_impl{impl=...}) without logs —
    # bumped at the round/refine/packed dispatch sites via bump_banded()
    banded_dispatches: dict = dataclasses.field(default_factory=dict)
    refine_overflows: int = 0  # fused windows replayed on host (rare)
    # fault-tolerance ladder counters (pipeline/batch.py recovery):
    # group bisections after a device OOM, per-request host replays
    # (ladder bottom / data errors), and scan-spec pins after a Pallas
    # compile failure (at most 1/process)
    oom_resplits: int = 0
    host_fallbacks: int = 0
    compile_fallbacks: int = 0
    # resilient execution (pipeline/resilience.py): dispatches abandoned
    # past --dispatch-deadline (each one recovered on the host path),
    # and the backend circuit breaker's state machine — trips (closed ->
    # open on N strikes in the window), half-open probes, the live
    # state string, and a bounded log of the qualifying strikes
    # (hang / compile / oom ladder-bottom, each {ts, kind, group})
    # prior sessions' emitted holes, restored from the journal on
    # resume (internal: feeds the --max-failed-holes fraction
    # denominator only — holes_out stays THIS session's emission count
    # so rates/progress are unaffected)
    holes_prior_emitted: int = 0
    device_hangs: int = 0
    breaker_trips: int = 0
    breaker_probes: int = 0
    breaker_state: str = "closed"
    breaker_strike_log: list = dataclasses.field(default_factory=list)
    # padding accounting for the batched device rounds (SURVEY §7.3
    # item 2 names padding waste the main throughput risk): real = DP
    # fill cells belonging to real pass-rows at their true qlen;
    # padded = cells actually dispatched (Z x P x qmax x band x iters,
    # i.e. including pad holes, pad rows, and qlen->qmax padding).
    # occupancy = real/padded is the fraction of device fill work that
    # was asked for.  Pair alignments (PairExecutor) are included.
    dp_cells_real: int = 0
    dp_cells_padded: int = 0
    # decomposition of the occupancy loss for the CONSENSUS-ROUND
    # dispatches (pair alignments excluded — they have no Z/P bucket
    # structure).  All four counters are in CELL units so the identity
    #   round_real/round_padded = length_fill x pass_fill x z_fill
    # holds EXACTLY even when dispatches with different (Z, P, qmax,
    # iters) aggregate (unweighted row/hole ratios misattribute padding
    # across heterogeneous shape groups):
    #   length_fill = round_cells_real / rowcells_real
    #   pass_fill   = rowcells_real   / rowcells_cap
    #   z_fill      = rowcells_cap    / round_cells_padded
    # where rowcells_real = real pass-rows at full qmax and
    # rowcells_cap = (real holes x P) rows at full qmax, both
    # x band x iters — bucket tuning can see WHICH bucket wastes.
    dp_round_cells_real: int = 0
    dp_round_cells_padded: int = 0
    dp_rowcells_real: int = 0
    dp_rowcells_cap: int = 0
    # ragged pass-packing (pipeline/pack.py): real (hole, pass) rows vs
    # slab rows dispatched — dp_row_fill = rows_real / rows_dispatched
    # is the packed analog of pass_fill x z_fill (a packed slab has no
    # Z axis, so its z_fill is identically 1 and its pass_fill is the
    # row fill; these plain row counts read the same story without the
    # qmax/iters cell weighting) — and holes co-dispatched per slab
    # (packed_holes_per_dispatch), the fragmentation counter that used
    # to read ~1.7 windows/dispatch under bucketed grouping
    dp_rows_real: int = 0
    dp_rows_dispatched: int = 0
    packed_dispatches: int = 0
    packed_holes: int = 0
    # compile-lean dispatch (r8): distinct (R, qmax, tmax, iters) slab
    # shapes the packed executor dispatched — the canonical-shape ladder
    # (pipeline/pack.py) bounds this to ~ladder x groups, and the r7
    # compile storm showed up here as ~5x groups.  The executor owns the
    # set; this is its size.
    distinct_slab_shapes: int = 0
    # fused multi-chip packed dispatch: waves issued, real slabs in
    # them, and total chip-slots (waves x D) — fused_slot_fill below is
    # the chip-utilization analog of dp_row_fill (idle chips in a wave
    # are padding dummy slabs that freeze at iteration 0, so they cost
    # ~nothing but chip time)
    fused_waves: int = 0
    fused_slabs_real: int = 0
    fused_slots: int = 0
    # compressed input bytes this process ingested (byte-range sharded
    # BAM ingest reports its ~1/N share; full-parse paths report the
    # file size).  0 when unknown (stdin / pure-stream inputs).
    ingest_bytes: int = 0
    # per-stage wall time (SURVEY.md §5.1: the reference has no stage
    # timing; the pipeline analog of its read/compute/write steps).
    # Attribution is at the driver loop — except ingest and prep, which
    # the prep plane (pipeline/prep_pool.py) runs on background threads
    # when it is on: t_ingest/t_prep then sum WORK seconds across those
    # threads (overlapped with device compute, so not comparable with
    # an inline-mode run's critical-path seconds), while t_prep_blocked
    # below keeps the critical-path story.  Ingest gets no blocked twin:
    # it is measured ~0% of wall on every artifact, and a driver starved
    # by it shows up in prep_blocked (the pool delivers nothing).
    t_ingest: float = 0.0
    t_prep: float = 0.0     # host orientation/clip (ccs_prepare analog)
    t_compute: float = 0.0
    t_write: float = 0.0
    # prep plane (ISSUE 8): driver wall spent BLOCKED on prep — inline
    # prep when the pool is off (t_prep_blocked == t_prep there), or
    # waiting on the pool's ready queue with nothing dispatchable when
    # it is on.  prep_share = t_prep_blocked / elapsed is the
    # critical-path prep share the <= 0.10 acceptance bar reads;
    # prep_overlap_share = 1 - blocked/worked is how much of the prep
    # work the overlap hid.
    t_prep_blocked: float = 0.0
    # live prep-plane gauges: holes prepped-and-waiting for the driver
    # (current + high-water) and the pool width (0 = inline prep)
    prep_queue_depth: int = 0
    prep_queue_peak: int = 0
    prep_threads: int = 0
    # elastic fleet plane (pipeline/fleet.py + supervisor.fleet_run):
    # the scheduler's view of the leased-range queue.  ranges_total is
    # M (the -M split); queued/leased are live gauges over the lease
    # files; retired counts .done markers observed.  steals counts
    # expired/reclaimed leases moved to the graveyard (each is a range
    # another worker may now pick up); rebalances counts reap-time
    # reclaim sweeps that freed at least one lease (rank loss events
    # absorbed by the survivors).  All zero outside fleet mode.
    fleet_ranges_total: int = 0
    fleet_ranges_queued: int = 0
    fleet_ranges_leased: int = 0
    fleet_ranges_retired: int = 0
    fleet_ranks_alive: int = 0
    fleet_steals: int = 0
    fleet_rebalances: int = 0
    # latency histograms (ISSUE 18): family name -> label value ->
    # Histogram.  Families and their label keys are enumerated in
    # telemetry.HIST_FAMILIES (schema-guarded both directions); all
    # share the ONE fixed HIST_BUCKETS ladder so merges sum per-`le`.
    hists: dict = dataclasses.field(default_factory=dict)
    # a "progress" JSONL event is emitted every progress_every retired
    # holes (0 disables); "final" is always emitted at report().  The
    # live-telemetry plane also emits one every progress_interval_s
    # seconds of wall (0 disables) so slow runs still produce a usable
    # ETA-vs-actual series (`ccsx-tpu report`) and a tailable stream
    # (`ccsx-tpu top` on endpoint-less runs)
    progress_every: int = 512
    progress_interval_s: float = 30.0
    # progress/ETA estimator: total holes this run will retire when
    # knowable (the BGZF hole index sidecar / a rank's hole range —
    # RAW holes, so filtered holes count toward done), else None =
    # unknown-total mode (rate only, no pct/ETA)
    holes_total: Optional[int] = None
    # windowed-rate ring buffer of (monotonic, holes retired): the
    # instantaneous zmws/sec over the last <= _RATE_WINDOW samples
    # (sampled at >= _RATE_SAMPLE_S spacing), robust to the cold-start
    # compile minutes that make the whole-run average useless for ETA
    _rate_ring: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=128),
        repr=False)
    _last_interval_emit: float = dataclasses.field(
        default_factory=time.monotonic, repr=False)
    # per-shape-group dispatch attribution (utils/trace.py fills this:
    # compiles, compile_s, execute_s, dispatches, dp_cells per group
    # key) — rendered into every event by snapshot() so recompile
    # storms and slow groups are visible in any metrics JSONL
    group_stats: dict = dataclasses.field(default_factory=dict)
    # set by the stall watchdog (utils/trace.py) when a device dispatch
    # hangs past --stall-timeout: the run completed (or died) degraded,
    # and every later event — including "final" — says so.  stalls
    # counts the watchdog's reports (full + compact) — the /healthz
    # detail an operator triages by
    degraded: Optional[str] = None
    stalls: int = 0
    # unsuppressed ccsx-lint findings (ccsx_tpu_torch/lint/): populated by a
    # supervisor that runs `ccsx-tpu lint --gauge-file` (or bump()s it
    # directly) so fleet dashboards watch static-analysis drift the
    # same way they watch stalls; 0 = clean tree, never populated on
    # the pipeline's own hot path
    lint_findings: int = 0
    # set by the Tracer: True when device spans used the forced-
    # execution close (--trace), i.e. the group table's seconds are
    # real chip walls; False means dispatch-queue bookkeeping on an
    # async backend (counts exact, seconds unreliable)
    groups_forced: Optional[bool] = None
    _ticked: int = 0
    t0: float = dataclasses.field(default_factory=time.monotonic)
    # emit() runs on the driver thread AND the stall-watchdog thread
    _emit_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    # counter/stage updates arrive from the driver, the prep-pool
    # workers, and the pair-gate pump concurrently; += on an attribute
    # is a racy read-modify-write, so concurrent writers go through
    # bump()/add_stage() under this lock
    _count_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    def bump(self, **deltas) -> None:
        """Atomically add deltas to counter fields (thread-safe +=)."""
        with self._count_lock:
            for k, v in deltas.items():
                prev = getattr(self, k)
                setattr(self, k, prev + v)
                # time-to-first-dispatch: the 0 -> nonzero crossing of
                # device_dispatches is the first device work this run
                # issued — observed here (the one choke point every
                # dispatch site already funnels through) so no driver
                # needs its own first-dispatch bookkeeping
                if (k == "device_dispatches" and prev == 0
                        and getattr(self, k) > 0):
                    self._observe_locked(
                        "first_dispatch_s", time.monotonic() - self.t0,
                        size_class(self.holes_total))

    def _observe_locked(self, name: str, value: float,
                        label: str = "") -> None:
        """observe() body; caller holds _count_lock."""
        fam = self.hists.setdefault(name, {})
        h = fam.get(label)
        if h is None:
            h = fam[label] = Histogram()
        h.observe(value)

    def observe(self, name: str, value: float, label: str = "") -> None:
        """Record one latency observation into a histogram family
        (thread-safe; dispatch closures and lease acquires run on
        executor/pump threads)."""
        with self._count_lock:
            self._observe_locked(name, value, label)

    def hist_snapshot(self) -> dict:
        """family -> label -> {counts, sum, count}, copied under the
        lock (scraper threads race live observes)."""
        with self._count_lock:
            return {name: {lbl: h.snapshot() for lbl, h in fam.items()}
                    for name, fam in self.hists.items()}

    def merge_hists(self, hist: dict) -> None:
        """Absorb another Metrics' hist snapshot — summing per-`le`
        counts, the only legal histogram merge.  This is how serve
        folds each finished job's fault-domain observations (first
        dispatch, per-job families) into the server-lifetime snapshot
        its /progress and /metrics expose."""
        if not hist:
            return
        with self._count_lock:
            for name, fam in hist.items():
                if not isinstance(fam, dict):
                    continue
                for label, s in fam.items():
                    try:
                        counts = s["counts"]
                        add_sum = float(s["sum"])
                        add_count = int(s["count"])
                    except (KeyError, TypeError, ValueError):
                        continue
                    dst = self.hists.setdefault(name, {})
                    h = dst.get(label)
                    if h is None:
                        h = dst[label] = Histogram()
                    if len(counts) != len(h.counts):
                        continue
                    for i, c in enumerate(counts):
                        h.counts[i] += int(c)
                    h.sum += add_sum
                    h.count += add_count

    def bump_banded(self, impl: str, n: int = 1) -> None:
        """Attribute n banded DP-fill dispatches to an implementation
        (thread-safe; dispatch closures run on executor threads)."""
        with self._count_lock:
            self.banded_dispatches[impl] = (
                self.banded_dispatches.get(impl, 0) + n)

    def add_stage(self, stage: str, seconds: float) -> None:
        """Thread-safe accumulation into t_<stage>."""
        attr = "t_" + stage
        with self._count_lock:
            setattr(self, attr, getattr(self, attr) + seconds)

    @contextlib.contextmanager
    def timer(self, stage: str):
        """Accumulate a with-block's wall time into t_<stage>."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_stage(stage, time.perf_counter() - t0)

    # windowed-rate sampling: coalesce ring samples closer than this
    # (a fast run must not shrink the window to microseconds), and keep
    # at most _rate_ring.maxlen of them (~32 s+ of history)
    _RATE_SAMPLE_S = 0.25

    def tick(self) -> None:
        """Called once per retired hole; feeds the windowed-rate ring
        and emits periodic progress events (every progress_every holes
        AND every progress_interval_s seconds of wall)."""
        self._ticked += 1
        now = time.monotonic()
        ring = self._rate_ring
        if not ring or now - ring[-1][0] >= self._RATE_SAMPLE_S:
            # sample RETIRED holes (+ filtered, which retire at zero
            # cost) — the same basis progress_snapshot reports.
            # Ingested-but-in-flight holes must NOT count: the batched
            # scheduler admits a whole inflight window up front, which
            # would read as instant-100% progress on small runs
            ring.append((now, self._ticked + self.holes_filtered))
        due = (self.progress_every
               and self._ticked % self.progress_every == 0)
        if (self.progress_interval_s
                and now - self._last_interval_emit
                >= self.progress_interval_s):
            due = True
        if due:
            self._last_interval_emit = now
            self.emit("progress")
            if self.verbose:
                print("[ccsx-tpu-torch] progress "
                      f"{json.dumps(self.snapshot())}",
                      file=sys.stderr)

    def heartbeat(self) -> None:
        """Called from the driver loops between retirements: emits the
        interval-driven progress event even when no hole has retired
        for a while — a single-admission-batch run (holes <= inflight)
        retires everything in its final drain, and tick()-only emission
        would leave the metrics stream silent for the whole middle of
        the run."""
        if not self.progress_interval_s:
            return
        now = time.monotonic()
        if now - self._last_interval_emit >= self.progress_interval_s:
            self._last_interval_emit = now
            self.emit("progress")

    @property
    def elapsed(self) -> float:
        return max(time.monotonic() - self.t0, 1e-9)

    @property
    def zmws_per_sec(self) -> float:
        return self.holes_out / self.elapsed

    def progress_snapshot(self) -> dict:
        """The streaming progress/ETA estimate: retired-hole count,
        windowed rate, and — when holes_total is knowable — percent
        done and ETA seconds.  Unknown-total mode reports rate only.
        Rides every metrics event (snapshot()) and the /progress +
        /metrics endpoints (utils/telemetry.py)."""
        # retired holes + filtered holes (retired at zero cost).  NOT
        # holes_in: in-flight admissions are unfinished work.  Resumed
        # holes skip tick(), so a resumed run's pct undercounts by the
        # prior run's share — conservative, never optimistic
        done = self._ticked + self.holes_filtered
        ring = list(self._rate_ring)
        if len(ring) >= 2 and ring[-1][0] > ring[0][0]:
            rate = (ring[-1][1] - ring[0][1]) / (ring[-1][0] - ring[0][0])
        else:
            rate = done / self.elapsed
        prog = {
            "done": done,
            "total": self.holes_total,
            "rate_zmws_per_sec": round(rate, 3),
            "elapsed_s": round(self.elapsed, 3),
        }
        if self.holes_total:
            prog["pct"] = round(min(done / self.holes_total, 1.0) * 100,
                                2)
            remaining = max(self.holes_total - done, 0)
            prog["eta_s"] = (round(remaining / rate, 1) if rate > 0
                             else None)
        return prog

    def _group_table(self) -> dict:
        """Render group_stats for events, via the one shared finalizer
        in utils/trace.py (summarize() uses the same one, so the table
        from a metrics file and from a trace file cannot drift)."""
        from ccsx_tpu_torch.utils import trace

        # dict() copy: the watchdog thread snapshots while the driver
        # thread may be inserting a new group
        return trace.finalize_group_table(dict(self.group_stats))

    def snapshot(self) -> dict:
        snap = {
            "holes_in": self.holes_in,
            "holes_out": self.holes_out,
            "holes_failed": self.holes_failed,
            "holes_filtered": self.holes_filtered,
            "holes_corrupt": self.holes_corrupt,
            "stalls": self.stalls,
            "windows": self.windows,
            "pair_alignments": self.pair_alignments,
            "pairs_screened": self.pairs_screened,
            "pairs_prefiltered": self.pairs_prefiltered,
            "prefilter_share": round(self.pairs_prefiltered
                                     / self.pairs_screened, 4)
                               if self.pairs_screened else None,
            "pairs_seeded_device": self.pairs_seeded_device,
            "pairs_seeded_host": self.pairs_seeded_host,
            "device_dispatches": self.device_dispatches,
            "refine_overflows": self.refine_overflows,
            "oom_resplits": self.oom_resplits,
            "host_fallbacks": self.host_fallbacks,
            "compile_fallbacks": self.compile_fallbacks,
            "device_hangs": self.device_hangs,
            "breaker_state": self.breaker_state,
            "breaker_trips": self.breaker_trips,
            "breaker_probes": self.breaker_probes,
            "dp_cells_real": self.dp_cells_real,
            "dp_cells_padded": self.dp_cells_padded,
            "dp_occupancy": round(self.dp_cells_real
                                  / self.dp_cells_padded, 4)
                            if self.dp_cells_padded else None,
            "dp_round_occupancy": round(self.dp_round_cells_real
                                        / self.dp_round_cells_padded, 4)
                                  if self.dp_round_cells_padded else None,
            "dp_length_fill": round(self.dp_round_cells_real
                                    / self.dp_rowcells_real, 4)
                              if self.dp_rowcells_real else None,
            "dp_pass_fill": round(self.dp_rowcells_real
                                  / self.dp_rowcells_cap, 4)
                            if self.dp_rowcells_cap else None,
            "dp_z_fill": round(self.dp_rowcells_cap
                               / self.dp_round_cells_padded, 4)
                         if self.dp_round_cells_padded else None,
            "dp_row_fill": round(self.dp_rows_real
                                 / self.dp_rows_dispatched, 4)
                           if self.dp_rows_dispatched else None,
            "packed_holes_per_dispatch": round(self.packed_holes
                                               / self.packed_dispatches,
                                               2)
                                         if self.packed_dispatches
                                         else None,
            "distinct_slab_shapes": self.distinct_slab_shapes or None,
            "fused_waves": self.fused_waves or None,
            "fused_slot_fill": round(self.fused_slabs_real
                                     / self.fused_slots, 4)
                               if self.fused_slots else None,
            "ingest_bytes": self.ingest_bytes,
            "ingest_s": round(self.t_ingest, 6),
            "prep_s": round(self.t_prep, 6),
            "compute_s": round(self.t_compute, 6),
            "write_s": round(self.t_write, 6),
            # prep plane: critical-path prep exposure + overlap quality
            # (None overlap until any prep work exists).  prep_share is
            # the acceptance counter: blocked-on-prep wall / elapsed
            "prep_blocked_s": round(self.t_prep_blocked, 6),
            "prep_share": round(self.t_prep_blocked / self.elapsed, 4),
            "prep_overlap_share": round(
                1.0 - min(self.t_prep_blocked / self.t_prep, 1.0), 4)
                                  if self.t_prep else None,
            "prep_queue_depth": self.prep_queue_depth,
            "prep_queue_peak": self.prep_queue_peak,
            "prep_threads": self.prep_threads,
            "fleet_ranges_total": self.fleet_ranges_total,
            "fleet_ranges_queued": self.fleet_ranges_queued,
            "fleet_ranges_leased": self.fleet_ranges_leased,
            "fleet_ranges_retired": self.fleet_ranges_retired,
            "fleet_ranks_alive": self.fleet_ranks_alive,
            "fleet_steals": self.fleet_steals,
            "fleet_rebalances": self.fleet_rebalances,
            "elapsed_s": round(self.elapsed, 3),
            "zmws_per_sec": round(self.zmws_per_sec, 3),
            "progress": self.progress_snapshot(),
        }
        if self.filtered_reasons:
            # dict() copy: the telemetry thread snapshots while the
            # ingest loop may be inserting a new reason bucket
            snap["filtered_reasons"] = dict(self.filtered_reasons)
        if self.corrupt_reasons:
            snap["corrupt_reasons"] = dict(self.corrupt_reasons)
        if self.banded_dispatches:
            snap["banded_dispatches"] = dict(self.banded_dispatches)
        if self.breaker_strike_log:
            # list() copy: the breaker publishes a fresh list per
            # strike, but a scraper could catch the reassignment
            snap["breaker_strike_log"] = list(self.breaker_strike_log)
        if self.group_stats:
            snap["groups"] = self._group_table()
            snap["groups_forced"] = bool(self.groups_forced)
            # compile share of wall: how much of this run's elapsed
            # time went to XLA compiles (warmup-thread compiles overlap
            # the stream, so a healthy warmed run shows compile_s high
            # but compile blocking ~nothing — compare against the
            # per-group tables; dict() copy: watchdog-thread safety)
            comp = sum(st.get("compile_s", 0.0)
                       for st in dict(self.group_stats).values())
            snap["compile_s"] = round(comp, 4)
            snap["compile_share"] = round(comp / self.elapsed, 4)
        if self.hists:
            snap["hist"] = self.hist_snapshot()
        if self.job:
            snap["job"] = self.job
        if self.cid:
            snap["cid"] = self.cid
        # always present (None when clean) so the schema guards see the
        # key; the renderer drops None-valued samples
        snap["lint_findings"] = self.lint_findings or None
        if self.degraded:
            snap["degraded"] = self.degraded
        # degraded-relevant detail: a FAILED native .so auto-rebuild
        # silently disables the C++ IO path (pure-Python fallback, same
        # bytes, much slower ingest) — surface it in every event so a
        # mysteriously slow run is diagnosable from its metrics alone.
        # Read lazily from the loader (no jax, no rebuild attempt — the
        # loader caches its one try).
        try:
            from ccsx_tpu_torch import native as native_mod

            err = native_mod.build_error()
        except Exception:
            err = None
        if err:
            snap["native_build_error"] = err
        return snap

    def emit(self, event: str, **kw) -> None:
        if self.stream is not None:
            # "ts" is the wall clock: elapsed_s alone cannot merge
            # multi-host/sharded JSONL streams onto a common timeline
            rec = {"event": event, "ts": round(time.time(), 6),
                   **self.snapshot(), **kw}
            with self._emit_lock:
                if self.stream is None:  # closed under our feet
                    return
                self.stream.write(json.dumps(rec) + "\n")
                self.stream.flush()

    def close_stream(self) -> None:
        """Close the metrics stream WITHOUT emitting a final event —
        the drivers' early-exit error paths (stream/writer open
        failed): a run that never started must not leave a 'final'
        record, but must not leak the open file either."""
        if self.stream is not None and self.stream not in (sys.stdout,
                                                           sys.stderr):
            with self._emit_lock:
                try:
                    self.stream.close()
                except OSError:
                    pass
                self.stream = None

    def report(self) -> None:
        if self.verbose:
            print(f"[ccsx-tpu-torch] {json.dumps(self.snapshot())}",
                  file=sys.stderr)
        # final carries the resource gauges (peak RSS, device buffers):
        # sampled once at close rather than in snapshot() — the
        # live-array census is not cheap enough for every event
        self.emit("final", **resource_gauges())
        if self.stream is not None and self.stream not in (sys.stdout,
                                                           sys.stderr):
            with self._emit_lock:
                try:
                    self.stream.close()
                except OSError:
                    pass
                self.stream = None
