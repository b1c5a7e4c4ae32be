"""One run: input stream -> consensus -> ordered FASTA output.

``run_pipeline`` opens the input and the output and hands them to one of
two drivers: the batched packed driver (pipeline/batch.py, the default on
the card) or the per-hole driver below, where a bounded thread pool (-j)
computes holes concurrently while the writer drains futures strictly in
submission order.  Either way the output is ``>movie/hole/ccs`` in input
order.  A hole whose consensus raises is quarantined: it is reported and
skipped, and the run goes on, up to the ``--max-failed-holes`` budget, past
which it ends with RC_FAILED_HOLES.  A fault of the card or of a kernel is
not a bad hole: it ends the run with RC_FATAL (on the card, the kernels are
built before the first hole for the same reason).

Host planes, the JAX package's at its places: the native C++ reader
(native/, a prefetch thread that parses, groups and filters) serves every
real input path while its library loads, and the Python readers serve
stdin and the fallback; the native async writer serves a real output path
of a run that is not journaled, ``--bam`` the BAM writer.

Crash safety, the JAX package's planes at its places: ``--journal`` resumes
a killed run to the same bytes (utils/journal.py; the writer is
synchronous and counts its bytes), SIGTERM/SIGINT drain it to
RC_INTERRUPTED (utils/drain.py, polled by ``guarded_stream``), and
``--salvage`` books classified input corruption and reads on
(io/corruption.py).  ``--inject-faults`` (utils/faultinject.py) fires each
recovery on a deterministic schedule.
"""

from __future__ import annotations

import collections
import gzip
import os
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

from ccsx_tpu_torch import exitcodes
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.consensus.align_host import HostAligner
from ccsx_tpu_torch.consensus.hole import ccs_hole
from ccsx_tpu_torch.io import bam as bam_mod
from ccsx_tpu_torch.io import fastx, zmw
from ccsx_tpu_torch.io.corruption import CorruptionError, SalvageSink
from ccsx_tpu_torch.ops import cuda_ext
from ccsx_tpu_torch.utils import capture, faultinject, trace
from ccsx_tpu_torch.utils.device import resolve_device
from ccsx_tpu_torch.utils.drain import DrainGuard
from ccsx_tpu_torch.utils.journal import Journal
from ccsx_tpu_torch.utils.metrics import (FailureBudgetExceeded,
                                          check_failure_budget)
from ccsx_tpu_torch.utils.run_metrics import RunMetrics


def open_zmw_stream(path: str, cfg: CcsConfig, metrics=None):
    """Filtered ZMW iterator for BAM or FASTA/Q input ('-' = stdin).

    Uses the native C++ streamer (parser + group-by-hole + filters in one
    pass on a prefetch thread, ccsx_tpu_torch/native) when the library is
    available and the input is a real path; otherwise the pure-Python
    parsers.  Opens the file eagerly, so an unreadable path fails here.
    ``metrics`` receives the filtered-hole accounting from either path:
    per-hole live on the Python path, reason-bucketed at EOF from the
    native reader.

    ``cfg.salvage`` selects salvage-mode ingest on whichever stack serves:
    classified corruption is booked into Metrics (holes_corrupt +
    corrupt_reasons + the degraded mark) and resynced past instead of
    killing the stream (io/corruption.py)."""
    from ccsx_tpu_torch import native

    if path != "-" and native.available():
        from ccsx_tpu_torch.native.io import (salvage_supported,
                                              stream_zmws_prefetch)

        if not cfg.salvage or salvage_supported():
            return stream_zmws_prefetch(path, cfg, metrics=metrics)
        # a library without the salvage entry points: fall through to the
        # pure-Python salvage readers
    sink = SalvageSink(metrics, cfg.max_record_bytes) if cfg.salvage \
        else None
    if cfg.is_bam:
        if path == "-":
            records = bam_mod.read_bam_records(
                sys.stdin.buffer, salvage=sink,
                max_record_bytes=cfg.max_record_bytes)
        else:
            open(path, "rb").close()
            records = bam_mod.read_bam_records(
                path, salvage=sink, max_record_bytes=cfg.max_record_bytes)
    else:
        f = sys.stdin.buffer if path == "-" else open(path, "rb")
        records = fastx.read_fastx(f, salvage=sink)
    return zmw.stream_zmws(records, cfg, metrics=metrics, salvage=sink)


def guarded_stream(stream, cfg: CcsConfig, metrics, guard=None):
    """The drivers' shared ingest guard, wrapped around an open ZMW stream:

    * graceful drain: once ``guard.requested`` (SIGTERM/SIGINT,
      utils/drain.py) the stream reports exhausted — admission stops,
      in-flight work finishes, and the run exits RC_INTERRUPTED;
    * the ``input_corrupt`` fault point (utils/faultinject.py): with
      --salvage the injected corruption drops that one hole and the
      stream CONTINUES; without it, the clean rc-1 path;
    * the salvage rung for classified corruption raised by the stream
      itself: with --salvage the event is booked and the stream ENDS
      there (a generator that raised is closed).  The salvage-mode
      readers resync internally and never raise here;
    * an absolute --max-failed-holes budget is re-checked per admitted
      hole, so reader-booked corruption events abort the ingest promptly.
    """
    sink = SalvageSink(metrics) if cfg.salvage else None
    it = iter(stream)
    while True:
        if guard is not None and guard.requested:
            return
        try:
            z = next(it)
        except StopIteration:
            return
        except CorruptionError as e:
            if sink is None:
                raise
            sink.record(e.reason)
            print(f"[ccsx-tpu-torch] salvage: classified corruption from "
                  f"the stream ({e.reason}: {e}); ending ingestion — "
                  "emitting what was salvaged", file=sys.stderr)
            return
        try:
            faultinject.fire("input_corrupt")
        except CorruptionError as e:
            if sink is None:
                raise
            sink.record(e.reason)
            print(f"[ccsx-tpu-torch] salvage: dropped corrupt input unit "
                  f"({e.reason}: {e})", file=sys.stderr)
            continue
        # count-form budgets abort mid-ingest (fractions settle at end
        # of run where the denominator is final)
        check_failure_budget(metrics, cfg)
        yield z


def count_raw_holes(in_path: str, cfg: CcsConfig) -> int:
    """RAW hole count of the input — the fleet scheduler's range-table
    denominator (pipeline/fleet.py).  BAM inputs use (or build) the
    BGZF hole index sidecar; FASTA/Q inputs take one name-only counting
    pass using the same consecutive-(movie,hole) keying as the sharded
    BAM indexer, so range-table ordinals always line up with what
    ``slice_raw_holes`` streams."""
    from ccsx_tpu_torch.io import bamindex

    if cfg.is_bam:
        idx = bamindex.load_index(in_path) or bamindex.build_index(
            in_path,
            max_record_bytes=getattr(cfg, "max_record_bytes", 0))
        return idx["n_holes"]
    n = 0
    prev = None
    with open(in_path, "rb") as f:
        for rec in fastx.read_fastx(f):
            key = bamindex._hole_key(rec.name)
            if key != prev:
                n += 1
                prev = key
    return n


def slice_raw_holes(records, lo: int, hi: int):
    """Pass through only the records of raw holes [lo, hi) — the
    FASTA/Q twin of bamindex.read_hole_range (which seeks; plain text
    cannot, so the lead-in is parsed and dropped).  Stops at hole hi,
    so a front range never pays for the file's tail."""
    from ccsx_tpu_torch.io import bamindex

    if lo >= hi:
        return
    seen = -1
    prev = None
    for rec in records:
        key = bamindex._hole_key(rec.name)
        if key != prev:
            seen += 1
            prev = key
            if seen >= hi:
                return
        if seen >= lo:
            yield rec


def holes_total_hint(in_path: str, cfg: CcsConfig):
    """RAW hole count of the input when cheaply knowable (the BGZF hole
    index sidecar, ``ccsx-tpu-torch --make-index``), else None: the
    progress/ETA estimator's total (Metrics.holes_total).  Raw holes:
    filtered holes count toward progress ``done``, so the basis
    matches."""
    if not cfg.is_bam or in_path == "-" or not os.path.exists(in_path):
        return None
    try:
        from ccsx_tpu_torch.io import bamindex

        idx = bamindex.load_index(in_path)
    except (OSError, ValueError):
        return None
    return idx["n_holes"] if idx else None


class _PyWriter:
    """FASTA/FASTQ writer over a file object (UTF-8, like the reference's).
    Tracks ``bytes_out`` — the exact output size after every record —
    which the journal records as its torn-tail recovery offset;
    fastx.format_record counts UTF-8-encoded bytes, not len(str)."""

    def __init__(self, f, own: bool, start_bytes: int = 0):
        self._f = f
        self._own = own
        self.bytes_out = start_bytes

    def put(self, name: str, seq: bytes, qual: bytes | None = None) -> None:
        # disk_full fault point (ENOSPC): fires BEFORE any bytes land, so
        # the journaled offset stays behind the durable output and a
        # resume recomputes the interrupted hole
        faultinject.fire("disk_full")
        rec, nbytes = fastx.format_record(name, seq, qual)
        self._f.write(rec)
        self.bytes_out += nbytes

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._own:
            self._f.close()
        else:
            self._f.flush()


def open_writer(path: str, append: bool, bam: bool = False,
                journaled: bool = False):
    """Async native writer for real paths; Python writer for stdout;
    buffered BAM writer under --bam.  ``append`` continues a journaled
    file from its current size.

    stdout stays Python-level so redirection works.  ``journaled`` runs
    also use the Python writer: the journal's crash contract needs a
    synchronous, flushable stream with byte accounting (the record must be
    durable before the journal cursor claims it), which the async native
    writer cannot order."""
    from ccsx_tpu_torch import native

    if bam:
        if path == "-":
            raise OSError("--bam output requires a file path, not stdout")
        if append:
            raise OSError("--bam output does not support --journal resume "
                          "(the BGZF container cannot be appended)")
        return bam_mod.BamWriter(path)
    if path != "-" and native.available() and not journaled:
        from ccsx_tpu_torch.native.io import NativeFastaWriter

        return NativeFastaWriter(path, append=append)
    if path == "-":
        return _PyWriter(sys.stdout, own=False)
    start = os.path.getsize(path) if append and os.path.exists(path) else 0
    # UTF-8 pinned (not the locale default) so bytes_out's encode-based
    # accounting always matches what reaches the file
    return _PyWriter(open(path, "a" if append else "w", encoding="utf-8"),
                     own=True, start_bytes=start)


def drive_per_hole(stream, writer, cfg: CcsConfig, device,
                   metrics: RunMetrics, journal: Journal) -> None:
    """The per-hole driver over an open ZMW stream and writer (--batch
    off): a bounded pool of -j threads, results drained in input order.  A
    hole's own error is quarantined; a kernel or card fault raises
    cuda_ext.KernelError, and a count-form --max-failed-holes exceeded at a
    failed hole raises FailureBudgetExceeded.  The first
    ``journal.holes_done`` holes were written by an earlier run and are
    skipped; each retired hole advances the journal."""
    aligner = HostAligner(cfg.align, device=device)
    resume = journal.holes_done

    def compute(z):
        stats: dict = {}
        try:
            faultinject.fire("compute")
            with trace.span("hole_compute", cat="compute", hole=str(z.hole)):
                return z, ccs_hole(z, aligner, cfg, stats), None, stats
        except Exception as e:  # quarantine: one bad hole must not kill the run
            if device.type == "cuda" and cuda_ext.is_device_fault(e):
                if isinstance(e, cuda_ext.KernelError):
                    raise
                raise cuda_ext.KernelError(str(e)) from e
            return z, None, e, stats

    def write_result(item):
        z, rec, err, stats = item
        # counted on the driver side, so worker threads never touch the
        # Metrics object; device_dispatches is the JAX package's lower
        # bound: each window runs >= 1 round of 3 device calls
        metrics.windows += stats.get("windows", 0)
        metrics.device_dispatches += 3 * stats.get("windows", 0)
        wrote = False
        with metrics.timer("write"), trace.span("write_record", cat="write"):
            if err is not None:
                metrics.holes_failed += 1
                print(f"[ccsx-tpu-torch] hole {z.movie}/{z.hole} failed: "
                      f"{err}", file=sys.stderr)
                # a count budget aborts here, a fraction at end of run
                check_failure_budget(metrics, cfg)
            elif rec is not None and rec[0]:
                writer.put(f"{z.movie}/{z.hole}/ccs", rec[0], rec[1])
                metrics.holes_out += 1
                wrote = True
        # flush-before-cursor + write fault point + advance
        journal.retire(writer, wrote, metrics)
        # a real SIGTERM at a retirement point: the drain, made
        # deterministic
        faultinject.fire("sigterm")
        metrics.tick()

    pool = ThreadPoolExecutor(max_workers=cfg.threads) \
        if cfg.threads > 1 else None
    pending = collections.deque()
    try:
        while True:
            try:
                with metrics.timer("ingest"), \
                        trace.span("ingest_hole", cat="ingest"):
                    z = next(stream)
                    faultinject.fire("ingest")
            except StopIteration:
                break
            metrics.holes_in += 1
            if metrics.holes_in <= resume:
                continue  # written by an earlier run
            metrics.heartbeat()
            if pool is None:
                with metrics.timer("compute"):
                    item = compute(z)
                write_result(item)
                continue
            pending.append(pool.submit(compute, z))
            # bounded window keeps memory flat; drain in order
            while len(pending) > 2 * cfg.threads:
                with metrics.timer("compute"):
                    item = pending.popleft().result()
                write_result(item)
        while pending:
            with metrics.timer("compute"):
                item = pending.popleft().result()
            write_result(item)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


def open_run_io(in_path: str, out_path: str, cfg: CcsConfig, metrics,
                journal_path: str | None):
    """A single-process run's input stream, journal and writer, opened in
    that order; None (after the message) when the input cannot be read or
    the output cannot be written.  The progress total comes from a fresh
    hole index of the input, where there is one."""
    metrics.holes_total = holes_total_hint(in_path, cfg)
    try:
        stream = open_zmw_stream(in_path, cfg, metrics)
    except (OSError, RuntimeError) as e:
        print(f"Error: Failed to open infile! ({e})", file=sys.stderr)
        return None
    # load under this run's fingerprint and reconcile the output tail
    # (truncate torn / refuse untrustworthy) before the writer opens
    journal = Journal.for_run(journal_path, in_path, cfg, out_path)
    try:
        writer = open_writer(out_path, append=bool(journal.holes_done),
                             bam=cfg.bam_out, journaled=bool(journal_path))
    except OSError as e:
        print(f"Cannot open file for write! ({e})", file=sys.stderr)
        return None
    return stream, journal, writer


def run_pipeline(in_path: str, out_path: str, cfg: CcsConfig,
                 batch: str = "auto", inflight: int | None = None,
                 journal_path: str | None = None, open_io=None,
                 metrics: RunMetrics | None = None, shared=None) -> int:
    """One run end to end.  ``batch``: 'on' runs the batched packed driver
    (pipeline/batch.py), 'off' the per-hole driver, 'auto' the batched one
    on the card and the per-hole one on the CPU.  ``inflight`` pins the
    batched driver's admission window.  ``journal_path`` (``--journal``)
    makes the run resumable: the holes it records as done are skipped and
    the output continues from its journaled size.  ``open_io(metrics)``
    opens the run's (stream, journal, writer), or returns None to end it
    at rc 1; the default is ``open_run_io``, and a sharded rank
    (parallel/distributed.py) and a fleet range (pipeline/fleet.py) pass
    their own.

    ``metrics``/``shared``: the serving plane (pipeline/serve.py) runs
    each job through this entry on a job thread, with the job's own
    RunMetrics and the server's runtime, duck-typed as in the JAX
    package's batched driver: ``guard`` (a utils/drain.FlagGuard the
    server raises on cancel, deadline or drain) replaces the signal
    handlers, which belong to the server's main thread; ``admission`` (a
    handle on the server's fair admission window) and ``warm`` (the
    server's warmup plane, or None) go to drive_batched.  With
    ``shared`` set the run installs no guard, no tracer and no telemetry
    (the server owns them), and a device fault is also left in
    ``shared.fault`` for the server, which stops on it.

    The run owns the Metrics (``--metrics``: JSONL events, the final one
    at the end whatever the exit path), the Tracer (``--trace``,
    ``--stall-timeout``), installed for the run, and the drain guard
    (SIGTERM/SIGINT); while torch.profiler records, also an in-memory
    span capture (utils/capture.py), left on ``metrics.capture``.  rc 1:
    no card, a kernel that cannot build, an unreadable input, an
    unwritable output or trace path, an invalid
    ``--mesh`` for a batched run, an invalid input stream, a failed write,
    a device fault; rc 2: the ``--max-failed-holes`` budget was exceeded;
    rc 75: drained by a signal, resumable with the same command.  ``cfg.telemetry_port`` serves the
    live endpoints (utils/telemetry.py) for the run's length; a port that
    cannot be bound is a warning, never a failed run."""
    try:
        device = resolve_device(cfg.device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return exitcodes.RC_FATAL
    batched = batch == "on" or (batch == "auto" and device.type == "cuda")
    if cfg.prep_threads and not batched:
        # the per-hole path already overlaps prep with compute through its
        # -j worker pool (each worker preps + computes whole holes); the
        # prep plane is a batched-scheduler construct
        print("[ccsx-tpu-torch] --prep-threads has no effect with --batch "
              "off (use -j; the per-hole path overlaps prep per worker)",
              file=sys.stderr)
    if device.type == "cuda":
        # both drivers: a kernel that cannot build ends the run before
        # the first hole
        try:
            cuda_ext.load_all()
        except (cuda_ext.KernelError, OSError) as e:
            print(f"Error: the CUDA kernels cannot be loaded: {e}",
                  file=sys.stderr)
            return exitcodes.RC_FATAL
    if batched:
        from ccsx_tpu_torch.pipeline import batch as batch_mod

        # a bad --mesh must not touch an existing output or shard file:
        # checked before open_io opens anything (a sharded rank's and a
        # fleet range's too, which come through here)
        if batch_mod.mesh_precheck(cfg, device):
            return exitcodes.RC_FATAL
    # constructed before the stream, which books its filtered holes here
    if metrics is None:
        metrics = RunMetrics(verbose=cfg.verbose,
                             stream=cfg.metrics_stream())
    if open_io is None:
        def open_io(m):
            return open_run_io(in_path, out_path, cfg, m, journal_path)
    opened = open_io(metrics)
    if opened is None:
        metrics.close_stream()  # no final event for a non-run
        return exitcodes.RC_FATAL
    stream, journal, writer = opened
    # restore the journaled failure count, so --max-failed-holes is judged
    # over the whole logical run, resumes included
    metrics.holes_failed = journal.holes_failed
    metrics.holes_prior_emitted = journal.holes_emitted
    rc = exitcodes.RC_OK
    # graceful drain (utils/drain.py): SIGTERM/SIGINT stop admission;
    # in-flight holes finish, writer and journal settle, rc 75 resumable.
    # Installed immediately before the try whose finally restores it; a
    # served job drains through its server's guard instead
    guard = getattr(shared, "guard", None) or DrainGuard.install()
    stream = guarded_stream(stream, cfg, metrics, guard)
    # the flight recorder: constructed inside the try, so neither its
    # watchdog thread nor its file can leak, and an unwritable --trace
    # path is refused like an unwritable output path
    tracer = None
    telem = None
    cap = None
    try:
        if shared is None:
            try:
                tracer = trace.Tracer(cfg.trace_path,
                                      stall_timeout=cfg.stall_timeout_s,
                                      metrics=metrics)
            except OSError as e:
                print(f"Cannot open trace file for write! ({e})",
                      file=sys.stderr)
                return exitcodes.RC_FATAL
            trace.install(tracer)
            if capture.profiling():
                # a profiled run keeps its spans in memory on the
                # profiler's host clock, so the card's idle gaps can be
                # named by the host phase they fall in
                cap = metrics.capture = capture.Capture().open()
            if cfg.telemetry_port:
                from ccsx_tpu_torch.utils import telemetry

                telem = telemetry.start(metrics, cfg.telemetry_port)
        if batched:
            batch_mod.drive_batched(
                stream, writer, cfg, device, metrics, journal, inflight,
                admission=getattr(shared, "admission", None),
                warm=getattr(shared, "warm", None))
        else:
            drive_per_hole(stream, writer, cfg, device, metrics, journal)
        # a fraction-form --max-failed-holes settles at the end, when the
        # processed-hole denominator is final — but not on a drain, whose
        # denominator is a partial run's
        if not guard.requested:
            check_failure_budget(metrics, cfg, final=True)
    except FailureBudgetExceeded as e:
        print(f"Error: {e}; aborting instead of emitting a degraded output "
              "at rc 0", file=sys.stderr)
        rc = exitcodes.RC_FAILED_HOLES
    except cuda_ext.KernelError as e:
        print(f"Error: device failure, run aborted: {e}", file=sys.stderr)
        rc = exitcodes.RC_FATAL
        if shared is not None:
            shared.fault = e
    except (bam_mod.BamError, zmw.InvalidZmwName, ValueError,
            # damaged gzip/BGZF under the fail-fast Python readers (the
            # native reader classifies these as NativeStreamError, a
            # ValueError); they serve stdin and a library that will not
            # build
            zlib.error, EOFError, gzip.BadGzipFile) as e:
        print(f"Error: invalid input stream: {e}", file=sys.stderr)
        rc = exitcodes.RC_FATAL
    except OSError as e:
        print(f"Error: write failed: {e}", file=sys.stderr)
        rc = exitcodes.RC_FATAL
    finally:
        guard.restore()
        try:
            writer.close()
        except OSError as e:
            print(f"Error: write failed! ({e})", file=sys.stderr)
            rc = exitcodes.RC_FATAL
        # settle the (possibly rate-limited) cursor AFTER the writer has
        # made the records durable
        journal.close()
        # the watchdog stops and the trace is exported before the final
        # metrics event, so a degraded mark set mid-run is in it.  A served
        # job leaves the server's tracer installed: its siblings record
        # into it
        if shared is None:
            trace.uninstall()
        if cap is not None:
            cap.close()
        if tracer is not None:
            tracer.close()
        # endpoints down before the final event: a scrape never sees a
        # half-closed Metrics object
        if telem is not None:
            telem.close()
        metrics.report()
    if metrics.failed_steps and not cfg.verbose:
        # a batched step that failed over is a fault to see, verbose or not
        print(f"[ccsx-tpu-torch] failed_steps={metrics.failed_steps} "
              f"host_fallbacks={metrics.host_fallbacks}: batched device "
              "steps failed and their requests ran on the per-hole round",
              file=sys.stderr)
    if rc == exitcodes.RC_OK and guard.requested:
        print("[ccsx-tpu-torch] drained cleanly; resume with the same "
              "command to continue", file=sys.stderr)
        rc = exitcodes.RC_INTERRUPTED
    return rc
