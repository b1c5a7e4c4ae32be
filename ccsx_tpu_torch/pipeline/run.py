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
"""

from __future__ import annotations

import collections
import sys
from concurrent.futures import ThreadPoolExecutor

from ccsx_tpu_torch import exitcodes
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.consensus.align_host import HostAligner
from ccsx_tpu_torch.consensus.hole import ccs_hole
from ccsx_tpu_torch.io import bam as bam_mod
from ccsx_tpu_torch.io import fastx, zmw
from ccsx_tpu_torch.ops import cuda_ext
from ccsx_tpu_torch.utils import trace
from ccsx_tpu_torch.utils.device import resolve_device
from ccsx_tpu_torch.utils.metrics import (FailureBudgetExceeded,
                                          check_failure_budget)
from ccsx_tpu_torch.utils.run_metrics import RunMetrics


def open_zmw_stream(path: str, cfg: CcsConfig, metrics=None):
    """Filtered ZMW iterator for BAM or FASTA/Q input ('-' = stdin).
    Opens the file eagerly, so an unreadable path fails here.  ``metrics``
    receives the filtered-hole accounting."""
    if cfg.is_bam:
        if path == "-":
            records = bam_mod.read_bam_records(sys.stdin.buffer)
        else:
            open(path, "rb").close()
            records = bam_mod.read_bam_records(path)
    else:
        f = sys.stdin.buffer if path == "-" else open(path, "rb")
        records = fastx.read_fastx(f)
    return zmw.stream_zmws(records, cfg, metrics=metrics)


class _Writer:
    """FASTA/FASTQ writer over a file object (UTF-8, like the reference's)."""

    def __init__(self, path: str):
        self._own = path != "-"
        self._f = (open(path, "w", encoding="utf-8") if self._own
                   else sys.stdout)

    def put(self, name: str, seq: bytes, qual: bytes | None = None) -> None:
        rec, _ = fastx.format_record(name, seq, qual)
        self._f.write(rec)

    def close(self) -> None:
        if self._own:
            self._f.close()
        else:
            self._f.flush()


def drive_per_hole(stream, writer, cfg: CcsConfig, device,
                   metrics: RunMetrics) -> None:
    """The per-hole driver over an open ZMW stream and writer (--batch
    off): a bounded pool of -j threads, results drained in input order.  A
    hole's own error is quarantined; a kernel or card fault raises
    cuda_ext.KernelError, and a count-form --max-failed-holes exceeded at a
    failed hole raises FailureBudgetExceeded."""
    aligner = HostAligner(cfg.align, device=device)

    def compute(z):
        stats: dict = {}
        try:
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
            except StopIteration:
                break
            metrics.holes_in += 1
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


def run_pipeline(in_path: str, out_path: str, cfg: CcsConfig,
                 batch: str = "auto", inflight: int | None = None) -> int:
    """One run end to end.  ``batch``: 'on' runs the batched packed driver
    (pipeline/batch.py), 'off' the per-hole driver, 'auto' the batched one
    on the card and the per-hole one on the CPU.  ``inflight`` pins the
    batched driver's admission window.

    The run owns the Metrics (``--metrics``: JSONL events, the final one
    at the end whatever the exit path) and the Tracer (``--trace``,
    ``--stall-timeout``), installed for the run.  rc 1: no card, a kernel
    that cannot build, an unreadable input, an unwritable output or trace
    path, an invalid input stream, a device fault; rc 2: the
    ``--max-failed-holes`` budget was exceeded."""
    try:
        device = resolve_device(cfg.device)
    except RuntimeError as e:
        print(f"Error: {e}", file=sys.stderr)
        return exitcodes.RC_FATAL
    batched = batch == "on" or (batch == "auto" and device.type == "cuda")
    if device.type == "cuda":
        # both drivers: a kernel that cannot build ends the run before
        # the first hole
        try:
            cuda_ext.load_all()
        except (cuda_ext.KernelError, OSError) as e:
            print(f"Error: the CUDA kernels cannot be loaded: {e}",
                  file=sys.stderr)
            return exitcodes.RC_FATAL
    # constructed before the stream, which books its filtered holes here
    metrics = RunMetrics(verbose=cfg.verbose, stream=cfg.metrics_stream())
    try:
        stream = open_zmw_stream(in_path, cfg, metrics)
    except OSError as e:
        print(f"Error: Failed to open infile! ({e})", file=sys.stderr)
        metrics.close_stream()  # no final event for a non-run
        return exitcodes.RC_FATAL
    try:
        writer = _Writer(out_path)
    except OSError as e:
        print(f"Cannot open file for write! ({e})", file=sys.stderr)
        metrics.close_stream()
        return exitcodes.RC_FATAL
    rc = exitcodes.RC_OK
    # the flight recorder: constructed inside the try, so neither its
    # watchdog thread nor its file can leak, and an unwritable --trace
    # path is refused like an unwritable output path
    tracer = None
    try:
        try:
            tracer = trace.Tracer(cfg.trace_path,
                                  stall_timeout=cfg.stall_timeout_s,
                                  metrics=metrics)
        except OSError as e:
            print(f"Cannot open trace file for write! ({e})",
                  file=sys.stderr)
            return exitcodes.RC_FATAL
        trace.install(tracer)
        if batched:
            from ccsx_tpu_torch.pipeline import batch as batch_mod

            batch_mod.drive_batched(stream, writer, cfg, device, metrics,
                                    inflight)
        else:
            drive_per_hole(stream, writer, cfg, device, metrics)
        # a fraction-form --max-failed-holes settles at the end, when the
        # processed-hole denominator is final
        check_failure_budget(metrics, cfg, final=True)
    except FailureBudgetExceeded as e:
        print(f"Error: {e}; aborting instead of emitting a degraded output "
              "at rc 0", file=sys.stderr)
        rc = exitcodes.RC_FAILED_HOLES
    except cuda_ext.KernelError as e:
        print(f"Error: device failure, run aborted: {e}", file=sys.stderr)
        rc = exitcodes.RC_FATAL
    except (bam_mod.BamError, zmw.InvalidZmwName, ValueError) as e:
        print(f"Error: invalid input stream: {e}", file=sys.stderr)
        rc = exitcodes.RC_FATAL
    except OSError as e:
        print(f"Error: write failed: {e}", file=sys.stderr)
        rc = exitcodes.RC_FATAL
    finally:
        try:
            writer.close()
        except OSError as e:
            print(f"Error: write failed! ({e})", file=sys.stderr)
            rc = exitcodes.RC_FATAL
        # the watchdog stops and the trace is exported before the final
        # metrics event, so a degraded mark set mid-run is in it
        trace.uninstall()
        if tracer is not None:
            tracer.close()
        metrics.report()
    if metrics.failed_steps and not cfg.verbose:
        # a batched step that failed over is a fault to see, verbose or not
        print(f"[ccsx-tpu-torch] failed_steps={metrics.failed_steps} "
              f"host_fallbacks={metrics.host_fallbacks}: batched device "
              "steps failed and their requests ran on the per-hole round",
              file=sys.stderr)
    return rc
