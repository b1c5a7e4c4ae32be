"""One run: input stream -> consensus -> ordered FASTA output.

``run_pipeline`` opens the input and the output and hands them to one of
two drivers: the batched packed driver (pipeline/batch.py, the default on
the card) or the per-hole driver below, where a bounded thread pool (-j)
computes holes concurrently while the writer drains futures strictly in
submission order.  Either way the output is ``>movie/hole/ccs`` in input
order.  A hole whose consensus raises is quarantined: it is reported and
skipped, and the run goes on.  A fault of the card or of a kernel is not a
bad hole: it ends the run with RC_FATAL (on the card, the kernels are built
before the first hole for the same reason).
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
from ccsx_tpu_torch.utils.device import resolve_device


def open_zmw_stream(path: str, cfg: CcsConfig):
    """Filtered ZMW iterator for BAM or FASTA/Q input ('-' = stdin).
    Opens the file eagerly, so an unreadable path fails here."""
    if cfg.is_bam:
        if path == "-":
            records = bam_mod.read_bam_records(sys.stdin.buffer)
        else:
            open(path, "rb").close()
            records = bam_mod.read_bam_records(path)
    else:
        f = sys.stdin.buffer if path == "-" else open(path, "rb")
        records = fastx.read_fastx(f)
    return zmw.stream_zmws(records, cfg)


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
                   counts: dict) -> None:
    """The per-hole driver over an open ZMW stream and writer (--batch
    off): a bounded pool of -j threads, results drained in input order.  A
    hole's own error is quarantined; a kernel or card fault raises
    cuda_ext.KernelError."""
    aligner = HostAligner(cfg.align, device=device)

    def compute(z):
        stats: dict = {}
        try:
            return z, ccs_hole(z, aligner, cfg, stats), None, stats
        except Exception as e:  # quarantine: one bad hole must not kill the run
            if device.type == "cuda" and cuda_ext.is_device_fault(e):
                if isinstance(e, cuda_ext.KernelError):
                    raise
                raise cuda_ext.KernelError(str(e)) from e
            return z, None, e, stats

    def write_result(item):
        z, rec, err, stats = item
        counts["windows"] += stats.get("windows", 0)
        if err is not None:
            counts["failed"] += 1
            print(f"[ccsx-tpu-torch] hole {z.movie}/{z.hole} failed: {err}",
                  file=sys.stderr)
        elif rec is not None and rec[0]:
            writer.put(f"{z.movie}/{z.hole}/ccs", rec[0], rec[1])
            counts["out"] += 1

    pool = ThreadPoolExecutor(max_workers=cfg.threads) \
        if cfg.threads > 1 else None
    pending = collections.deque()
    try:
        for z in stream:
            counts["in"] += 1
            if pool is None:
                write_result(compute(z))
                continue
            pending.append(pool.submit(compute, z))
            # bounded window keeps memory flat; drain in order
            while len(pending) > 2 * cfg.threads:
                write_result(pending.popleft().result())
        while pending:
            write_result(pending.popleft().result())
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


def run_pipeline(in_path: str, out_path: str, cfg: CcsConfig,
                 batch: str = "auto", inflight: int | None = None) -> int:
    """One run end to end.  ``batch``: 'on' runs the batched packed driver
    (pipeline/batch.py), 'off' the per-hole driver, 'auto' the batched one
    on the card and the per-hole one on the CPU.  ``inflight`` pins the
    batched driver's admission window."""
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
    try:
        stream = open_zmw_stream(in_path, cfg)
    except OSError as e:
        print(f"Error: Failed to open infile! ({e})", file=sys.stderr)
        return exitcodes.RC_FATAL
    try:
        writer = _Writer(out_path)
    except OSError as e:
        print(f"Cannot open file for write! ({e})", file=sys.stderr)
        return exitcodes.RC_FATAL
    counts = {"in": 0, "out": 0, "failed": 0, "windows": 0}
    rc = exitcodes.RC_OK
    try:
        if batched:
            from ccsx_tpu_torch.pipeline import batch as batch_mod

            batch_mod.drive_batched(stream, writer, cfg, device, counts,
                                    inflight)
        else:
            drive_per_hole(stream, writer, cfg, device, counts)
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
    if counts.get("failed_steps") and not cfg.verbose:
        # a batched step that failed over is a fault to see, verbose or not
        print(f"[ccsx-tpu-torch] failed_steps={counts['failed_steps']} "
              f"host_replays={counts['host_replays']}: batched device steps "
              "failed and their requests ran on the per-hole round",
              file=sys.stderr)
    if cfg.verbose:
        extra = " ".join(f"{k}={v}" for k, v in counts.items()
                         if k not in ("in", "out", "failed", "windows"))
        print(f"[ccsx-tpu-torch] holes in={counts['in']} out={counts['out']} "
              f"failed={counts['failed']} windows={counts['windows']} "
              f"driver={'batched' if batched else 'per-hole'} "
              f"device={device}" + (f" {extra}" if extra else ""),
              file=sys.stderr)
    return rc
