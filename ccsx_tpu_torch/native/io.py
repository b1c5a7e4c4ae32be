"""ctypes wrappers over the native IO library.

Same Python-facing types as the fallback parsers (FastxRecord, Zmw), so the
pipeline can switch between paths transparently.  The native streamer does
the record parse, group-by-hole, and count/length filters in C++
(seqio.h:152-201, main.c:659-672 semantics); the rare hole-exclusion check
(-X) stays here.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional

import numpy as np

from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.io.corruption import CorruptionError
from ccsx_tpu_torch.io.fastx import FastxRecord
from ccsx_tpu_torch.io.zmw import InvalidZmwName, Zmw
from ccsx_tpu_torch import native
from ccsx_tpu_torch.utils import trace


class NativeStreamError(CorruptionError):
    """Stream error surfaced by the native reader, carrying the stable
    taxonomy code the C++ side classified it with (io/corruption.py)."""

    def __init__(self, msg: str, reason: str = "bam_bad_record"):
        super().__init__(reason or "bam_bad_record", msg)


def salvage_supported() -> bool:
    """True when the loaded native library exports the salvage entry
    points (a stale prebuilt .so degrades to the Python salvage
    readers, never to a load failure)."""
    L = native.lib()
    return L is not None and hasattr(L, "ccsx_set_salvage") \
        and hasattr(L, "ccsx_prefetch_open_s")


def _reason(L, h, fn_name: str) -> str:
    fn = getattr(L, fn_name, None)
    if fn is None:
        return ""
    val = fn(h)
    return val.decode() if val else ""


def _open(path: str, is_bam: bool):
    L = native.lib()
    if L is None:
        raise RuntimeError("native IO library unavailable")
    h = L.ccsx_open(path.encode(), 1 if is_bam else 0)
    if not h:
        raise OSError(f"cannot open {path!r}")
    return L, h


def read_records_native(path: str, is_bam: bool) -> Iterator[FastxRecord]:
    """Record-level stream (FASTA/Q or BAM) through the native parser."""
    L, h = _open(path, is_bam)
    c = ctypes
    name, comment = c.c_char_p(), c.c_char_p()
    seq, qual = c.POINTER(c.c_uint8)(), c.POINTER(c.c_uint8)()
    seq_len, qual_len = c.c_int64(), c.c_int64()
    try:
        while True:
            rc = L.ccsx_next_record(h, c.byref(name), c.byref(comment),
                                    c.byref(seq), c.byref(seq_len),
                                    c.byref(qual), c.byref(qual_len))
            if rc == 0:
                return
            if rc < 0:
                raise NativeStreamError(L.ccsx_error(h).decode())
            s = c.string_at(seq, seq_len.value)
            q = (c.string_at(qual, qual_len.value)
                 if qual_len.value >= 0 else None)
            yield FastxRecord(
                name=name.value.decode(),
                comment=comment.value.decode(),
                seq=s, qual=q)
    finally:
        L.ccsx_close(h)


def stream_zmws_native(path: str, cfg: CcsConfig,
                       metrics=None) -> Iterator[Zmw]:
    """Filtered ZMW stream through the native group-by-hole streamer.

    Opens eagerly — a bad path raises OSError here, not at first next().
    """
    L, h = _open(path, cfg.is_bam)
    L.ccsx_set_filter(h, cfg.min_pass_count, cfg.min_subread_len,
                      cfg.max_subread_len)
    if hasattr(L, "ccsx_set_salvage"):
        # the --max-record-bytes allocation bound applies salvage ON OR
        # OFF; on=1 additionally enables the resync behavior
        L.ccsx_set_salvage(h, 1 if getattr(cfg, "salvage", False) else 0,
                           getattr(cfg, "max_record_bytes", 0) or 0)
    return _zmw_gen(h, cfg, L.ccsx_next_zmw, L.ccsx_error, L.ccsx_close,
                    counts_fn=getattr(L, "ccsx_filter_counts", None),
                    metrics=metrics, reason_fn_name="ccsx_error_reason",
                    corrupt_fns=("ccsx_corrupt_events",
                                 "ccsx_corrupt_summary"))


def _surface_filter_counts(h, counts_fn, excluded: int, metrics) -> None:
    """At stream EOF, fold the native reader's in-library filter counts
    (plus the Python-side -X exclusions) into Metrics — the native path
    used to report nothing, silently under-reporting filtering in every
    traced native run (the span-table blind spot ARCHITECTURE.md
    documents).  A zero-filter stream books nothing."""
    buckets = {}
    if counts_fn is not None:
        few = ctypes.c_int64()
        short = ctypes.c_int64()
        long_ = ctypes.c_int64()
        counts_fn(h, ctypes.byref(few), ctypes.byref(short),
                  ctypes.byref(long_))
        buckets = {"few_passes": few.value, "too_short": short.value,
                   "too_long": long_.value}
    if excluded:
        buckets["excluded"] = excluded
    buckets = {k: v for k, v in buckets.items() if v}
    if not buckets:
        return
    total = sum(buckets.values())
    if metrics is not None:
        metrics.holes_filtered += total
        for k, v in buckets.items():
            metrics.filtered_reasons[k] = (
                metrics.filtered_reasons.get(k, 0) + v)
    # one aggregate instant (the native reader has no per-hole
    # identity to report), so a trace of a native run still shows that
    # — and why — holes were dropped
    trace.instant("zmw_filtered_native", cat="ingest", holes=total,
                  **buckets)


def _surface_corrupt_counts(L, h, summary_fn_name: str, metrics,
                            prebooked: dict) -> None:
    """At stream EOF, fold the native salvage accounting's per-reason
    buckets into Metrics (the live event total was already polled per
    yield — the full reason breakdown waits for EOF, where the C side
    can summarize it race-free).  ``prebooked`` holds reasons already
    booked live (the budget-exempt ones, polled via their own atomic so
    --max-failed-holes math stays exact mid-stream) — subtracted here
    so they are not double-counted."""
    summary = _reason(L, h, summary_fn_name)
    if not summary or metrics is None:
        return
    with metrics._count_lock:
        for item in summary.split(","):
            reason, _, count = item.partition(":")
            if reason and count:
                n = int(count) - prebooked.get(reason, 0)
                if n:
                    metrics.corrupt_reasons[reason] = (
                        metrics.corrupt_reasons.get(reason, 0) + n)


def _zmw_gen(h, cfg: CcsConfig, next_fn, error_fn, close_fn,
             counts_fn=None, metrics=None, reason_fn_name="",
             corrupt_fns=(None, None)) -> Iterator[Zmw]:
    """Shared drain loop for both native streamers (plain and prefetching)."""
    c = ctypes
    L = native.lib()
    movie, hole = c.c_char_p(), c.c_char_p()
    seqs = c.POINTER(c.c_uint8)()
    total = c.c_int64()
    lens = c.POINTER(c.c_int32)()
    n = c.c_int32()
    excluded = 0
    events_fn = getattr(L, corrupt_fns[0], None) \
        if getattr(cfg, "salvage", False) and corrupt_fns[0] else None
    exempt_fn = getattr(L, corrupt_fns[0].replace("_events", "_exempt"),
                        None) if events_fn is not None else None
    corrupt_seen = 0
    exempt_seen = 0

    def poll_corrupt():
        # live salvage accounting: the event total is an atomic the C
        # side bumps as it classifies; full per-reason buckets land at
        # EOF.  Budget-EXEMPT events (bgzf_missing_eof) ride their own
        # atomic and are booked into corrupt_reasons immediately, so a
        # --max-failed-holes check on holes yielded after the event
        # cannot misread a zero-loss degradation as a lost hole
        nonlocal corrupt_seen, exempt_seen
        if events_fn is None:
            return
        ev = int(events_fn(h))
        ex = int(exempt_fn(h)) if exempt_fn is not None else 0
        if ev > corrupt_seen:
            if metrics is not None:
                metrics.bump(holes_corrupt=ev - corrupt_seen)
                if ex > exempt_seen:
                    with metrics._count_lock:
                        metrics.corrupt_reasons["bgzf_missing_eof"] = (
                            metrics.corrupt_reasons.get(
                                "bgzf_missing_eof", 0)
                            + (ex - exempt_seen))
                if not metrics.degraded:
                    metrics.degraded = "input corruption (salvaged)"
            corrupt_seen = ev
            exempt_seen = max(exempt_seen, ex)
    try:
        while True:
            rc = next_fn(h, c.byref(movie), c.byref(hole),
                         c.byref(seqs), c.byref(total),
                         c.byref(lens), c.byref(n))
            poll_corrupt()
            if rc == -1:
                _surface_filter_counts(h, counts_fn, excluded, metrics)
                if events_fn is not None and corrupt_fns[1]:
                    _surface_corrupt_counts(
                        L, h, corrupt_fns[1], metrics,
                        {"bgzf_missing_eof": exempt_seen})
                return
            if rc == -2:
                raise InvalidZmwName(error_fn(h).decode())
            if rc < 0:
                raise NativeStreamError(error_fn(h).decode(),
                                        _reason(L, h, reason_fn_name))
            hole_s = hole.value.decode()
            if cfg.exclude_holes and hole_s in cfg.exclude_holes:
                excluded += 1
                continue
            lens_np = np.ctypeslib.as_array(lens, shape=(n.value,)).copy()
            offs = np.zeros(n.value, dtype=np.int32)
            if n.value > 1:
                np.cumsum(lens_np[:-1], out=offs[1:])
            yield Zmw(
                movie=movie.value.decode(), hole=hole_s,
                seqs=c.string_at(seqs, total.value),
                lens=lens_np, offs=offs)
    finally:
        close_fn(h)


def stream_zmws_prefetch(path: str, cfg: CcsConfig,
                         queue_cap: int = 64,
                         metrics=None) -> Iterator[Zmw]:
    """Like stream_zmws_native, but parsing/grouping/filtering run on a
    background C++ thread feeding a bounded queue — the native read step of
    the 3-stage pipeline (kt_pipeline step 0, kthread.c:172-256).

    Opens eagerly — a bad path raises OSError here, not at first next().
    """
    L = native.lib()
    if L is None:
        raise RuntimeError("native IO library unavailable")
    if hasattr(L, "ccsx_prefetch_open_s"):
        # the salvage-capable open also carries the --max-record-bytes
        # bound, which applies salvage on or off
        h = L.ccsx_prefetch_open_s(
            path.encode(), 1 if cfg.is_bam else 0, cfg.min_pass_count,
            cfg.min_subread_len, cfg.max_subread_len, queue_cap,
            1 if getattr(cfg, "salvage", False) else 0,
            getattr(cfg, "max_record_bytes", 0) or 0)
    else:
        h = L.ccsx_prefetch_open(path.encode(), 1 if cfg.is_bam else 0,
                                 cfg.min_pass_count, cfg.min_subread_len,
                                 cfg.max_subread_len, queue_cap)
    if not h:
        raise OSError(f"cannot open {path!r}")
    return _zmw_gen(h, cfg, L.ccsx_prefetch_next, L.ccsx_prefetch_error,
                    L.ccsx_prefetch_close,
                    counts_fn=getattr(L, "ccsx_prefetch_filter_counts",
                                      None),
                    metrics=metrics,
                    reason_fn_name="ccsx_prefetch_error_reason",
                    corrupt_fns=("ccsx_prefetch_corrupt_events",
                                 "ccsx_prefetch_corrupt_summary"))


class NativeFastaWriter:
    """Async ordered FASTA writer: fwrite runs on a C++ thread off the GIL.

    Records appear in put() order (single consumer thread drains a FIFO),
    matching the reference's ordered write step (main.c:707-718).
    """

    def __init__(self, path: str, append: bool = False):
        L = native.lib()
        if L is None:
            raise RuntimeError("native IO library unavailable")
        self._L = L
        self._h = L.ccsx_writer_open(path.encode(), 1 if append else 0)
        if not self._h:
            raise OSError(f"cannot open {path!r} for write")

    def put(self, name: str, seq: bytes, qual: bytes | None = None) -> None:
        """FASTA record, or FASTQ when ``qual`` (phred+33 ASCII, same
        length as seq) is given."""
        if not self._h:
            raise ValueError("writer is closed")
        if qual is not None and len(qual) != len(seq):
            # the C side appends len(qual) bytes from BOTH buffers; a
            # mismatch must fail here, not as a native over-read
            raise ValueError(
                f"qual length {len(qual)} != seq length {len(seq)}")
        if qual is None:
            rc = self._L.ccsx_writer_put_fasta(
                self._h, name.encode(),
                ctypes.cast(ctypes.c_char_p(seq),
                            ctypes.POINTER(ctypes.c_uint8)), len(seq))
        else:
            rc = self._L.ccsx_writer_put_fastq(
                self._h, name.encode(),
                ctypes.cast(ctypes.c_char_p(seq),
                            ctypes.POINTER(ctypes.c_uint8)),
                ctypes.cast(ctypes.c_char_p(qual),
                            ctypes.POINTER(ctypes.c_uint8)), len(qual))
        if rc != 0:
            raise OSError("write failed")

    def close(self) -> None:
        if self._h:
            rc = self._L.ccsx_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError("write failed")


def encode_native(seq: bytes) -> Optional[np.ndarray]:
    L = native.lib()
    if L is None:
        return None
    n = len(seq)
    out = np.empty(n, dtype=np.uint8)
    L.ccsx_encode(
        ctypes.cast(ctypes.c_char_p(seq), ctypes.POINTER(ctypes.c_uint8)),
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def revcomp_codes_native(codes: np.ndarray) -> Optional[np.ndarray]:
    L = native.lib()
    if L is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty(len(codes), dtype=np.uint8)
    L.ccsx_revcomp_codes(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(codes), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out
