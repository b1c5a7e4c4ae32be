"""Sharded runs (a copy of the JAX package's parallel/distributed.py;
``run_pipeline_sharded`` goes through the port's run setup).

* control plane — with ``--coordinator host:port``, ``init_distributed``
  joins the ranks in one ``torch.distributed`` process group (gloo, over
  TCP) before they start, the counterpart of ``jax.distributed.initialize``:
  a rank that cannot rendezvous ends at rc 1 and writes nothing.  Nothing
  on the hot path uses the group (the ranks share nothing, and their
  meshes span their own cards, parallel/mesh.py); gloo, not NCCL, because
  no tensor crosses it and NCCL refuses two ranks on one card.  The group
  is destroyed when the rank's run ends.
* input sharding — every rank reads the same input stream and owns the
  holes with ``global_index % n == rank`` (round-robin over the
  *filtered* hole stream, so the assignment is a pure function of the
  input and needs no coordination).  ZMWs are independent, so the ranks
  exchange nothing.
* output — each rank writes ``<out>.shard<r>`` plus a sidecar index of
  the global hole ordinal per record; ``merge_shards`` restores the
  reference's input-ordered single FASTA exactly (kthread.c:202-213
  ordering invariant, across ranks).

For BGZF BAM inputs with a hole index sidecar (``--make-index``,
io/bamindex.py), sharded runs switch to byte-range ingest: each rank
inflates only its ~1/N of the compressed bytes and owns a contiguous
raw-hole range, with ordinal bookkeeping that keeps merge_shards' output
byte-identical (metrics.ingest_bytes records each mode's cost).  The
ranks are separate processes, so several can share one card.
"""

from __future__ import annotations

import heapq
import json
import os
import sys
from typing import Iterator, Optional

from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.io import fastx
from ccsx_tpu_torch.utils.journal import (Journal, write_json_atomic,
                                    write_json_exclusive)


# seconds a rank waits for the whole group at the rendezvous (the JAX
# package's initialize waits 300 s by default)
RENDEZVOUS_TIMEOUT_S = 300.0


class RendezvousError(RuntimeError):
    """The ranks' process group could not be formed."""


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> tuple:
    """Join this rank (``process_id`` of ``num_processes``) to the run's
    process group at ``coordinator`` (host:port; rank 0 serves the
    rendezvous there); returns (rank, world size).  RendezvousError when
    the group does not form within RENDEZVOUS_TIMEOUT_S."""
    import datetime

    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    except (RuntimeError, ValueError, OSError) as e:
        raise RendezvousError(
            f"rank {process_id} of {num_processes} could not rendezvous "
            f"at {coordinator}: {e}") from e
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed() -> None:
    """Destroy this process's group, if init_distributed made one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def shard_stream(stream, rank: int, n: int) -> Iterator:
    """Round-robin hole ownership: yields this rank's holes (the local
    ordinal k maps to global ordinal rank + k*n)."""
    for i, z in enumerate(stream):
        if i % n == rank:
            yield z


def shard_path(out_path: str, rank: int) -> str:
    return f"{out_path}.shard{rank}"


def done_path(out_path: str, rank: int) -> str:
    """Per-shard completion marker: written atomically by a rank that
    drained its stream cleanly; its absence is how merge_shards knows a
    shard DIED rather than merely produced few records (a silently
    short merge would drop that rank's holes)."""
    return shard_path(out_path, rank) + ".done"


def _write_done_marker(out_path: str, rank: int, n: int,
                       holes_done: int, extra: Optional[dict] = None,
                       exclusive: bool = False) -> bool:
    # records counted from the closed (fsynced) ordinal sidecar, so a
    # resumed run's marker covers prior runs' records too
    records = 0
    try:
        with open(shard_path(out_path, rank) + ".idx") as fi:
            records = sum(1 for line in fi if not line.startswith("#"))
    except OSError:
        pass
    # fsynced like the journal (same shared idiom, write_json_atomic):
    # the marker VOUCHES for the shard bytes — merge_shards trusts its
    # existence — so it must never become durable while unfsynced shard
    # data could still be lost to a power cut; ShardWriter.close fsyncs
    # both shard files first.  ``extra``: the fleet plane's provenance
    # fields (range table hash, worker identity, [lo,hi)) ride in the
    # same marker so merge_shards can refuse stale-table markers.
    obj = {"rank": rank, "hosts": n, "records": records,
           "holes_done": holes_done}
    if extra:
        obj.update(extra)
    if exclusive:
        # fleet ranges commit through the exclusive fence: exactly one
        # of any number of racing retirers publishes the marker
        # (write_json_exclusive; the loser's False means someone else
        # already vouched for this range)
        return write_json_exclusive(done_path(out_path, rank), obj)
    write_json_atomic(done_path(out_path, rank), obj)
    return True


class ShardWriter:
    """FASTA shard + sidecar of global hole ordinals, for exact merge.

    Round-robin mode (``start_ordinal`` None): local hole ordinal k
    (what drive_batched passes to put_at) maps to global ordinal
    rank + k*n.  Range mode (byte-range sharded BAM ingest,
    io/bamindex.py): ordinal = start_ordinal + k — monotone across
    ranks because a contiguous range's filtered hole count never
    exceeds its raw width, so rank r's keys stay below rank r+1's
    start.  Either way merge_shards' ordinal heap restores the exact
    single-host output order.
    """

    def __init__(self, out_path: str, rank: int, n: int, append: bool,
                 start_ordinal: int | None = None,
                 mode_header: str | None = None):
        self.rank, self.n = rank, n
        self.start_ordinal = start_ordinal
        mode = "a" if append else "w"
        self.path = shard_path(out_path, rank)
        # UTF-8 pinned: bytes_out counts encoded bytes (non-ASCII read
        # names must not skew the journal's truncation offsets)
        self._f = open(self.path, mode, encoding="utf-8")
        self._idx = open(self.path + ".idx", mode, encoding="utf-8")
        # byte accounting for journal v2's torn-tail recovery; resumes
        # continue from the on-disk sizes the journal already verified
        self.bytes_out = os.path.getsize(self.path) if append else 0
        self.idx_bytes_out = (os.path.getsize(self.path + ".idx")
                              if append else 0)
        if not append:
            # the sharding mode is chosen per-rank from local state (a
            # BGZF index sidecar may be fresh on one host and stale on
            # another); a mixed-mode run would interleave overlapping
            # ordinal spaces into a silently corrupt merge, so each
            # shard declares its mode and merge_shards refuses a mix.
            # The fleet plane passes its own header ("#mode=lease/<table
            # hash>", pipeline/fleet.py) so leased-range outputs can
            # never be merged with static shards or a different split.
            hdr = mode_header if mode_header is not None else (
                "#mode=range\n" if start_ordinal is not None
                else "#mode=rr\n")
            self._idx.write(hdr)
            self.idx_bytes_out += len(hdr)

    def put_at(self, local_idx: int, name: str, seq: bytes,
               qual: bytes | None = None) -> None:
        rec, nbytes = fastx.format_record(name, seq, qual)
        self._f.write(rec)
        self.bytes_out += nbytes
        ordinal = (self.rank + local_idx * self.n
                   if self.start_ordinal is None
                   else self.start_ordinal + local_idx)
        line = f"{ordinal}\n"
        self._idx.write(line)
        self.idx_bytes_out += len(line)

    def put(self, name: str, seq: bytes,
            qual: bytes | None = None) -> None:  # pragma: no cover
        raise RuntimeError("ShardWriter requires put_at")

    def flush(self) -> None:
        # both streams, record before sidecar (a crash between the two
        # leaves an indexless record tail, which verify_output truncates)
        self._f.flush()
        self._idx.flush()

    def close(self) -> None:
        # fsync both shard files: the completion marker written after
        # close vouches for these bytes, so they must be durable first.
        # A REAL fsync failure (e.g. EIO: writeback lost dirty pages)
        # must propagate — rc becomes 1 and the marker is suppressed —
        # and only genuinely-unsupported fsync is ignored.
        import errno

        err = None
        for f in (self._f, self._idx):
            try:
                try:
                    f.flush()
                    os.fsync(f.fileno())
                except OSError as e:
                    if e.errno not in (errno.EINVAL, errno.ENOTSUP,
                                       getattr(errno, "EOPNOTSUPP", -1)):
                        err = err or e
                except ValueError:
                    pass  # already closed (double close): nothing to sync
            finally:
                # BOTH streams always get closed, and the FIRST error is
                # the one reported (an unguarded close() re-raising the
                # flush failure would skip the sidecar entirely)
                try:
                    f.close()
                except OSError as e:
                    err = err or e
        if err is not None:
            raise err


def run_pipeline_sharded(in_path: str, out_path: str, cfg: CcsConfig,
                         rank: int, n: int,
                         journal_path: Optional[str] = None,
                         inflight: Optional[int] = None) -> int:
    """One rank's share of a sharded run, through the batched driver.

    Writes <out>.shard<rank> (+ .idx, + the .done marker at rc 0).  After
    all ranks finish, any one process calls merge_shards(out_path, n) to
    produce the final FASTA.  The device, the kernels, the mesh precheck
    (a bad --mesh ends the rank before its shard files are touched), the
    Metrics, the tracer, telemetry, the drain guard and the exit codes are
    run.run_pipeline's; this rank's stream, journal and writer are
    opened here."""
    import dataclasses

    from ccsx_tpu_torch.pipeline import run as run_mod

    if not (0 <= rank < n):
        raise ValueError(f"rank {rank} outside [0, {n})")
    if cfg.trace_path:
        # per-rank flight-recorder files: ranks on one filesystem would
        # otherwise clobber each other's span JSONL.  Metrics streams
        # append and every event carries a wall-clock ts, so THOSE merge
        # on a common timeline; the trace file is opened "w" per run.
        cfg = dataclasses.replace(
            cfg, trace_path=f"{cfg.trace_path}.shard{rank}")
    if cfg.telemetry_port:
        # per-rank telemetry ports (base + rank): every rank of a
        # same-host sharded run is scrapeable at a predictable address,
        # and `ccsx-tpu-torch top host:P host:P+1 ...` aggregates them.
        # The server still auto-bumps upward if something else holds the
        # offset port.
        cfg = dataclasses.replace(
            cfg, telemetry_port=cfg.telemetry_port + rank)
    # byte-range sharded ingest: a fresh BGZF hole index
    # (--make-index) lets this rank inflate only its ~1/N of the
    # compressed bytes and own a contiguous raw-hole range; without one,
    # fall back to the zero-coordination full-parse round-robin.  Range
    # mode streams through the Python record parser (the native prefetch
    # streamer reads whole files).
    range_lo = range_hi = None
    idx = None
    if cfg.is_bam and in_path != "-" and os.path.exists(in_path):
        from ccsx_tpu_torch.io import bamindex

        idx = bamindex.load_index(in_path)
    if idx is not None:
        range_lo, range_hi = bamindex.hole_range(idx["n_holes"], rank, n)
    jp = f"{journal_path}.shard{rank}" if journal_path else None
    opened = {}

    def open_io(metrics):
        try:
            from ccsx_tpu_torch.io import zmw as zmw_mod

            if range_lo is not None:
                # progress/ETA total in RAW holes: this rank owns exactly
                # its contiguous index range
                metrics.holes_total = range_hi - range_lo

                def _count(nbytes, m=metrics):
                    m.ingest_bytes += nbytes

                stream = zmw_mod.stream_zmws(
                    bamindex.read_hole_range(
                        in_path, idx, range_lo, range_hi, counter=_count,
                        max_record_bytes=cfg.max_record_bytes),
                    cfg, metrics=metrics)
            else:
                stream = run_mod.open_zmw_stream(in_path, cfg, metrics)
                if in_path != "-" and os.path.exists(in_path):
                    # full-parse round-robin: every rank ingests the file
                    metrics.ingest_bytes = os.path.getsize(in_path)
        except (OSError, RuntimeError) as e:
            print(f"Error: Failed to open infile! ({e})", file=sys.stderr)
            return None
        # the input_id pins the sharding MODE too: a journal written
        # under round-robin must not resume a range-sharded run (the
        # ordinal spaces differ)
        mode_id = (f"{in_path}#range{rank}/{n}" if range_lo is not None
                   else f"{in_path}#{rank}/{n}")
        # load under this run's fingerprint + reconcile BOTH shard files
        # (record + ordinal sidecar) with the cursor before appending: a
        # crash can tear either tail
        sp = shard_path(out_path, rank)
        journal = Journal.for_run(jp, mode_id, cfg, sp, sp + ".idx")
        # retract the stale completion marker BEFORE the writer can
        # truncate the shard files: the reverse order leaves a crash
        # window where a durable marker vouches for an already-truncated
        # shard and the merge goes silently short
        try:
            os.unlink(done_path(out_path, rank))
        except OSError:
            pass
        try:
            writer = ShardWriter(out_path, rank, n,
                                 append=bool(journal.holes_done),
                                 start_ordinal=range_lo)
        except OSError:
            print("Cannot open file for write!", file=sys.stderr)
            return None
        opened["journal"] = journal
        # range mode: the stream is already this rank's contiguous share;
        # round-robin: interleave-filter the shared full stream
        shard = (stream if range_lo is not None
                 else shard_stream(stream, rank, n))
        return shard, journal, writer

    # the shard writer needs per-hole ordinals: the batched driver always
    rc = run_mod.run_pipeline(in_path, out_path, cfg, batch="on",
                              inflight=inflight, journal_path=jp,
                              open_io=open_io)
    if rc == 0:
        _write_done_marker(out_path, rank, n, opened["journal"].holes_done)
    return rc


def merge_shards(out_path: str, n: int, cleanup: bool = True,
                 allow_unmarked: bool = False,
                 expect_table: Optional[str] = None) -> int:
    """K-way merge of <out>.shard0..n-1 by global hole ordinal into
    out_path; returns the record count.  Restores exactly the single-host
    output order.

    Every rank must have written its completion marker (done_path): a
    rank that died mid-run leaves a plausible-looking partial shard, and
    merging it would produce a silently short output — refused instead,
    naming exactly which shard(s) died and how far each got.  That
    includes ALL ranks missing (a node-wide kill looks exactly like a
    pre-marker legacy shard set, and guessing "legacy" would silently
    drop holes); a caller who KNOWS the set is legacy-complete passes
    ``allow_unmarked=True``.

    Leased-range sets (fleet runs, pipeline/fleet.py) carry a range
    table hash both in the shard's idx mode header and in its done
    marker: the two must agree (a stale marker from a previous run with
    a different M must not vouch for these bytes), and when the caller
    knows the live table it passes ``expect_table`` to refuse any
    foreign split outright."""
    dead = []
    markers: dict = {}
    for r in range(n):
        if os.path.exists(done_path(out_path, r)):
            # the marker records the host count its run was sharded
            # over: merging a K-host set with --merge-shards N<K would
            # pass the existence check for shards 0..N-1 and silently
            # drop shards N..K-1's holes — refuse the mismatch instead
            try:
                with open(done_path(out_path, r)) as f:
                    markers[r] = json.load(f)
                hosts = markers[r].get("hosts")
            except (OSError, ValueError):
                hosts = None  # unreadable marker: can't vouch -> dead
            if hosts == n:
                continue
            if hosts is not None:
                raise ValueError(
                    f"shard{r}'s completion marker says the run used "
                    f"{hosts} hosts, but --merge-shards got {n}; "
                    f"merge with the run's host count ({hosts})")
        p = shard_path(out_path, r)
        if os.path.exists(p + ".idx"):
            with open(p + ".idx") as fi:
                recs = sum(1 for line in fi if not line.startswith("#"))
            dead.append(f"shard{r} (died after {recs} durable records)")
        elif os.path.exists(p):
            dead.append(f"shard{r} (no ordinal sidecar)")
        else:
            dead.append(f"shard{r} (never started: no shard file)")
    if dead and allow_unmarked and len(dead) == n:
        print(f"[ccsx-tpu-torch] merge: no completion markers on any of {n} "
              "shards; merging anyway (allow_unmarked) — completion "
              "cannot be verified", file=sys.stderr)
    elif dead:
        hint = ("; if every rank is unmarked because the shards predate "
                "completion markers, merge with --merge-unmarked "
                "(allow_unmarked=True)" if len(dead) == n else "")
        raise ValueError(
            "refusing to merge incomplete shards — a merge now would "
            f"silently drop their holes: {'; '.join(dead)}; re-run the "
            "dead rank(s) (with --journal they resume from their shard "
            f"cursor), then merge again{hint}")

    def shard_mode(rank: int) -> str:
        with open(shard_path(out_path, rank) + ".idx") as fi:
            first = fi.readline()
        return first.strip() if first.startswith("#") else "#mode=rr"

    modes = {shard_mode(r) for r in range(n)}
    if len(modes) > 1:
        # one rank ran byte-range sharding while another round-robined
        # (e.g. the BGZF index sidecar was fresh on one host only), or
        # a static-shard output set got mixed with leased-range shards
        # from a fleet run: their ordinal spaces overlap, so a merge
        # would silently drop and duplicate holes — refuse instead
        detail = ("a static-shard run's outputs are mixed with a fleet "
                  "run's leased ranges; re-run one of them, don't merge "
                  "across schedulers"
                  if any(m.startswith("#mode=lease") for m in modes)
                  else "re-run all ranks with a consistent .ccsx_idx "
                       "sidecar (or none)")
        raise ValueError(
            f"shards disagree on sharding mode ({sorted(modes)}); "
            f"{detail}")
    mode = next(iter(modes)) if modes else "#mode=rr"
    if mode.startswith("#mode=lease/"):
        # leased-range set: every marker's recorded range table must
        # match the split the shard was actually written under (the idx
        # header) — a stale marker from a previous run with a different
        # M must not vouch for these bytes — and, when given, the live
        # table the scheduler expects
        table = mode[len("#mode=lease/"):]
        if expect_table is not None and table != expect_table:
            raise ValueError(
                f"leased shards were written under range table {table} "
                f"but this run's split is {expect_table}; stale outputs "
                "from a different -M split cannot be merged — re-run")
        for r in range(n):
            mt = markers.get(r, {}).get("table")
            if mt != table:
                raise ValueError(
                    f"shard{r}'s completion marker records range table "
                    f"{mt}, but the shard was written under {table}; a "
                    "stale marker from a different split cannot vouch "
                    "for these bytes — re-run the range")
    elif expect_table is not None:
        raise ValueError(
            f"expected a leased-range shard set (table {expect_table}) "
            f"but found mode {mode}; refusing to merge")

    def records(rank: int):
        p = shard_path(out_path, rank)
        with open(p) as f, open(p + ".idx") as fi:
            pos = fi.tell()
            if fi.readline()[:1] != "#":
                fi.seek(pos)   # legacy sidecar without a mode header
            while True:
                header = f.readline()
                if not header:
                    return
                # FASTA record = 2 lines, FASTQ = 4 (seq, '+', qual)
                lines = 1 if header[0] == ">" else 3
                rec = header + "".join(f.readline() for _ in range(lines))
                idx = int(fi.readline())
                yield idx, rec

    count = 0
    with open(out_path, "w") as out:
        for _, rec in heapq.merge(*[records(r) for r in range(n)]):
            out.write(rec)
            count += 1
    if cleanup:
        for r in range(n):
            p = shard_path(out_path, r)
            os.unlink(p)
            os.unlink(p + ".idx")
            try:
                os.unlink(done_path(out_path, r))
            except OSError:
                pass  # pre-marker shard sets (legacy) have none
    return count
