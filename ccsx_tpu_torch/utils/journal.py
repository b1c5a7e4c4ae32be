"""Resume journal for long runs (v2: crash-safe, torn-tail aware; a copy
of the JAX package's utils/journal.py).

The reference has no checkpointing (SURVEY.md §5.4): a crash means a full
rerun.  Because output is strictly input-ordered, resumability needs one
cursor — how many filtered holes have been fully retired — plus, in v2,
enough context to prove the cursor still describes the bytes on disk:

  * ``out_bytes`` / ``idx_bytes``: the output file size(s) at the cursor.
    A crash between a record write and the journal update leaves the file
    AHEAD of the journal (a torn tail); on resume ``verify_output``
    truncates the file back to the journaled offset, so the interrupted
    hole is recomputed instead of duplicated.  A file SHORTER than the
    journal means journaled work never became durable (the journal cannot
    be trusted at all) — the resume is refused and the run restarts.
  * ``fingerprint``: a config/code fingerprint (utils/fingerprint.py).
    Resuming across a change to the consensus code or an output-shaping
    config field would silently mix old-code output into a new-run
    artifact — refused instead.

Durability of the journal itself: every DISK update is a fully-fsynced
atomic replace (write_json_atomic: tmp write + fsync + ``os.replace`` +
directory fsync), so a crash at any instant — process kill or power
loss — leaves either the old or the new journal, never a torn or
unsynced one.  Disk updates are rate-limited to once per
``fsync_interval_s`` (env ``CCSX_JOURNAL_FSYNC_S``): between updates
the cursor advances in memory only, which is always safe — the output
file merely runs ahead of the journal, exactly the torn-tail state
resume repairs — and ``close()`` settles the final state.  Per-hole
fsyncs would buy nothing but a throughput floor on slow filesystems.
The drivers flush the output writer BEFORE
each advance (the port's writer is synchronous, pipeline/run.py
``open_writer``), preserving the invariant that the journal never runs
ahead of durable output.

v1 journals (no ``version`` field) are still accepted: the cursor is
honored and the v2 verifications are skipped — the legacy behavior.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Optional

from ccsx_tpu_torch.utils import faultinject
from ccsx_tpu_torch.utils import trace

VERSION = 2


def write_json_atomic(path: str, obj: dict, pre_replace_hook=None) -> None:
    """THE crash-safe small-JSON write (one copy of the idiom, one place
    to fix it): tmp write + flush + fsync, optional hook (fault
    injection), atomic replace, then best-effort directory fsync so the
    rename itself survives power loss."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    if pre_replace_hook is not None:
        pre_replace_hook()
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                      os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def write_json_exclusive(path: str, obj: dict) -> bool:
    """Crash-safe EXCLUSIVE small-JSON commit (the JAX package's fleet
    done-marker fence, kept with the copy): like write_json_atomic, but
    the publish step is ``os.link`` — which fails with EEXIST instead
    of replacing — so exactly ONE of any number of racing writers can
    ever commit ``path``.  Returns True when this caller committed,
    False when someone else already had (the loser must treat the
    existing marker as authoritative, not overwrite it).

    The tmp name carries the pid so two racers never collide on the
    staging file either."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    try:
        os.link(tmp, path)
        committed = True
    except FileExistsError:
        committed = False
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                      os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return committed


@dataclasses.dataclass
class Journal:
    path: str
    input_id: str
    holes_done: int = 0
    # failed (quarantined) and emitted holes among the retired ones:
    # restored into Metrics on resume so a --max-failed-holes budget is
    # judged over the WHOLE logical run — without the failure count,
    # every resume would silently grant a fresh budget, and without the
    # emitted count a fraction budget would judge prior failures
    # against THIS run's successes only (spurious rc-2 aborts on
    # short resume tails)
    holes_failed: int = 0
    holes_emitted: int = 0
    out_bytes: Optional[int] = None   # output file size at the cursor
    idx_bytes: Optional[int] = None   # shard .idx sidecar size (sharded runs)
    fingerprint: Optional[str] = None  # config/code compat key for THIS run
    # Disk-update rate limit: paying a fully-fsynced atomic replace per
    # retired hole would floor per-hole throughput on slow filesystems
    # for nothing the design needs — a LAGGING journal is always safe
    # (file ahead of journal -> torn tail truncated, holes recomputed),
    # while a lagging-but-UNSYNCED journal is not (a power cut during
    # an unfsynced replace can zero the good journal on e.g. XFS).  So
    # every disk update is fully fsynced, and updates happen at most
    # once per this many seconds (0 = every advance); close() settles
    # the final cursor.  Env override: CCSX_JOURNAL_FSYNC_S.
    fsync_interval_s: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("CCSX_JOURNAL_FSYNC_S", "1.0")))
    _last_fsync: float = dataclasses.field(default=float("-inf"),
                                           repr=False)
    _pending: bool = dataclasses.field(default=False, repr=False)

    @classmethod
    def for_run(cls, path: Optional[str], input_id: str, cfg,
                out_path: Optional[str] = None,
                idx_path: Optional[str] = None) -> "Journal":
        """THE journal-setup entry both drivers share: load (or
        create) under this run's config/code fingerprint, then reconcile
        the output file(s) with the cursor (verify_output) BEFORE any
        writer opens for append.  Paths of "-" (stdout) are skipped."""
        fingerprint = None
        if path:
            from ccsx_tpu_torch.utils.fingerprint import run_fingerprint

            fingerprint = run_fingerprint(cfg)
        j = cls.load_or_create(path, input_id=input_id,
                               fingerprint=fingerprint)
        if path and out_path and out_path != "-":
            j.verify_output(out_path, idx_path)
        return j

    @classmethod
    def load_or_create(cls, path: Optional[str], input_id: str,
                       fingerprint: Optional[str] = None) -> "Journal":
        j = cls(path=path or "", input_id=input_id, fingerprint=fingerprint)
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    d = json.load(f)
            except (OSError, ValueError):
                return j  # unreadable journal: start over
            if d.get("input_id") != input_id:
                return j
            stored = d.get("fingerprint")
            if (stored is not None and fingerprint is not None
                    and stored != fingerprint):
                # the checkpoint was cut by different code or an
                # output-shaping config change: resuming would mix
                # incompatible sections into one artifact — recompute
                print(f"[ccsx-tpu-torch] journal {path}: fingerprint mismatch "
                      f"(journal {stored}, run {fingerprint}); refusing "
                      "to resume — recomputing from scratch",
                      file=sys.stderr)
                return j
            j.holes_done = int(d.get("holes_done", 0))
            j.holes_failed = int(d.get("holes_failed", 0))
            j.holes_emitted = int(d.get("holes_emitted", 0))
            ob, ib = d.get("out_bytes"), d.get("idx_bytes")
            j.out_bytes = int(ob) if ob is not None else None
            j.idx_bytes = int(ib) if ib is not None else None
        return j

    def reset(self) -> None:
        """Discard the resume state (the caller recomputes from scratch)."""
        self.holes_done = 0
        self.holes_failed = 0
        self.holes_emitted = 0
        self.out_bytes = None
        self.idx_bytes = None

    def verify_output(self, out_path: str,
                      idx_path: Optional[str] = None) -> None:
        """Reconcile the output file(s) with the journaled offsets before
        a resume: truncate a torn tail (file ahead of journal — the
        crash-between-write-and-journal case), or refuse the resume
        entirely (file behind journal: journaled work was lost, nothing
        on disk can be trusted).  No-op for v1 journals (no offsets) and
        fresh journals."""
        if not self.holes_done:
            return
        targets = [(out_path, self.out_bytes)]
        if idx_path is not None:
            targets.append((idx_path, self.idx_bytes))
        sizes = []
        for path, want in targets:
            if want is None:
                sizes.append(None)
                continue
            have = os.path.getsize(path) if os.path.exists(path) else 0
            if have < want:
                print(f"[ccsx-tpu-torch] journal {self.path}: {path} is {have} "
                      f"bytes but the journal recorded {want} — journaled "
                      "output was lost; refusing to resume, recomputing "
                      "from scratch", file=sys.stderr)
                self.reset()
                return
            sizes.append(have)
        for (path, want), have in zip(targets, sizes):
            if want is None or have is None or have == want:
                continue
            print(f"[ccsx-tpu-torch] journal {self.path}: truncating torn tail "
                  f"of {path} ({have} -> {want} bytes; the interrupted "
                  "hole will be recomputed)", file=sys.stderr)
            with open(path, "rb+") as f:
                f.truncate(want)

    def retire(self, writer, wrote: bool, metrics=None) -> None:
        """Retire ONE emitted hole — the single home of the crash
        invariant both drivers share: the record is flushed durable
        BEFORE the cursor claims it (the writer is synchronous,
        run.open_writer), then the 'write' fault point
        (the canonical torn-tail kill instant), then the cursor advance
        carrying the writer's byte accounting."""
        if wrote and self.path:
            flush = getattr(writer, "flush", None)
            if flush is not None:
                with trace.span("writer_flush", cat="write"):
                    if metrics is not None:
                        with metrics.timer("write"):
                            flush()
                    else:
                        flush()
            faultinject.fire("write")
        if wrote:
            self.holes_emitted += 1
        if metrics is not None:
            # carried so a resume restores the failure count (the
            # --max-failed-holes budget survives restarts)
            self.holes_failed = metrics.holes_failed
        self.advance(out_bytes=getattr(writer, "bytes_out", None),
                     idx_bytes=getattr(writer, "idx_bytes_out", None))

    def advance(self, n: int = 1, out_bytes: Optional[int] = None,
                idx_bytes: Optional[int] = None) -> None:
        self.holes_done += n
        if out_bytes is not None:
            self.out_bytes = out_bytes
        if idx_bytes is not None:
            self.idx_bytes = idx_bytes
        if not self.path:
            return
        if (time.monotonic() - self._last_fsync) < self.fsync_interval_s:
            # cursor lags on disk (safe: resume truncates the file tail
            # back to it and recomputes); close() settles the final state
            self._pending = True
            return
        self._write()

    def close(self) -> None:
        """Settle any in-memory cursor progress onto disk (drivers call
        this at run end, after the writer closes).

        A failed settle (ENOSPC on a full disk — the very failure that
        may have ended the run) is a WARNING, not a raise: the
        on-disk journal is merely further behind the durable output,
        which is exactly the torn-tail state resume repairs.  Raising
        from the drivers' ``finally`` would replace the real rc with a
        traceback."""
        if self.path and self._pending:
            try:
                self._write()
            except OSError as e:
                print(f"[ccsx-tpu-torch] journal {self.path}: final settle "
                      f"failed ({e}); the on-disk cursor lags the "
                      "output — resume will truncate and recompute the "
                      "tail", file=sys.stderr)

    def _write(self) -> None:
        # the injected crash fires between the fsynced tmp and the
        # atomic replace: the OLD journal must survive intact
        with trace.span("journal_update", cat="journal",
                        holes_done=self.holes_done):
            self._write_disk()

    def _write_disk(self) -> None:
        write_json_atomic(
            self.path,
            {"version": VERSION,
             "input_id": self.input_id,
             "holes_done": self.holes_done,
             "holes_failed": self.holes_failed,
             "holes_emitted": self.holes_emitted,
             "out_bytes": self.out_bytes,
             "idx_bytes": self.idx_bytes,
             "fingerprint": self.fingerprint},
            pre_replace_hook=lambda: faultinject.fire("journal"))
        self._last_fsync = time.monotonic()
        self._pending = False
