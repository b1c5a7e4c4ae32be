"""Elastic fleet plane: leased work-ranges and the pull worker (a copy of
the JAX package's pipeline/fleet.py, the worker half and the lease and
queue primitives).

The SHARD-RANGE is the unit of scheduling, not the rank:

* the raw-hole ordinal space is split into M contiguous ranges
  (io/bamindex.py ``split_ranges``; the range table and its hash live in
  ``<dir>/fleet.json``);
* each range is guarded by a crash-safe file lease (utils/lease.py):
  acquire is ``O_CREAT|O_EXCL``, renewal a fully-fsynced atomic replace
  bumping the heartbeat, expiry kill-before-steal into the ``expired/``
  graveyard;
* a pull worker (``--fleet-dir``, or a serve replica running a fan-out
  job) acquires a lease, streams the range through the batched driver
  (``run.run_pipeline`` with the range's stream, a per-range journal in
  the fleet dir, so a requeued range RESUMES its predecessor's durable
  cursor), retires it with an EXCLUSIVE range done marker, releases it and
  pulls the next;
* range outputs are ordinary ``<out>.shard<i>`` files whose idx header
  carries the range-table hash (``#mode=lease/<hash>``), so the final merge
  is ``parallel/distributed.merge_shards(out, M)``, which refuses a
  static/leased mix or a stale table.

The scheduler half (``shepherd --fleet-ranges``: lease expiry, worker
supervision, mid-run joins) is not in this package; serve's fan-out
(pipeline/serve.py) drives the ranges of one job itself.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from typing import List, Optional, Tuple

from ccsx_tpu_torch import exitcodes
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.parallel import distributed
from ccsx_tpu_torch.utils import lease as leaselib
from ccsx_tpu_torch.utils.journal import Journal, write_json_atomic
from ccsx_tpu_torch.utils.metrics import Metrics

FLEET_STATE = "fleet.json"
GRAVEYARD = leaselib.GRAVEYARD


# ---------- fleet state (the range table) ----------

def fleet_dir_for(out_path: str) -> str:
    return out_path + ".fleet"


def table_hash(in_path: str, n_holes: int,
               ranges: List[Tuple[int, int]]) -> str:
    """Identity of ONE split of ONE input: any change to M, the hole
    count, or the input name yields a different hash, so markers and
    journals from a different split can never vouch for this run's
    bytes (short digest: it rides in every idx header)."""
    blob = json.dumps({"input": os.path.basename(in_path),
                       "n_holes": n_holes,
                       "ranges": [list(r) for r in ranges]},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def init_fleet(d: str, in_path: str, out_path: str, n_holes: int,
               m: int, lease_timeout: float,
               forward_args: Optional[list] = None,
               cid: Optional[str] = None) -> dict:
    """Create (or re-open) the fleet directory and its state file.

    Re-opening requires an identical range table — a leftover fleet
    dir from a different split must be removed by the operator, not
    silently inherited (its journals and markers describe other
    ranges).  ``cid`` is the submitting job's correlation id: it rides
    the state file so every worker pulling a range of this fan-out —
    including sibling replicas helping — stamps its spans/metrics with
    the SAME id the gateway minted (deliberately outside the table
    hash: correlation is observability, not range identity)."""
    from ccsx_tpu_torch.io import bamindex

    ranges = bamindex.split_ranges(n_holes, m)
    state = {"version": 1, "input": in_path, "output": out_path,
             "n_holes": n_holes, "ranges": [list(r) for r in ranges],
             "table": table_hash(in_path, n_holes, ranges),
             "lease_timeout": lease_timeout,
             "forward": list(forward_args or [])}
    if cid:
        state["cid"] = cid
    os.makedirs(os.path.join(d, GRAVEYARD), exist_ok=True)
    path = os.path.join(d, FLEET_STATE)
    if os.path.exists(path):
        prev = load_fleet(d)
        if prev is None or prev.get("table") != state["table"]:
            raise ValueError(
                f"fleet dir {d} holds state for a different range "
                "table; remove it (or merge/resume that run) before "
                "starting a new split")
        return prev   # resume: leases/journals/markers stay valid
    write_json_atomic(path, state)
    return state


def load_fleet(d: str) -> Optional[dict]:
    try:
        with open(os.path.join(d, FLEET_STATE)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ---------- lease primitives ----------
#
# The state machine itself lives in utils/lease.py (serve jobs and shard
# ranges share one primitive); these wrappers pin the fleet plane's
# integer-keyed API and its on-disk layout (``lease.<i>``, owner records
# carrying ``range``).

def lease_path(d: str, i: int) -> str:
    return leaselib.lease_path(d, str(i))


def read_lease(d: str, i: int) -> Optional[dict]:
    """The lease's owner record, {} for a torn lease (crash between
    O_EXCL create and the owner write), None when free."""
    return leaselib.read_lease(d, str(i))


def try_acquire(d: str, i: int, worker: str,
                cid: Optional[str] = None) -> Optional[dict]:
    """Acquire lease i, or None if it is held.  ``O_CREAT|O_EXCL`` is
    the arbitration: of any number of racers the kernel admits exactly
    one, with no read-check-write window.  The owner record (worker,
    pid, heartbeat, the fan-out's correlation id when known) is
    fsynced into the fresh file; a SIGKILL between create and write
    leaves a TORN lease, which the scheduler ages by file mtime and
    expires like any stale one."""
    extra = {"range": i}
    if cid:
        extra["cid"] = cid
    return leaselib.try_acquire(d, str(i), worker, extra=extra,
                                kind="range")


def renew(d: str, i: int, rec: dict) -> bool:
    """Re-assert ownership by bumping the heartbeat.  Returns False —
    and the caller must STOP renewing — when the lease is gone or owned
    by someone else (the scheduler expired us).  The read-then-replace
    window is closed by the kill-before-steal invariant, not by this
    function: the scheduler SIGKILLs a local holder before renaming its
    lease away, so a holder that can still run this code has not been
    stolen from."""
    return leaselib.renew(d, str(i), rec)


def release(d: str, i: int, rec: dict) -> None:
    """Free the lease (after the done marker is durable, or on drain).
    Losing a steal race (FileNotFoundError) is fine — released is
    released."""
    leaselib.release(d, str(i), rec)


def steal_lease(d: str, i: int, cur: dict, kill: bool = True,
                seq: int = 0) -> Optional[dict]:
    """Scheduler-side eviction.  KILL-BEFORE-STEAL: the local holder is
    SIGKILLed before its lease is renamed away, so no two writers ever
    touch one range's shard files (a survivor that could still renew
    past our read would otherwise clobber the next owner).  The rename
    into the graveyard is atomic; losing the rename race means someone
    else already freed it — not an error."""
    return leaselib.steal_lease(d, str(i), cur, kill=kill, seq=seq)


def expire_lease(d: str, i: int, timeout_s: float, kill: bool = True,
                 seq: int = 0) -> Optional[dict]:
    """Expire lease i if its heartbeat is older than ``timeout_s``.
    Torn leases (no readable owner record) age by file mtime — a crash
    between acquire and owner-write must not pin the range forever.
    Returns the evicted owner record, or None when live/free."""
    return leaselib.expire_lease(d, str(i), timeout_s, kill=kill, seq=seq)


def reclaim_worker_leases(d: str, m: int, pid: int) -> List[int]:
    """Fast rebalance: a worker the scheduler KNOWS is dead (its child
    was just reaped) frees every lease it held immediately — no
    timeout wait, no kill needed.  This is what keeps a mid-run
    SIGKILL's cost at ~one range of recompute instead of a full
    lease-timeout stall."""
    freed = leaselib.reclaim_pid_leases(d, (str(i) for i in range(m)),
                                        pid)
    return [int(k) for k in freed]


def queue_state(d: str, out_path: str, m: int) -> dict:
    """One scan of the queue: done (range marker present), leased, and
    queued (free) counts — the scheduler's gauges and its termination
    test."""
    done = leased = 0
    for i in range(m):
        if os.path.exists(distributed.done_path(out_path, i)):
            done += 1
        elif os.path.exists(lease_path(d, i)):
            leased += 1
    return {"done": done, "leased": leased, "queued": m - done - leased}


# ---------- the per-range run (one leased range through the driver) ----

def _open_range_stream(in_path: str, cfg: CcsConfig, lo: int, hi: int,
                       metrics: Metrics):
    from ccsx_tpu_torch.io import fastx
    from ccsx_tpu_torch.io import zmw as zmw_mod
    from ccsx_tpu_torch.pipeline.run import slice_raw_holes

    if cfg.is_bam:
        from ccsx_tpu_torch.io import bamindex

        idx = bamindex.load_index(in_path)
        if idx is None:
            raise OSError("fleet runs over BAM require a fresh hole "
                          "index (ccsx-tpu-torch --make-index); the sidecar "
                          "is missing or stale")

        def _count(nbytes, m=metrics):
            m.ingest_bytes += nbytes

        return zmw_mod.stream_zmws(
            bamindex.read_hole_range(
                in_path, idx, lo, hi, counter=_count,
                max_record_bytes=getattr(cfg, "max_record_bytes", 0)),
            cfg, metrics=metrics)
    f = open(in_path, "rb")
    return zmw_mod.stream_zmws(slice_raw_holes(fastx.read_fastx(f),
                                               lo, hi),
                               cfg, metrics=metrics)


def run_range(d: str, state: dict, cfg: CcsConfig, i: int,
              worker: str, inflight: Optional[int] = None,
              shared=None) -> int:
    """Stream range i through the batched driver into ``out.shard<i>``,
    exactly the per-rank flow of run_pipeline_sharded but with the
    range table as the sharding authority: M is the 'host count' the
    marker records, the idx header carries the table hash, and the
    per-range journal (fleet dir) pins range identity in its input_id
    so a requeued range resumes its predecessor's durable cursor.

    ``shared`` is the resident server's warm runtime (pipeline/serve.py
    ``_JobRuntime``): a serve replica running a fan-out range passes it
    so the range reuses the replica's refine programs and fair
    admission window instead of cold-starting a tracer per range."""
    from ccsx_tpu_torch.utils import blackbox, trace

    cid = state.get("cid")
    with trace.cid_scope(cid):
        # the inflight/done pair is what names this range in a
        # SIGKILLed worker's black-box dump; the done note rides a
        # finally so an exception cannot leave the range open in a
        # live worker's ring
        blackbox.note("inflight", what="range", id=i,
                      **({"cid": cid} if cid else {}))
        rc: Optional[int] = None
        try:
            rc = _run_range(d, state, cfg, i, worker,
                            inflight=inflight, shared=shared)
            return rc
        finally:
            blackbox.note("done", what="range", id=i,
                          **({"rc": rc} if rc is not None
                             else {"error": True}))


def _run_range(d: str, state: dict, cfg: CcsConfig, i: int,
               worker: str, inflight: Optional[int] = None,
               shared=None) -> int:
    """Range i through ``run.run_pipeline`` (the device, the kernels, the
    mesh precheck, the Metrics, the guard and the exit codes are its), with
    the range's stream, journal and shard writer opened by its
    ``open_io``, which a bad --mesh never reaches."""
    from ccsx_tpu_torch.pipeline.run import run_pipeline

    in_path, out_path = state["input"], state["output"]
    m, table = len(state["ranges"]), state["table"]
    lo, hi = state["ranges"][i]
    opened = {}

    def open_io(metrics):
        metrics.holes_total = hi - lo
        metrics.cid = state.get("cid")
        try:
            stream = _open_range_stream(in_path, cfg, lo, hi, metrics)
        except (OSError, RuntimeError) as e:
            print(f"Error: Failed to open infile! ({e})", file=sys.stderr)
            return None
        # range identity in the journal's input_id: a lease journal can
        # only resume THIS range of THIS split (utils/fingerprint.py covers
        # the code/config side)
        mode_id = f"{in_path}#lease{i}/{m}@{table}"
        sp = distributed.shard_path(out_path, i)
        journal = Journal.for_run(os.path.join(d, f"journal.{i}"),
                                  mode_id, cfg, sp, sp + ".idx")
        # retract any stale marker BEFORE the writer can truncate the
        # shard (same crash-window ordering as the static sharded driver);
        # a CURRENT-table marker never reaches here — the worker loop
        # skips retired ranges
        try:
            os.unlink(distributed.done_path(out_path, i))
        except OSError:
            pass
        try:
            writer = distributed.ShardWriter(
                out_path, i, m, append=bool(journal.holes_done),
                start_ordinal=lo, mode_header=f"#mode=lease/{table}\n")
        except OSError:
            print("Cannot open file for write!", file=sys.stderr)
            return None
        opened["journal"] = journal
        return stream, journal, writer

    rc = run_pipeline(in_path, out_path, cfg, batch="on", inflight=inflight,
                      open_io=open_io, shared=shared)
    if rc == 0:
        committed = distributed._write_done_marker(
            out_path, i, m, opened["journal"].holes_done,
            extra={"table": table, "worker": worker,
                   "range": [lo, hi]},
            exclusive=True)
        if not committed:
            # the exclusive fence lost: someone else already retired
            # this range (a zombie outrun by its replacement) — their
            # marker vouches, ours must not overwrite it
            print(f"[ccsx-tpu-torch] fleet: range {i} was already retired "
                  "by another worker; yielding to its marker",
                  file=sys.stderr)
    return rc


# ---------- the pull worker ----------

def _renewer(d: str, i: int, rec: dict, interval: float,
             stop: threading.Event) -> None:
    while not stop.wait(interval):
        if not renew(d, i, rec):
            return   # stolen: the scheduler killed-or-will-kill us


def run_fleet_worker(d: str, cfg: CcsConfig,
                     worker: Optional[str] = None,
                     inflight: Optional[int] = None,
                     poll_s: float = 0.5) -> int:
    """The pull loop: acquire a lease, run the range, retire, release,
    pull the next; exit 0 when every range has a done marker.

    SIGTERM/SIGINT between ranges (the outer DrainGuard here) or
    during one (drive_batched's inner guard) both land on rc 75 with
    the current lease RELEASED and its journal durable — a voluntary
    leave the scheduler treats as lease release, not failure.  Any
    other failure rc is returned as-is with the lease released; the
    range's journal lets the next owner resume."""
    from ccsx_tpu_torch.utils.drain import DrainGuard

    state = load_fleet(d)
    if state is None:
        print(f"Error: {d} has no readable {FLEET_STATE} (start the "
              "fleet with `ccsx-tpu-torch shepherd --fleet-ranges M`)",
              file=sys.stderr)
        return 1
    out_path = state["output"]
    m = len(state["ranges"])
    renew_s = max(0.05, float(state.get("lease_timeout", 10.0)) / 3.0)
    worker = worker or f"w{os.getpid()}"
    guard = DrainGuard.install()
    try:
        while True:
            progressed = False
            all_done = True
            for i in range(m):
                if guard.requested:
                    print(f"[ccsx-tpu-torch] fleet worker {worker}: drained "
                          "between ranges (rc 75)", file=sys.stderr)
                    return exitcodes.RC_INTERRUPTED
                if os.path.exists(distributed.done_path(out_path, i)):
                    continue
                all_done = False
                try:
                    rec = try_acquire(d, i, worker,
                                      cid=state.get("cid"))
                except FileNotFoundError:
                    # the fleet dir vanished: the scheduler retired the
                    # whole queue, merged, and cleaned up while we were
                    # scanning — a joined worker outliving the primary.
                    # Nothing left to pull; that is success, not error.
                    print(f"[ccsx-tpu-torch] fleet worker {worker}: fleet "
                          "completed and was cleaned up; exiting",
                          file=sys.stderr)
                    return 0
                if rec is None:
                    continue
                stop = threading.Event()
                t = threading.Thread(target=_renewer,
                                     args=(d, i, rec, renew_s, stop),
                                     daemon=True)
                t.start()
                try:
                    rc = run_range(d, state, cfg, i, worker,
                                   inflight=inflight)
                finally:
                    stop.set()
                    t.join(timeout=renew_s * 2)
                release(d, i, rec)
                if rc == exitcodes.RC_INTERRUPTED:
                    return rc   # drained mid-range: journal resumable
                if rc != 0:
                    return rc   # real failure: the scheduler decides
                progressed = True
            if all_done:
                return 0
            if not progressed:
                # everything is leased by someone else: idle-wait for a
                # range to free up (steal or retire), or for the end
                time.sleep(poll_s)
    finally:
        guard.restore()
