"""Crash-safe file leases: one primitive for the fleet's shard ranges and
the serve fleet's jobs and replica slots (a copy of the JAX package's
utils/lease.py).

A *lease domain* is a directory; a lease is a file ``<d>/lease.<key>``:

* **acquire** — ``O_CREAT|O_EXCL``: of any number of racers the kernel
  admits exactly one.  The winner's owner record (worker, pid, heartbeat,
  the caller's extras) is fsynced into the fresh file; a SIGKILL between
  create and write leaves a TORN lease (unreadable record), which ages by
  file mtime and expires like any stale one.
* **renew** — a fully-fsynced atomic replace (utils/journal.py
  ``write_json_atomic``) bumping the ``renewed`` heartbeat.  Returns False
  — and the caller must STOP working — when the lease is gone or owned by
  someone else.
* **expire/steal** — KILL-BEFORE-STEAL: a live same-host holder is
  SIGKILLed before its lease is renamed into the ``expired/`` graveyard,
  so no two writers ever touch one key's artifacts.
* **retire** — completed work is fenced by an EXCLUSIVE done marker
  (utils/journal.py ``write_json_exclusive``): even a zombie that survived
  expiry cannot double-commit a key.

Keys are strings: ``str(range_index)`` for the fleet plane
(pipeline/fleet.py), job ids (``j00012``) and replica slots (``r0``) for
the serve fleet (pipeline/serve.py, pipeline/gateway.py).  Neither torch
nor jax is imported here: the gateway and ``top`` scan a lease domain
without the compute stack.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Iterable, List, Optional, Tuple

from ccsx_tpu_torch.utils.journal import write_json_atomic

GRAVEYARD = "expired"


def lease_path(d: str, key: str) -> str:
    return os.path.join(d, f"lease.{key}")


def read_lease(d: str, key: str) -> Optional[dict]:
    """The lease's owner record, {} for a torn lease (crash between
    O_EXCL create and the owner write), None when free."""
    try:
        with open(lease_path(d, key)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        return {}


def try_acquire(d: str, key: str, worker: str,
                extra: Optional[dict] = None,
                kind: Optional[str] = None) -> Optional[dict]:
    """Acquire lease ``key``, or None if it is held.  ``O_CREAT|O_EXCL``
    is the arbitration: of any number of racers the kernel admits
    exactly one.  ``extra`` fields ride in the owner record (the fleet
    plane stores the range index + correlation id; the serve fleet
    stores replica name, host and telemetry port).  ``kind`` labels the
    acquire-latency histogram family (job/range/slot); None skips the
    observation (discovery-side callers)."""
    t0 = time.monotonic()
    try:
        fd = os.open(lease_path(d, key),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
    except FileExistsError:
        return None
    now = time.time()
    rec = {"key": key, "worker": worker, "pid": os.getpid(),
           "acquired": now, "renewed": now}
    if extra:
        rec.update(extra)
    try:
        os.write(fd, json.dumps(rec).encode())
        os.fsync(fd)
    finally:
        os.close(fd)
    if kind:
        # lease-acquire latency (create + owner-record fsync): reported
        # through the installed tracer's Metrics so this module stays
        # dependency-light — no-op when no tracer/metrics is installed
        from ccsx_tpu_torch.utils import trace

        tr = trace.current()
        if tr is not None and tr.metrics is not None:
            tr.metrics.observe("lease_acquire_s",
                               time.monotonic() - t0, kind)
    return rec


def renew(d: str, key: str, rec: dict,
          extra: Optional[dict] = None) -> bool:
    """Re-assert ownership by bumping the heartbeat (optionally
    refreshing ``extra`` fields, e.g. a replica's load gauge).  Returns
    False — and the caller must STOP renewing — when the lease is gone
    or owned by someone else (the scheduler expired us).  The
    read-then-replace window is closed by the kill-before-steal
    invariant, not by this function: the scheduler SIGKILLs a local
    holder before renaming its lease away, so a holder that can still
    run this code has not been stolen from."""
    cur = read_lease(d, key)
    if (not cur or cur.get("worker") != rec["worker"]
            or cur.get("pid") != rec["pid"]):
        return False
    upd = dict(rec, renewed=time.time())
    if extra:
        upd.update(extra)
    try:
        write_json_atomic(lease_path(d, key), upd)
    except OSError:
        return False
    return True


def release(d: str, key: str, rec: dict) -> None:
    """Free the lease (after the done marker is durable, or on drain).
    Losing a steal race (FileNotFoundError) is fine — released is
    released."""
    cur = read_lease(d, key)
    if (cur and cur.get("worker") == rec["worker"]
            and cur.get("pid") == rec["pid"]):
        try:
            os.unlink(lease_path(d, key))
        except OSError:
            pass


def steal_lease(d: str, key: str, cur: dict, kill: bool = True,
                seq: int = 0) -> Optional[dict]:
    """Scheduler-side eviction.  KILL-BEFORE-STEAL: the local holder is
    SIGKILLed before its lease is renamed away, so no two writers ever
    touch one key's artifacts (a survivor that could still renew past
    our read would otherwise clobber the next owner).  The rename into
    the graveyard is atomic; losing the rename race means someone else
    already freed it — not an error."""
    pid = cur.get("pid")
    if kill and pid and int(pid) != os.getpid():
        try:
            os.kill(int(pid), signal.SIGKILL)
        except (OSError, ValueError):
            pass   # already gone (or never ours to kill)
    grave = os.path.join(d, GRAVEYARD)
    os.makedirs(grave, exist_ok=True)
    dst = os.path.join(grave, f"lease.{key}.{os.getpid()}.{seq}")
    k = 0
    while os.path.exists(dst):
        k += 1
        dst = os.path.join(grave, f"lease.{key}.{os.getpid()}.{seq}~{k}")
    try:
        os.replace(lease_path(d, key), dst)
    except OSError:
        return None
    # forensics link: if the evicted holder left a black-box ring
    # (CCSX_BLACKBOX), stamp its path into the graveyard record so the
    # post-mortem (`ccsx-tpu-torch blackbox`) is one hop from the eviction.
    # Best effort — a torn lease has no pid and links nothing.
    pid = cur.get("pid") if cur else None
    if pid:
        from ccsx_tpu_torch.utils import blackbox

        for bb_dir in (os.environ.get(blackbox.ENV_DIR), d):
            if not bb_dir:
                continue
            bb_path = blackbox.box_path(bb_dir, int(pid))
            if os.path.exists(bb_path):
                try:
                    write_json_atomic(dst,
                                      dict(cur, blackbox=bb_path))
                except OSError:
                    pass
                break
    return cur


def expire_lease(d: str, key: str, timeout_s: float, kill: bool = True,
                 seq: int = 0) -> Optional[dict]:
    """Expire lease ``key`` if its heartbeat is older than
    ``timeout_s``.  Torn leases (no readable owner record) age by file
    mtime — a crash between acquire and owner-write must not pin the
    key forever.  Returns the evicted owner record, or None when
    live/free."""
    try:
        st = os.stat(lease_path(d, key))
    except OSError:
        return None
    cur = read_lease(d, key)
    if cur is None:
        return None
    beat = None
    if cur:
        try:
            beat = float(cur["renewed"])
        except (KeyError, TypeError, ValueError):
            beat = None
    if beat is None:
        beat = st.st_mtime
    if time.time() - beat < timeout_s:
        return None
    return steal_lease(d, key, cur, kill=kill, seq=seq)


def reclaim_pid_leases(d: str, keys: Iterable[str],
                       pid: int) -> List[str]:
    """Fast rebalance: a worker the scheduler KNOWS is dead (its child
    was just reaped) frees every lease it held immediately — no
    timeout wait, no kill needed.  This is what keeps a mid-run
    SIGKILL's cost at ~one unit of recompute instead of a full
    lease-timeout stall."""
    freed = []
    for seq, key in enumerate(keys):
        cur = read_lease(d, key)
        if cur and cur.get("pid") == pid:
            if steal_lease(d, key, cur, kill=False, seq=seq) is not None:
                freed.append(key)
    return freed


def list_leases(d: str, prefix: str = "") -> List[Tuple[str, dict]]:
    """Scan a lease domain: every live lease whose key starts with
    ``prefix``, as ``(key, owner_record)`` pairs ({} for torn).  This is
    the discovery primitive — the gateway and ``top`` find serve
    replicas by scanning slot leases (``r<k>``) without guessing ports;
    write_json_atomic staging files (``*.tmp``) are skipped."""
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in sorted(names):
        if not name.startswith("lease."):
            continue
        key = name[len("lease."):]
        if not key.startswith(prefix) or ".tmp" in key:
            continue
        rec = read_lease(d, key)
        if rec is not None:
            out.append((key, rec))
    return out
