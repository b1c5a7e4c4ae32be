"""`ccsx-tpu-torch shepherd`: the supervisor of sharded ranks, fleet pull
workers and serve replicas (a copy of the JAX package's
pipeline/supervisor.py; tests/test_torch_isolation.py's ``COPIES`` lists
each difference).

A dead rank in a sharded run is only *visible* without it: the rank
never writes its completion marker, ``merge_shards`` refuses the merge,
and the operator is told to re-run the dead rank by hand
(parallel/distributed.py).  The shepherd turns that instruction into a
supervised loop:

* **Launch** — the N ranks run as subprocesses of one supervisor
  process (`python -c` runners invoking the ordinary CLI with
  ``--hosts N --host-id r``), each with a per-rank log file
  (``<out>.shard<r>.log``) and — unless the caller provided one — a
  shepherd-owned journal (``<out>.shepherd.journal``; the sharded
  driver suffixes ``.shard<r>``), because the journal is what makes a
  restart a RESUME instead of a recompute.  Each child runs on the card
  unless its forwarded argv says ``--device cpu``; this module imports
  no torch and runs nothing on a device itself.

* **Monitor** — liveness is the rank's *progress heartbeat*: the
  newest mtime across its shard journal, shard output, and ordinal
  sidecar (the journal is fsynced at least once a second while holes
  retire).  With ``--telemetry-port`` the per-rank ``/healthz``
  endpoints (base port + rank, parallel/distributed.py) are polled too
  — a 503/degraded rank is reported in the shepherd log; an
  *unreachable* endpoint is only informational (the process poll is
  the authority on death).  A rank whose heartbeat goes stale past
  ``--rank-stall-timeout`` (0 = disabled) is SIGKILLed and treated as
  dead.  The beat starts at launch and the first journal write comes
  after the child's start-up (torch, the CUDA context, the kernels'
  load) and its first retirement, so size the timeout above both
  (PERF.md gives them as measured on the H100).  It is also the answer
  to a kernel that never ends: a rank's own ``--dispatch-deadline``
  abandons the wait, but the replay queues behind the kernel on the
  card (pipeline/resilience.py).

* **Restart** — a dead rank (nonzero exit, or killed as stalled) is
  relaunched with exponential backoff (``--rank-backoff`` x 2^attempt)
  up to ``--max-rank-restarts`` times; it resumes from its shard
  journal, so already-durable records are never recomputed.
  ``CCSX_FAULTS`` is stripped from restart environments — injected
  faults model the FIRST failure, and a restarted rank must run clean.
  A rank that exhausts its restarts fails the whole run (rc 1) — the
  remaining ranks are still driven to completion so their journals are
  warm for a later retry.

* **Merge** — when every rank has exited 0 (completion markers in
  place), the shepherd runs the ordinary ``merge_shards`` and exits 0.
  Output is byte-identical to an unsharded run by the existing merge
  invariants, restarts included (pinned by
  tests/test_torch_supervisor.py).

``--fleet-ranges M`` makes it the elastic scheduler of leased ranges
(``fleet_run``), ``--join`` adds pull workers to a running fleet
(``fleet_join``), and ``--serve-replicas N`` supervises serve replicas
and their gateway (``serve_fleet_run``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ccsx_tpu_torch import exitcodes

# the subprocess runner body; a caller's PRELUDE may be prepended
_RUNNER = ("import sys; from ccsx_tpu_torch.cli import main; "
           "sys.exit(main(sys.argv[1:]))")

# shepherd-only flags stripped from the forwarded rank command line
_SHEPHERD_FLAGS = ("--max-rank-restarts", "--rank-backoff",
                   "--rank-stall-timeout", "--fleet-ranges",
                   "--lease-timeout", "--join")


def default_prelude() -> str:
    """Nothing to pin: the port's children choose their device from
    their own argv (the card unless ``--device cpu``), so the prelude
    imports nothing and sets no device variable, whatever this
    process's environment says.  Callers may still pass their own
    ``runner_prelude`` (a test's or a harness's hook)."""
    return ""


def strip_shepherd_flags(argv: List[str],
                         flags=_SHEPHERD_FLAGS) -> List[str]:
    """Remove shepherd-only options (+ their values) from an argv so
    the remainder forwards verbatim to the rank command lines."""
    out: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in flags:
            skip = True
            continue
        if any(a.startswith(f + "=") for f in flags):
            continue
        out.append(a)
    return out


@dataclasses.dataclass
class _Rank:
    rank: int
    proc: Optional[subprocess.Popen] = None
    log: Optional[object] = None
    attempts: int = 0          # restarts used (0 = first launch)
    beat: float = 0.0          # monotonic time of last progress sign
    last_mtime: Optional[float] = None  # newest observed shard mtime
    relaunch_at: Optional[float] = None
    done: bool = False
    failed: Optional[str] = None
    failed_rc: Optional[int] = None
    last_health: Optional[str] = None
    # rc-75 bookkeeping: a drained rank is VOLUNTARY preemption, not a
    # crash — relaunched immediately without touching the restart
    # budget (preempted suppresses a re-applied first_launch fault);
    # a fleet worker that drains instead LEAVES (drained)
    preempted: bool = False
    drained: bool = False


def _beat_paths(out_path: str, journal: str, rank: int) -> List[str]:
    return [f"{journal}.shard{rank}",
            f"{out_path}.shard{rank}",
            f"{out_path}.shard{rank}.idx"]


def _latest_mtime(paths: List[str]) -> Optional[float]:
    best = None
    for p in paths:
        try:
            m = os.stat(p).st_mtime
        except OSError:
            continue
        best = m if best is None or m > best else best
    return best


def _poll_healthz(port: int, timeout: float = 0.5) -> Optional[str]:
    """'ok' | 'degraded' | None (unreachable).  Best effort only — the
    endpoint auto-bumps when its port is taken, so unreachable is
    informational, never a death verdict."""
    import urllib.error
    import urllib.request

    url = f"http://127.0.0.1:{port}/healthz"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read().decode()).get("status", "ok")
    except urllib.error.HTTPError as e:  # 503 carries the body
        try:
            return json.loads(e.read().decode()).get("status",
                                                     "degraded")
        except (ValueError, OSError):
            return "degraded"
    except (OSError, ValueError):
        return None


def _blackbox_hint(pid: Optional[int], *dirs: Optional[str]) -> None:
    """Point the reap log at a dead child's black-box ring when one
    exists (the CCSX_BLACKBOX flight recorder, utils/blackbox.py): the
    supervisor is the first reader of a SIGKILL, and this one line is
    the hop from 'pid N died' to WHAT it was doing when it died."""
    if not pid:
        return
    from ccsx_tpu_torch.utils import blackbox

    for bd in (os.environ.get(blackbox.ENV_DIR),) + dirs:
        if not bd:
            continue
        p = blackbox.box_path(bd, pid)
        if os.path.exists(p):
            print(f"[ccsx-tpu-torch] black box for pid {pid}: "
                  f"`ccsx-tpu-torch blackbox {p}`", file=sys.stderr)
            return


def shepherd_run(in_path: str, out_path: str, hosts: int,
                 forward_args: List[str],
                 journal: Optional[str] = None,
                 max_restarts: int = 2,
                 backoff_s: float = 1.0,
                 rank_stall_timeout: float = 0.0,
                 telemetry_port: int = 0,
                 env: Optional[dict] = None,
                 first_launch_env: Optional[Dict[int, dict]] = None,
                 poll_s: float = 0.25,
                 merge: bool = True,
                 runner_prelude: Optional[str] = None) -> int:
    """Supervise a sharded run end to end; returns a process rc
    (exitcodes.py: 0 = merged, 1 = a rank exhausted its restarts or
    the merge was refused).

    ``forward_args`` is the full rank CLI argv (flags + INPUT OUTPUT,
    including ``--hosts``) WITHOUT ``--host-id`` — the shepherd
    appends it per rank.  ``first_launch_env`` maps rank -> extra env
    for attempt 0 only (the fault-injection hook: restarts run clean).
    """
    from ccsx_tpu_torch.parallel.distributed import merge_shards

    if hosts < 1:
        print("Error: shepherd needs --hosts >= 1", file=sys.stderr)
        return exitcodes.RC_FATAL
    base_env = dict(os.environ if env is None else env)
    prelude = (default_prelude() if runner_prelude is None
               else runner_prelude)
    first_launch_env = first_launch_env or {}
    # a journal is what makes a restart a resume; inject one when the
    # caller didn't ask for their own
    fwd = list(forward_args)
    if journal is None and "--journal" not in fwd:
        journal = f"{out_path}.shepherd.journal"
        fwd += ["--journal", journal]
    elif journal is None:
        journal = fwd[fwd.index("--journal") + 1]

    def launch(st: _Rank) -> None:
        e = dict(base_env)
        rank_fwd = fwd
        if st.attempts == 0 and not st.preempted:
            e.update(first_launch_env.get(st.rank, {}))
        else:
            # restarts run clean: injected faults model the FIRST
            # failure (a re-armed rank_death would die forever) — both
            # the env form AND the forwarded CLI flag
            e.pop("CCSX_FAULTS", None)
            rank_fwd = strip_shepherd_flags(fwd,
                                            flags=("--inject-faults",))
        cmd = [sys.executable, "-c", prelude + _RUNNER, *rank_fwd,
               "--host-id", str(st.rank)]
        log_path = f"{out_path}.shard{st.rank}.log"
        try:
            st.log = open(log_path, "a", encoding="utf-8")
            st.log.write(f"\n=== shepherd launch rank {st.rank} attempt "
                         f"{st.attempts} @ {time.strftime('%H:%M:%S')} "
                         f"===\n")
            st.log.flush()
            sink = st.log
        except OSError as e_log:
            # an unwritable log (e.g. the output dir itself is the
            # problem) must not crash the supervisor — the rank will
            # fail with the real error on its own
            print(f"[ccsx-tpu-torch] shepherd: cannot open {log_path} "
                  f"({e_log}); rank {st.rank} output discarded",
                  file=sys.stderr)
            st.log = None
            sink = subprocess.DEVNULL
        st.proc = subprocess.Popen(cmd, env=e, stdout=sink,
                                   stderr=subprocess.STDOUT)
        st.beat = time.monotonic()
        st.relaunch_at = None
        print(f"[ccsx-tpu-torch] shepherd: rank {st.rank} up (pid "
              f"{st.proc.pid}, attempt {st.attempts}, log {log_path})",
              file=sys.stderr)

    def close_log(st: _Rank) -> None:
        if st.log is not None:
            try:
                st.log.close()
            except OSError:
                pass
            st.log = None

    def schedule_restart(st: _Rank, reason: str) -> None:
        pid = st.proc.pid if st.proc is not None else None
        close_log(st)
        st.proc = None
        _blackbox_hint(pid)
        if st.attempts >= max_restarts:
            st.failed = (f"rank {st.rank} {reason} and exhausted its "
                         f"{max_restarts} restart(s)")
            st.done = True
            print(f"[ccsx-tpu-torch] shepherd: {st.failed}", file=sys.stderr)
            return
        st.attempts += 1
        delay = backoff_s * (2 ** (st.attempts - 1))
        st.relaunch_at = time.monotonic() + delay
        print(f"[ccsx-tpu-torch] shepherd: rank {st.rank} {reason}; "
              f"restarting in {delay:g}s (attempt {st.attempts}/"
              f"{max_restarts}; resumes from its shard journal)",
              file=sys.stderr)

    ranks = [_Rank(rank=r) for r in range(hosts)]
    for st in ranks:
        launch(st)
    last_health_poll = 0.0
    try:
        while not all(st.done for st in ranks):
            now = time.monotonic()
            poll_health = (telemetry_port
                           and now - last_health_poll >= 2.0)
            if poll_health:
                last_health_poll = now
            for st in ranks:
                if st.done:
                    continue
                if st.proc is None:
                    if st.relaunch_at is not None and now >= st.relaunch_at:
                        launch(st)
                    continue
                rc = st.proc.poll()
                if rc is not None:
                    if rc == 0:
                        st.done = True
                        close_log(st)
                        print(f"[ccsx-tpu-torch] shepherd: rank {st.rank} "
                              "completed", file=sys.stderr)
                    elif rc == exitcodes.RC_INTERRUPTED:
                        # graceful drain (rc 75, EX_TEMPFAIL) is
                        # VOLUNTARY preemption — the rank made its work
                        # durable and asked to be resumed.  Counting it
                        # against --max-rank-restarts (like a crash)
                        # would fail a run that merely got SIGTERMed N
                        # times by a preemptible-capacity scheduler:
                        # relaunch immediately, no budget spent, no
                        # backoff, and never re-arm a first-launch
                        # fault (st.preempted)
                        close_log(st)
                        st.proc = None
                        st.preempted = True
                        st.relaunch_at = now
                        print(f"[ccsx-tpu-torch] shepherd: rank {st.rank} "
                              "drained (rc 75) — voluntary preemption; "
                              "relaunching without spending the "
                              "restart budget", file=sys.stderr)
                    elif rc == exitcodes.RC_FAILED_HOLES:
                        # a failed-hole budget abort is DETERMINISTIC:
                        # the journal carries the failure count across
                        # resumes, so a restart would re-abort — fail
                        # the rank immediately instead of burning the
                        # restart budget on it
                        close_log(st)
                        st.proc = None
                        st.failed = (f"rank {st.rank} exceeded its "
                                     "--max-failed-holes budget (rc "
                                     f"{rc}); not restartable")
                        st.failed_rc = rc
                        st.done = True
                        print(f"[ccsx-tpu-torch] shepherd: {st.failed}",
                              file=sys.stderr)
                    else:
                        schedule_restart(st, f"died (rc {rc})")
                    continue
                # progress heartbeat: journal/shard mtimes (fsynced at
                # least once a second while holes retire).  A CHANGED
                # mtime stamps the beat on OUR monotonic clock —
                # comparing wall-clock mtimes against monotonic time
                # would let an NTP step mark every healthy rank stale
                m = _latest_mtime(_beat_paths(out_path, journal,
                                              st.rank))
                if m is not None and m != st.last_mtime:
                    st.last_mtime = m
                    st.beat = now
                if poll_health:
                    h = _poll_healthz(telemetry_port + st.rank)
                    if h != st.last_health and h is not None:
                        st.last_health = h
                        if h != "ok":
                            print(f"[ccsx-tpu-torch] shepherd: rank "
                                  f"{st.rank} /healthz reports {h}",
                                  file=sys.stderr)
                if (rank_stall_timeout > 0
                        and now - st.beat > rank_stall_timeout):
                    print(f"[ccsx-tpu-torch] shepherd: rank {st.rank} "
                          f"heartbeat stale for >{rank_stall_timeout:g}s"
                          " — killing the wedged rank", file=sys.stderr)
                    try:
                        st.proc.send_signal(signal.SIGKILL)
                        st.proc.wait(timeout=10.0)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
                    schedule_restart(st, "stalled")
            time.sleep(poll_s)
    finally:
        for st in ranks:
            if st.proc is not None and st.proc.poll() is None:
                st.proc.kill()
                try:
                    st.proc.wait(timeout=10.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            close_log(st)
    failed = [st for st in ranks if st.failed]
    if failed:
        print("Error: shepherd run failed: "
              + "; ".join(st.failed for st in failed)
              + " — surviving ranks completed and their journals are "
              "intact; fix the cause and re-run the shepherd to resume",
              file=sys.stderr)
        # preserve the exit-code taxonomy through supervision: when
        # every failure is the deterministic failed-hole budget abort,
        # the shepherd reports rc 2 like an unsharded run would; any
        # other failure class stays the generic rc 1
        rcs = {st.failed_rc for st in failed}
        if rcs == {exitcodes.RC_FAILED_HOLES}:
            return exitcodes.RC_FAILED_HOLES
        return exitcodes.RC_FATAL
    if not merge:
        return exitcodes.RC_OK
    try:
        n = merge_shards(out_path, hosts)
    except (OSError, ValueError) as e:
        print(f"Error: shepherd merge refused: {e}", file=sys.stderr)
        return exitcodes.RC_FATAL
    print(f"[ccsx-tpu-torch] shepherd: merged {n} records from {hosts} "
          "ranks", file=sys.stderr)
    return exitcodes.RC_OK


def _spawn_worker(cmd: List[str], env: dict, log_path: str,
                  banner: str):
    """Launch one fleet worker with a per-worker append log; an
    unwritable log degrades to DEVNULL (same contract as the static
    shepherd's launch)."""
    try:
        log = open(log_path, "a", encoding="utf-8")
        log.write(banner)
        log.flush()
        sink = log
    except OSError as e:
        print(f"[ccsx-tpu-torch] fleet: cannot open {log_path} ({e}); "
              "worker output discarded", file=sys.stderr)
        log = None
        sink = subprocess.DEVNULL
    proc = subprocess.Popen(cmd, env=env, stdout=sink,
                            stderr=subprocess.STDOUT)
    return proc, log


def fleet_run(in_path: str, out_path: str, cfg, hosts: int,
              forward_args: List[str],
              ranges: int = 0,
              lease_timeout: float = 10.0,
              max_restarts: int = 2,
              backoff_s: float = 1.0,
              telemetry_port: int = 0,
              env: Optional[dict] = None,
              first_launch_env: Optional[Dict[int, dict]] = None,
              poll_s: float = 0.25,
              merge: bool = True,
              runner_prelude: Optional[str] = None) -> int:
    """The elastic scheduler (`ccsx-tpu-torch shepherd --fleet-ranges M`):
    split the input into M >> N leased ranges (pipeline/fleet.py),
    launch ``hosts`` pull workers, and supervise the QUEUE rather than
    fixed rank assignments:

    * a worker death immediately requeues its leased range(s) to the
      survivors (fast rebalance — no in-place restart needed; the
      worker is also relaunched while its restart budget lasts, as an
      optimization, never a requirement while others live);
    * leases whose heartbeat goes stale past ``lease_timeout`` are
      expired — local holder SIGKILLed first, then the lease is
      renamed away (kill-before-steal) — covering workers the
      scheduler did not launch (mid-run ``--join``);
    * rc 75 from a worker is a voluntary leave (graceful drain): its
      leases are already released, survivors absorb the queue;
    * when all M range markers are in, the ordinary
      ``merge_shards(out, M)`` restores the byte-identical output and
      the fleet dir is cleaned up.

    Returns 0 on merge, 75 when the whole fleet drained with the queue
    unfinished (re-run the same command to resume), 2/1 on failures
    (taxonomy preserved, like the static shepherd)."""
    import shutil

    from ccsx_tpu_torch.parallel.distributed import merge_shards
    from ccsx_tpu_torch.pipeline import fleet
    from ccsx_tpu_torch.pipeline.run import count_raw_holes
    from ccsx_tpu_torch.utils.metrics import Metrics

    if hosts < 1:
        print("Error: fleet needs --hosts >= 1", file=sys.stderr)
        return exitcodes.RC_FATAL
    base_env = dict(os.environ if env is None else env)
    prelude = (default_prelude() if runner_prelude is None
               else runner_prelude)
    first_launch_env = dict(first_launch_env or {})
    try:
        n_holes = count_raw_holes(in_path, cfg)
    except (OSError, RuntimeError, ValueError) as e:
        print(f"Error: Failed to open infile! ({e})", file=sys.stderr)
        return exitcodes.RC_FATAL
    # M >> N by default: enough granularity that a lost rank requeues
    # ~one range, not 1/N of the run; explicit --fleet-ranges pins it
    m = ranges if ranges > 0 else max(hosts,
                                      min(max(n_holes, 1), 4 * hosts))
    d = fleet.fleet_dir_for(out_path)
    # workers pull their WHOLE config from the forwarded argv; the
    # scheduler-only topology flags must not reach them (--hosts would
    # trip the static sharded path, --journal the per-rank injection —
    # fleet resume lives in the per-range journals)
    worker_fwd = strip_shepherd_flags(
        list(forward_args), flags=("--hosts", "--journal"))
    try:
        state = fleet.init_fleet(d, in_path, out_path, n_holes, m,
                                 lease_timeout,
                                 forward_args=worker_fwd)
    except (OSError, ValueError) as e:
        print(f"Error: fleet init failed: {e}", file=sys.stderr)
        return exitcodes.RC_FATAL
    m = len(state["ranges"])
    table = state["table"]
    metrics = Metrics(verbose=False)
    telem = None
    if telemetry_port:
        from ccsx_tpu_torch.utils import telemetry as telemetry_mod

        telem = telemetry_mod.start(metrics, telemetry_port)
    steals = 0
    rebalances = 0
    expiry_seq = 0

    def launch(w: _Rank) -> None:
        e = dict(base_env)
        wf = worker_fwd
        if w.attempts == 0 and not w.preempted:
            e.update(first_launch_env.get(w.rank, {}))
        else:
            e.pop("CCSX_FAULTS", None)
            wf = strip_shepherd_flags(worker_fwd,
                                      flags=("--inject-faults",))
        name = f"w{w.rank}"
        cmd = [sys.executable, "-c", prelude + _RUNNER, *wf,
               "--fleet-dir", d, "--fleet-worker", name]
        log_path = f"{out_path}.fleet.{name}.log"
        banner = (f"\n=== fleet launch worker {name} attempt "
                  f"{w.attempts} @ {time.strftime('%H:%M:%S')} ===\n")
        w.proc, w.log = _spawn_worker(cmd, e, log_path, banner)
        w.relaunch_at = None
        print(f"[ccsx-tpu-torch] fleet: worker {name} up (pid {w.proc.pid}, "
              f"attempt {w.attempts}, log {log_path})", file=sys.stderr)

    def close_log(w: _Rank) -> None:
        if w.log is not None:
            try:
                w.log.close()
            except OSError:
                pass
            w.log = None

    workers = [_Rank(rank=i) for i in range(hosts)]
    for w in workers:
        launch(w)
    qs = {"done": 0, "leased": 0, "queued": m}
    try:
        while True:
            now = time.monotonic()
            qs = fleet.queue_state(d, out_path, m)
            if qs["done"] >= m:
                break
            live = pending = 0
            for w in workers:
                if w.done:
                    continue
                if w.proc is None:
                    if w.relaunch_at is not None:
                        if now >= w.relaunch_at:
                            launch(w)
                            live += 1
                        else:
                            pending += 1
                    continue
                rc = w.proc.poll()
                if rc is None:
                    live += 1
                    continue
                pid = w.proc.pid
                close_log(w)
                w.proc = None
                if rc == 0:
                    w.done = True
                    print(f"[ccsx-tpu-torch] fleet: worker w{w.rank} "
                          "completed", file=sys.stderr)
                elif rc == exitcodes.RC_INTERRUPTED:
                    # voluntary leave: the drain released its lease
                    # with the range journal durable — the queue keeps
                    # the work, the survivors absorb it
                    w.done = True
                    w.drained = True
                    print(f"[ccsx-tpu-torch] fleet: worker w{w.rank} drained "
                          "(rc 75) — voluntary leave; its ranges stay "
                          "queued for the survivors", file=sys.stderr)
                elif rc == exitcodes.RC_FAILED_HOLES:
                    w.done = True
                    w.failed = (f"worker w{w.rank} exceeded its "
                                "--max-failed-holes budget (rc "
                                f"{rc}); not restartable")
                    w.failed_rc = rc
                    print(f"[ccsx-tpu-torch] fleet: {w.failed}",
                          file=sys.stderr)
                else:
                    # fast rebalance: the worker is KNOWN dead — free
                    # its leases now, don't wait out the lease timeout
                    freed = fleet.reclaim_worker_leases(d, m, pid)
                    if freed:
                        steals += len(freed)
                        rebalances += 1
                        print(f"[ccsx-tpu-torch] fleet: worker w{w.rank} "
                              f"died (rc {rc}); requeued range(s) "
                              f"{freed} for the survivors",
                              file=sys.stderr)
                    _blackbox_hint(pid, d)
                    if w.attempts >= max_restarts:
                        # out of budget: the worker LEAVES; this only
                        # fails the run if nobody is left to drain the
                        # queue
                        w.done = True
                        w.failed = (f"worker w{w.rank} died (rc {rc}) "
                                    "and exhausted its "
                                    f"{max_restarts} restart(s)")
                        w.failed_rc = rc
                        print(f"[ccsx-tpu-torch] fleet: {w.failed}",
                              file=sys.stderr)
                    else:
                        w.attempts += 1
                        delay = backoff_s * (2 ** (w.attempts - 1))
                        w.relaunch_at = now + delay
                        pending += 1
                        print(f"[ccsx-tpu-torch] fleet: worker w{w.rank} "
                              f"died (rc {rc}); relaunching in "
                              f"{delay:g}s (attempt {w.attempts}/"
                              f"{max_restarts})", file=sys.stderr)
            # timeout expiry: covers holders the scheduler did NOT
            # launch (joined workers, leaked pids) — kill-before-steal
            for i in range(m):
                ev = fleet.expire_lease(d, i, lease_timeout,
                                        seq=expiry_seq)
                expiry_seq += 1
                if ev is not None:
                    steals += 1
                    rebalances += 1
                    print(f"[ccsx-tpu-torch] fleet: lease on range {i} "
                          f"expired (holder "
                          f"{ev.get('worker', '<torn>')}); requeued",
                          file=sys.stderr)
            # fleet gauges: scraped via /metrics and `ccsx-tpu-torch top`
            metrics.fleet_ranges_total = m
            metrics.fleet_ranges_queued = qs["queued"]
            metrics.fleet_ranges_leased = qs["leased"]
            metrics.fleet_ranges_retired = qs["done"]
            metrics.fleet_ranks_alive = live
            metrics.fleet_steals = steals
            metrics.fleet_rebalances = rebalances
            if live == 0 and pending == 0:
                break
            time.sleep(poll_s)
    finally:
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                w.proc.kill()
                try:
                    w.proc.wait(timeout=10.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            close_log(w)
        if telem is not None:
            telem.close()
    metrics.fleet_ranges_retired = qs["done"]
    if qs["done"] < m:
        failed = [w for w in workers if w.failed]
        if failed:
            print("Error: fleet run failed: "
                  + "; ".join(w.failed for w in failed)
                  + f" — {qs['done']}/{m} ranges retired; their "
                  "journals and markers are intact; fix the cause and "
                  "re-run the shepherd to resume", file=sys.stderr)
            rcs = {w.failed_rc for w in failed}
            if rcs == {exitcodes.RC_FAILED_HOLES}:
                return exitcodes.RC_FAILED_HOLES
            return exitcodes.RC_FATAL
        # nobody failed: the whole fleet drained away (SIGTERM) with
        # the queue unfinished — resumable, rc 75 like a drained rank
        print(f"[ccsx-tpu-torch] fleet: drained with {qs['done']}/{m} ranges "
              "retired; re-run the same command to resume",
              file=sys.stderr)
        return exitcodes.RC_INTERRUPTED
    if not merge:
        return exitcodes.RC_OK
    try:
        n = merge_shards(out_path, m, expect_table=table)
    except (OSError, ValueError) as e:
        print(f"Error: fleet merge refused: {e}", file=sys.stderr)
        return exitcodes.RC_FATAL
    print(f"[ccsx-tpu-torch] fleet: merged {n} records from {m} leased "
          f"ranges ({hosts} worker(s))", file=sys.stderr)
    shutil.rmtree(d, ignore_errors=True)
    return exitcodes.RC_OK


def fleet_join(d: str, hosts: int,
               env: Optional[dict] = None,
               poll_s: float = 0.25,
               runner_prelude: Optional[str] = None) -> int:
    """`ccsx-tpu-torch shepherd --join <out>.fleet --hosts K`: add K pull
    workers to a RUNNING fleet mid-run.  Subordinate by design — the
    primary scheduler owns expiry and the merge; a joiner just pulls
    from the same queue (its workers' argv comes from fleet.json, so
    the config is exactly the primary's).  Exits 0 when its workers
    finish (the queue drained or was finished by others)."""
    from ccsx_tpu_torch.pipeline import fleet

    state = fleet.load_fleet(d)
    if state is None:
        print(f"Error: {d} has no readable fleet state (is the fleet "
              "running? start one with --fleet-ranges)", file=sys.stderr)
        return exitcodes.RC_FATAL
    base_env = dict(os.environ if env is None else env)
    prelude = (default_prelude() if runner_prelude is None
               else runner_prelude)
    out_path = state["output"]
    procs = []
    logs = []
    for k in range(hosts):
        name = f"j{os.getpid()}w{k}"
        cmd = [sys.executable, "-c", prelude + _RUNNER,
               *state.get("forward", []),
               "--fleet-dir", d, "--fleet-worker", name]
        log_path = f"{out_path}.fleet.{name}.log"
        banner = (f"\n=== fleet join worker {name} @ "
                  f"{time.strftime('%H:%M:%S')} ===\n")
        proc, log = _spawn_worker(cmd, base_env, log_path, banner)
        procs.append(proc)
        logs.append(log)
        print(f"[ccsx-tpu-torch] fleet: joined worker {name} (pid "
              f"{proc.pid}, log {log_path})", file=sys.stderr)
    rc = exitcodes.RC_OK
    try:
        while any(p.poll() is None for p in procs):
            time.sleep(poll_s)
        for p in procs:
            prc = p.returncode
            if prc in (0, exitcodes.RC_INTERRUPTED):
                continue
            if fleet.load_fleet(d) is None:
                # the primary retired the queue, merged, and removed
                # the fleet dir while this worker was mid-pull; its
                # crash is the completion race, not a work failure
                print(f"[ccsx-tpu-torch] fleet: joined worker (pid {p.pid}) "
                      f"exited rc {prc} after the primary merged and "
                      "cleaned up; ignoring", file=sys.stderr)
                continue
            rc = exitcodes.RC_FATAL
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            if log is not None:
                try:
                    log.close()
                except OSError:
                    pass
    return rc


def serve_fleet_run(spool: str, n: int, serve_args: List[str],
                    max_restarts: int = 2,
                    backoff_s: float = 1.0,
                    gateway_port: int = 0,
                    env: Optional[dict] = None,
                    poll_s: float = 0.25,
                    drain_grace_s: float = 30.0,
                    runner_prelude: Optional[str] = None) -> int:
    """`ccsx-tpu-torch shepherd --serve-replicas N ...serve flags...`: run N
    warm serve replicas over ONE job spool (the lease domain,
    pipeline/gateway.py), optionally fronted by the thin gateway.

    The spool itself is what makes this supervision loop simple: a
    replica death loses no jobs — its leases age out and the survivors
    re-acquire them — so the shepherd's only duties are capacity
    (relaunch dead replicas, with backoff, while the budget lasts) and
    lifecycle (SIGTERM here fans out as SIGTERM to every child, each
    drains rc 75 releasing its leases, queued jobs stay in the spool
    for the next start).

    * rc 0 / rc 75 from a replica is a clean exit / voluntary leave —
      not restarted (the operator or its own drain asked for it);
    * rc 2 (deterministic budget abort) is not restartable;
    * any other exit restarts with exponential backoff up to
      ``max_restarts``; an exhausted replica fails the run's rc (1)
      but the SURVIVORS keep serving until drained.
    * the gateway child (``gateway_port`` > 0) is stateless and gets
      the same restart budget; losing it degrades ingress only — the
      replicas keep draining the spool.

    Returns 0 when no child failed — so a SIGTERM to the shepherd, once
    its children have drained (or were SIGKILLed past
    ``drain_grace_s``), ends it rc 0, as the JAX package's does — else
    2 when every failure was a budget abort and 1 otherwise.
    """
    from ccsx_tpu_torch.utils.drain import DrainGuard

    if n < 1:
        print("Error: --serve-replicas needs N >= 1", file=sys.stderr)
        return exitcodes.RC_FATAL
    base_env = dict(os.environ if env is None else env)
    prelude = (default_prelude() if runner_prelude is None
               else runner_prelude)
    try:
        os.makedirs(spool, exist_ok=True)
    except OSError as e:
        print(f"Error: cannot create spool {spool}: {e}",
              file=sys.stderr)
        return exitcodes.RC_FATAL

    def launch(w: _Rank) -> None:
        if w.rank < 0:    # the gateway child
            name = "gateway"
            cmd = [sys.executable, "-c", prelude + _RUNNER, "gateway",
                   "--spool", spool, "--port", str(gateway_port)]
        else:
            name = f"s{w.rank}"
            cmd = [sys.executable, "-c", prelude + _RUNNER, "serve",
                   *serve_args, "--replica-name", name]
        log_path = os.path.join(spool, f"{name}.log")
        banner = (f"\n=== serve-fleet launch {name} attempt "
                  f"{w.attempts} @ {time.strftime('%H:%M:%S')} ===\n")
        w.proc, w.log = _spawn_worker(cmd, dict(base_env), log_path,
                                      banner)
        w.relaunch_at = None
        print(f"[ccsx-tpu-torch] serve-fleet: {name} up (pid {w.proc.pid}, "
              f"attempt {w.attempts}, log {log_path})", file=sys.stderr)

    def close_log(w: _Rank) -> None:
        if w.log is not None:
            try:
                w.log.close()
            except OSError:
                pass
            w.log = None

    replicas = [_Rank(rank=k) for k in range(n)]
    children = list(replicas)
    if gateway_port:
        children.append(_Rank(rank=-1))
    guard = DrainGuard.install()
    try:
        for w in children:
            launch(w)
        while not guard.requested:
            now = time.monotonic()
            if all(w.done for w in replicas):
                break
            for w in children:
                if w.done:
                    continue
                if w.proc is None:
                    if w.relaunch_at is not None and now >= w.relaunch_at:
                        launch(w)
                    continue
                rc = w.proc.poll()
                if rc is None:
                    continue
                name = "gateway" if w.rank < 0 else f"s{w.rank}"
                pid = w.proc.pid
                close_log(w)
                w.proc = None
                if rc not in (0, exitcodes.RC_INTERRUPTED):
                    _blackbox_hint(pid, spool)
                if rc in (0, exitcodes.RC_INTERRUPTED):
                    # clean exit or voluntary drain: the replica's
                    # leases are released, its queued work stays in
                    # the spool — the survivors absorb it
                    w.done = True
                    w.drained = rc == exitcodes.RC_INTERRUPTED
                    print(f"[ccsx-tpu-torch] serve-fleet: {name} left "
                          f"(rc {rc}); spool jobs stay with the "
                          "survivors", file=sys.stderr)
                elif rc == exitcodes.RC_FAILED_HOLES:
                    w.done = True
                    w.failed = (f"{name} aborted on a deterministic "
                                f"budget (rc {rc}); not restartable")
                    w.failed_rc = rc
                    print(f"[ccsx-tpu-torch] serve-fleet: {w.failed}",
                          file=sys.stderr)
                elif w.attempts >= max_restarts:
                    w.done = True
                    w.failed = (f"{name} died (rc {rc}) and exhausted "
                                f"its {max_restarts} restart(s)")
                    w.failed_rc = rc
                    print(f"[ccsx-tpu-torch] serve-fleet: {w.failed}; "
                          "its leased jobs requeue by lease timeout",
                          file=sys.stderr)
                else:
                    w.attempts += 1
                    delay = backoff_s * (2 ** (w.attempts - 1))
                    w.relaunch_at = now + delay
                    print(f"[ccsx-tpu-torch] serve-fleet: {name} died "
                          f"(rc {rc}); relaunching in {delay:g}s "
                          f"(attempt {w.attempts}/{max_restarts}; its "
                          "leased jobs requeue by lease timeout)",
                          file=sys.stderr)
            time.sleep(poll_s)
    finally:
        guard.restore()
        # fan the stop out as SIGTERM — every replica drains (finishes
        # in-flight holes, releases its leases, rc 75) before we give
        # up and SIGKILL stragglers
        live = [w for w in children
                if w.proc is not None and w.proc.poll() is None]
        for w in live:
            try:
                w.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + drain_grace_s
        for w in live:
            try:
                w.proc.wait(timeout=max(0.1, deadline
                                        - time.monotonic()))
            except (OSError, subprocess.TimeoutExpired):
                try:
                    w.proc.kill()
                    w.proc.wait(timeout=10.0)
                except (OSError, subprocess.TimeoutExpired):
                    pass
        for w in children:
            close_log(w)
    failed = [w for w in children if w.failed]
    if failed:
        print("Error: serve-fleet run failed: "
              + "; ".join(w.failed for w in failed)
              + " — the spool keeps every queued/leased job; restart "
              "the fleet to resume", file=sys.stderr)
        rcs = {w.failed_rc for w in failed}
        if rcs == {exitcodes.RC_FAILED_HOLES}:
            return exitcodes.RC_FAILED_HOLES
        return exitcodes.RC_FATAL
    return exitcodes.RC_OK


def _serve_fleet_main(argv) -> int:
    """The --serve-replicas spelling of the shepherd: everything that
    is not a supervisor knob forwards verbatim to each `serve` child
    (which is why this branches BEFORE the ordinary CLI parser — serve
    flags like --fleet/--port are not in its grammar)."""
    p = argparse.ArgumentParser(
        prog="ccsx-tpu-torch shepherd --serve-replicas", add_help=False)
    p.add_argument("--serve-replicas", type=int, dest="n")
    p.add_argument("--gateway-port", type=int, default=0,
                   dest="gateway_port")
    p.add_argument("--max-replica-restarts", type=int, default=2,
                   dest="max_replica_restarts")
    p.add_argument("--replica-backoff", type=float, default=1.0,
                   dest="replica_backoff")
    args, serve_args = p.parse_known_args(argv)
    spool = None
    for i, a in enumerate(serve_args):
        if a == "--fleet" and i + 1 < len(serve_args):
            spool = serve_args[i + 1]
        elif a.startswith("--fleet="):
            spool = a.split("=", 1)[1]
    if not spool:
        print("Error: --serve-replicas requires --fleet SPOOL (the "
              "shared job spool every replica serves)", file=sys.stderr)
        return exitcodes.RC_FATAL
    return serve_fleet_run(
        spool, args.n, serve_args,
        max_restarts=args.max_replica_restarts,
        backoff_s=args.replica_backoff,
        gateway_port=args.gateway_port)


def shepherd_main(argv) -> int:
    """The `ccsx-tpu-torch shepherd` subcommand (dispatched from cli.main):
    the ordinary CLI grammar plus the supervisor knobs; everything
    except the shepherd-only flags forwards verbatim to the ranks."""
    from ccsx_tpu_torch import cli as cli_mod

    if any(a == "--serve-replicas" or a.startswith("--serve-replicas=")
           for a in argv):
        return _serve_fleet_main(argv)

    p = cli_mod.build_parser()
    p.prog = "ccsx-tpu-torch shepherd"
    p.add_argument("--max-rank-restarts", type=int, default=2,
                   dest="max_rank_restarts", metavar="N",
                   help="restarts allowed per rank before the run "
                        "fails [2]")
    p.add_argument("--rank-backoff", type=float, default=1.0,
                   dest="rank_backoff", metavar="SEC",
                   help="restart backoff base (doubles per attempt) "
                        "[1.0]")
    p.add_argument("--rank-stall-timeout", type=float, default=0.0,
                   dest="rank_stall_timeout", metavar="SEC",
                   help="SIGKILL + restart a rank whose progress "
                        "heartbeat (shard journal/output mtimes) goes "
                        "stale this long; 0 disables — size it above "
                        "a rank's start-up (torch, the CUDA context, "
                        "the kernels' load) plus its first retirement, "
                        "or prefer the rank-level --dispatch-deadline; "
                        "only this timeout ends a kernel that never "
                        "does [0]")
    p.add_argument("--fleet-ranges", type=int, default=0,
                   dest="fleet_ranges", metavar="M",
                   help="elastic fleet mode: split the input into M "
                        "leased work-ranges (M >> --hosts) pulled by "
                        "the ranks; a dead rank's ranges requeue to "
                        "the survivors.  0 = classic static "
                        "shard-per-rank supervision [0]")
    p.add_argument("--lease-timeout", type=float, default=10.0,
                   dest="lease_timeout", metavar="SEC",
                   help="fleet mode: expire (SIGKILL + requeue) a "
                        "leased range whose heartbeat goes stale this "
                        "long [10]")
    p.add_argument("--join", default=None, dest="join", metavar="DIR",
                   help="join a RUNNING fleet: launch --hosts extra "
                        "pull workers against DIR (<out>.fleet); the "
                        "primary shepherd keeps owning expiry and the "
                        "merge")
    args = p.parse_args(argv)
    if args.help:
        # the port's CLI has no usage(): its -h prints USAGE, rc 1
        print(cli_mod.USAGE, end="")
        return exitcodes.RC_FATAL
    if args.hosts is None or args.hosts < 1:
        print("Error: shepherd requires --hosts N (>= 1)",
              file=sys.stderr)
        return exitcodes.RC_FATAL
    if args.join:
        # the joiner's workers take their whole argv from fleet.json,
        # so nothing else on this command line applies
        return fleet_join(args.join, args.hosts)
    if args.host_id is not None:
        print("Error: shepherd owns --host-id; do not pass it",
              file=sys.stderr)
        return exitcodes.RC_FATAL
    if args.merge_shards is not None or args.make_index:
        print("Error: shepherd cannot combine with --merge-shards/"
              "--make-index", file=sys.stderr)
        return exitcodes.RC_FATAL
    if args.bam_out:
        print("Error: --bam is not supported with --hosts "
              "(use --fastq and convert the merged output)",
              file=sys.stderr)
        return exitcodes.RC_FATAL
    if args.batch == "off":
        # refused up front: each rank would refuse it anyway, and the
        # shepherd would burn its restart budget on a config error
        print("Error: --batch off is not supported with --hosts",
              file=sys.stderr)
        return exitcodes.RC_FATAL
    if args.input == "-" or args.output == "-":
        print("Error: shepherd needs real INPUT/OUTPUT paths (ranks "
              "re-read the input; shards merge into the output)",
              file=sys.stderr)
        return exitcodes.RC_FATAL
    # validate the shared config once up front (same errors the ranks
    # would produce N times over)
    try:
        cfg = cli_mod.config_from_args(args)
    except SystemExit as e:
        return int(e.code or 0)
    forward = strip_shepherd_flags(list(argv))
    if args.fleet_ranges:
        return fleet_run(
            args.input, args.output, cfg, args.hosts, forward,
            ranges=args.fleet_ranges,
            lease_timeout=args.lease_timeout,
            max_restarts=args.max_rank_restarts,
            backoff_s=args.rank_backoff,
            telemetry_port=args.telemetry_port or 0)
    return shepherd_run(
        args.input, args.output, args.hosts, forward,
        journal=args.journal,
        max_restarts=args.max_rank_restarts,
        backoff_s=args.rank_backoff,
        rank_stall_timeout=args.rank_stall_timeout,
        telemetry_port=args.telemetry_port or 0)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(shepherd_main(sys.argv[1:]))
