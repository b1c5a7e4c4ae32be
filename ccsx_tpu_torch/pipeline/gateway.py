"""Replica fleet plane, part 1: the job spool protocol and the gateway (a
copy of the JAX package's pipeline/gateway.py).

N ``ccsx-tpu-torch serve --fleet <spool>`` replicas share ONE spool
directory as a lease domain (utils/lease.py), and ``ccsx-tpu-torch
gateway`` is the thin balancer in front of them.

**The spool protocol.**  A job is three files in the shared spool:

  job.<jid>.json    the submission record (input path, overrides,
                    cancel/deadline marks), created with the EXCLUSIVE
                    write idiom (utils/journal.py ``write_json_exclusive``),
                    which is also how job ids are allocated: the first
                    submitter to link ``job.j00042.json`` owns j00042;
  lease.<jid>       the work-in-progress lease, carrying the holder
                    replica's identity and telemetry address;
  done.<jid>.json   the EXCLUSIVE retirement marker: terminal state, rc,
                    output path.  Exactly one of any number of racing
                    finishers commits it.

A job's state is DERIVED, never stored mutable: done marker present ->
its terminal state; lease present -> running; cancel mark and no lease ->
cancelling (a scanning replica retires it); else queued.  Replica death is
requeue by construction: the lease expires (or is released), the record
and the job's journal survive in the spool, and the next replica to scan
acquires and RESUMES it.

**Replica discovery.**  Each replica holds a slot lease ``lease.r<k>``
(first free slot wins) and serves HTTP on ``base_port + k``, refreshing
the bound address into the slot record at every heartbeat, so the gateway
and ``top`` find replicas by scanning slot leases, never by probing ports.

**The gateway** routes on the replicas' ``/readyz``: a submission is
written straight into the spool (the spool IS the queue) only while some
replica is ready, 503 + Retry-After when none is, 429 + Retry-After at the
spool-depth cap.  ``/metrics`` serves the fleet-aggregate ``ccsx_fleet_*``
gauges and the replicas' merged latency histograms.

Neither torch nor jax is imported on this path: the gateway must keep
answering while every replica's card is wedged.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional, Tuple

from ccsx_tpu_torch.utils import lease as leaselib
from ccsx_tpu_torch.utils.journal import write_json_atomic, write_json_exclusive

JOB_KEY_RE = re.compile(r"^j\d{5,}$")
SLOT_PREFIX = "r"
# terminal states a done marker may carry
MARKER_STATES = ("done", "failed", "cancelled")


# ---- the spool protocol ---------------------------------------------------

def job_record_path(spool: str, jid: str) -> str:
    return os.path.join(spool, f"job.{jid}.json")


def done_marker_path(spool: str, jid: str) -> str:
    return os.path.join(spool, f"done.{jid}.json")


def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        return {}


def read_job_record(spool: str, jid: str) -> Optional[dict]:
    return _read_json(job_record_path(spool, jid))


def read_done_marker(spool: str, jid: str) -> Optional[dict]:
    return _read_json(done_marker_path(spool, jid))


def list_job_ids(spool: str) -> List[str]:
    out = []
    try:
        names = os.listdir(spool)
    except OSError:
        return out
    for name in names:
        if (name.startswith("job.") and name.endswith(".json")
                and ".tmp" not in name):
            jid = name[len("job."):-len(".json")]
            if JOB_KEY_RE.match(jid):
                out.append(jid)
    return sorted(out)


def job_view(spool: str, jid: str) -> Optional[dict]:
    """The DERIVED state of one spooled job (see module doc): None for
    an unknown id, else a status dict safe to serve from any process
    (gateway, replica, top) without coordination."""
    rec = read_job_record(spool, jid)
    if rec is None:
        return None
    marker = read_done_marker(spool, jid)
    hold = leaselib.read_lease(spool, jid)
    view = {
        "id": jid,
        "input": rec.get("input"),
        "overrides": rec.get("overrides") or {},
        "submitted_at": rec.get("submitted_at"),
        "cancel": bool(rec.get("cancel")),
        "fanout": rec.get("fanout"),
        "cid": rec.get("cid"),
    }
    if marker:
        view.update({
            "state": marker.get("state") or "done",
            "rc": marker.get("rc"),
            "error": marker.get("error"),
            "output": marker.get("output"),
            "replica": marker.get("replica"),
            "finished_at": marker.get("finished_at"),
        })
    elif hold is not None:
        view.update({"state": "running",
                     "replica": (hold or {}).get("replica")
                     or (hold or {}).get("worker")})
    elif rec.get("cancel"):
        view["state"] = "cancelling"
    else:
        view["state"] = "queued"
    return view


def spool_counts(spool: str) -> dict:
    """One scan of the job queue: the fleet-aggregate autoscale
    numbers (same shape as fleet.queue_state for ranges)."""
    queued = leased = retired = cancelling = 0
    for jid in list_job_ids(spool):
        if os.path.exists(done_marker_path(spool, jid)):
            retired += 1
        elif leaselib.read_lease(spool, jid) is not None:
            leased += 1
        elif (read_job_record(spool, jid) or {}).get("cancel"):
            cancelling += 1
        else:
            queued += 1
    return {"queued": queued, "leased": leased, "retired": retired,
            "cancelling": cancelling}


def submit_job(spool: str, input_path: Optional[str] = None,
               body_stream=None, body_len: int = 0,
               overrides: Optional[dict] = None) -> str:
    """Write one job into the spool; returns the allocated id.

    A streamed body is spooled to a submitter-unique upload file and
    fsynced BEFORE the job record exists (a torn upload must never
    leave an acquirable half-job); the record itself is the id
    allocation — ``write_json_exclusive`` on ``job.<jid>.json`` admits
    exactly one claimant per id, so concurrent submitters (N gateway
    threads, N replicas) allocate disjoint ids with no coordinator."""
    overrides = dict(overrides or {})
    os.makedirs(spool, exist_ok=True)
    if body_stream is not None:
        fmt = str(overrides.get("format") or "").lower() or "bam"
        input_path = os.path.join(
            spool, f"upload.{os.getpid()}.{time.monotonic_ns()}.{fmt}")
        with open(input_path, "wb") as f:
            left = int(body_len)
            while left > 0:
                chunk = body_stream.read(min(left, 1 << 16))
                if not chunk:
                    raise ValueError("short request body")
                f.write(chunk)
                left -= len(chunk)
            f.flush()
            os.fsync(f.fileno())
    if not input_path:
        raise ValueError("job needs an input path or a request body")
    # the fleet-wide correlation id is minted HERE, at submission: the
    # one writer that exists before any replica touches the job.  It
    # rides the spool record -> the job lease -> the fan-out fleet
    # state -> every span/metrics event any process emits for this job
    # (utils/trace.cid_scope), and is what `ccsx-tpu-torch report --fleet`
    # stitches the per-process timelines by.
    cid = f"c{os.urandom(6).hex()}"
    rec = {"version": 1, "input": input_path, "overrides": overrides,
           "submitted_at": time.time(), "submitter": os.getpid(),
           "cid": cid}
    existing = list_job_ids(spool)
    seq = (max((int(j[1:]) for j in existing), default=0)) + 1
    while True:
        jid = f"j{seq:05d}"
        if write_json_exclusive(job_record_path(spool, jid), rec):
            return jid
        seq += 1


def mark_cancel(spool: str, jid: str) -> Tuple[str, bool]:
    """Cross-replica cancel: mark the spool record; the holder's next
    heartbeat renewal observes the mark and aborts through its drain
    guard (the job's own drain path).  -> (state, changed);
    KeyError for an unknown id."""
    view = job_view(spool, jid)
    if view is None:
        raise KeyError(jid)
    if view["state"] in MARKER_STATES:
        return view["state"], False
    rec = read_job_record(spool, jid) or {}
    changed = not rec.get("cancel")
    if changed:
        rec["cancel"] = True
        rec["cancel_at"] = time.time()
        write_json_atomic(job_record_path(spool, jid), rec)
    state = "cancelling" if view["state"] != "queued" else "cancelled"
    return state, changed


def mark_deadline(spool: str, jid: str, deadline_s: float) -> bool:
    """Set/tighten a job's wall-clock deadline after submission; the
    holder observes it at its next renewal (same channel as cancel)."""
    rec = read_job_record(spool, jid)
    if rec is None:
        raise KeyError(jid)
    rec.setdefault("overrides", {})["deadline_s"] = float(deadline_s)
    write_json_atomic(job_record_path(spool, jid), rec)
    return True


def retire_job(spool: str, jid: str, state: str, rc: Optional[int],
               replica: str, error: Optional[str] = None,
               output: Optional[str] = None, attempts: int = 0) -> bool:
    """Commit a job's terminal state with the EXCLUSIVE marker fence.
    Returns False when another finisher already retired it — the
    caller (a zombie that survived expiry) must yield to that marker,
    never overwrite it."""
    return write_json_exclusive(done_marker_path(spool, jid), {
        "version": 1, "id": jid, "state": state, "rc": rc,
        "error": error, "output": output, "replica": replica,
        "attempts": attempts, "finished_at": time.time()})


# ---- replica slots (deterministic ports, discovery) -----------------------

def acquire_replica_slot(spool: str, worker: str,
                         extra: Optional[dict] = None,
                         lease_timeout: float = 10.0,
                         max_slots: int = 256) -> Tuple[int, dict]:
    """Claim the first free replica slot ``r<k>`` (expiring stale slot
    leases on the way — a SIGKILLed replica's slot is reusable after
    one timeout).  The slot number IS the port assignment: a replica
    serves on base_port + k, so co-hosted replicas never collide and
    the fleet's ports are knowable from the spool alone."""
    os.makedirs(spool, exist_ok=True)
    for k in range(max_slots):
        key = f"{SLOT_PREFIX}{k}"
        leaselib.expire_lease(spool, key, lease_timeout, kill=False,
                              seq=k)
        rec = leaselib.try_acquire(spool, key, worker,
                                   extra=dict(extra or {}, slot=k),
                                   kind="slot")
        if rec is not None:
            return k, rec
    raise RuntimeError(f"no free replica slot in {spool} "
                       f"(max {max_slots})")


def discover_replicas(spool: str) -> List[dict]:
    """Scan slot leases -> live replica descriptors (the no-guessing
    discovery path for gateway and top)."""
    out = []
    for key, rec in leaselib.list_leases(spool, SLOT_PREFIX):
        if not rec:
            continue  # torn slot lease: a replica died mid-acquire
        out.append({
            "slot": rec.get("slot"),
            "name": rec.get("worker"),
            "addr": rec.get("addr") or "127.0.0.1",
            "port": rec.get("port"),
            "host": rec.get("host"),
            "pid": rec.get("pid"),
            "ready": rec.get("ready"),
            "reason": rec.get("reason"),
            "pressure": rec.get("pressure"),
            "leases": rec.get("leases"),
            "renewed": rec.get("renewed"),
        })
    return out


def replica_endpoints(spool: str) -> List[str]:
    """``addr:port`` for every replica advertising a port — what `top`
    aggregates (any-degraded, like ranks)."""
    return [f"{r['addr']}:{r['port']}" for r in discover_replicas(spool)
            if r.get("port")]


# ---- fleet-aggregate gauges -----------------------------------------------

def fleet_summary(spool: str, replicas: Optional[List[dict]] = None,
                  stale_s: float = 30.0) -> dict:
    """The autoscale signal set: spool/queue depth, leases held, and
    per-replica pressure, aggregated from the spool + slot leases (a
    replica whose heartbeat is older than ``stale_s`` is not counted
    alive).  Rendered as ``ccsx_fleet_*`` by telemetry.
    render_fleet_series — the schema-guarded serve-fleet family."""
    counts = spool_counts(spool)
    if replicas is None:
        replicas = discover_replicas(spool)
    now = time.time()
    alive = [r for r in replicas
             if now - float(r.get("renewed") or 0) < stale_s]
    summary = {
        "fleet_spool_depth": counts["queued"] + counts["cancelling"],
        "fleet_jobs_leased": counts["leased"],
        "fleet_jobs_retired": counts["retired"],
        "fleet_replicas": len(alive),
        "fleet_replicas_ready": sum(1 for r in alive if r.get("ready")),
    }
    per = {}
    for r in alive:
        name = str(r.get("name") or f"slot{r.get('slot')}")
        per[name] = {
            "fleet_window_pressure": float(r.get("pressure") or 0.0),
            "fleet_leases_held": int(r.get("leases") or 0),
        }
    summary["replicas"] = per
    return summary


# ---- the balancer ---------------------------------------------------------

class Gateway:
    """Routing + aggregation state for `ccsx-tpu-torch gateway`.  Readiness
    probes hit each discovered replica's /readyz, cached for
    ``probe_s`` so a scrape storm cannot melt the fleet."""

    def __init__(self, spool: str, max_queue: int = 64,
                 probe_s: float = 1.0, timeout: float = 2.0):
        self.spool = spool
        self.max_queue = max(1, int(max_queue))
        self.probe_s = max(0.05, float(probe_s))
        self.timeout = timeout
        self._lock = threading.Lock()
        self._probed_at = 0.0
        self._probed: List[dict] = []

    def replicas(self) -> List[dict]:
        with self._lock:
            if time.monotonic() - self._probed_at < self.probe_s:
                return list(self._probed)
        reps = discover_replicas(self.spool)
        for r in reps:
            r["reachable"] = False
            if not r.get("port"):
                r["ready"] = False
                continue
            url = f"http://{r['addr']}:{r['port']}/readyz"
            try:
                with urllib.request.urlopen(
                        url, timeout=self.timeout) as resp:
                    body = json.loads(resp.read() or b"{}")
                r["reachable"] = True
            except urllib.error.HTTPError as e:
                # a draining/warming replica answers 503 WITH a body:
                # reachable, just not routable
                try:
                    body = json.loads(e.read() or b"{}")
                except (OSError, ValueError):
                    body = {}
                body.setdefault("ready", False)
                body.setdefault("reason", f"http {e.code}")
                r["reachable"] = True
            except (OSError, ValueError):
                body = {"ready": False, "reason": "unreachable"}
            r["ready"] = bool(body.get("ready"))
            r["reason"] = body.get("reason")
        with self._lock:
            self._probed = reps
            self._probed_at = time.monotonic()
        return list(reps)

    def readiness(self) -> Tuple[bool, str]:
        reps = self.replicas()
        if not reps:
            return False, "no replicas"
        ready = [r for r in reps if r.get("ready")]
        if not ready:
            return False, "all replicas draining or unready"
        return True, f"{len(ready)}/{len(reps)} replicas ready"

    def summary(self) -> dict:
        return fleet_summary(self.spool, replicas=self.replicas())

    def fleet_hist(self) -> dict:
        """Fleet-merged latency histograms: every reachable replica's
        /progress snapshot carries its ``hist`` families; per-`le`
        counts are SUMMED per (family, label) — quantiles do not
        compose, buckets do (utils/metrics.merge_hist).  The merged
        set is what the gateway's /metrics exposes next to the
        ccsx_fleet_* autoscale gauges, so one scrape sees fleet-wide
        queue-wait/job-wall distributions and their SLO burn."""
        from ccsx_tpu_torch.utils.metrics import merge_hist

        per: dict = {}
        for r in self.replicas():
            if not (r.get("reachable") and r.get("port")):
                continue
            url = f"http://{r['addr']}:{r['port']}/progress"
            try:
                with urllib.request.urlopen(
                        url, timeout=self.timeout) as resp:
                    snap = json.loads(resp.read() or b"{}")
            except (OSError, ValueError):
                continue
            hist = snap.get("hist")
            if not isinstance(hist, dict):
                continue
            for fam, series in hist.items():
                if not isinstance(series, dict):
                    continue
                for label, s in series.items():
                    per.setdefault(fam, {}).setdefault(
                        label, []).append(s)
        return {fam: {label: merge_hist(snaps)
                      for label, snaps in series.items()}
                for fam, series in per.items()}

    def submit(self, input_path=None, body_stream=None, body_len=0,
               overrides=None) -> str:
        ready, reason = self.readiness()
        if not ready:
            raise NotReady(reason)
        counts = spool_counts(self.spool)
        depth = counts["queued"] + counts["cancelling"]
        if depth >= self.max_queue:
            raise SpoolFull(
                f"spool depth cap ({depth}/{self.max_queue})")
        return submit_job(self.spool, input_path=input_path,
                          body_stream=body_stream, body_len=body_len,
                          overrides=overrides)


class NotReady(Exception):
    """No replica can take traffic (HTTP 503 + Retry-After)."""


class SpoolFull(Exception):
    """Spool depth cap reached (HTTP 429 + Retry-After)."""


# ---- the HTTP layer -------------------------------------------------------

def _gateway_handler():
    from ccsx_tpu_torch.utils import telemetry

    class _GatewayHandler(telemetry._Handler):
        server_version = "ccsx-tpu-torch-gateway"

        def _gw(self) -> Gateway:
            return self.server.ccsx_gateway  # type: ignore

        def _send_json(self, code: int, obj, extra=None) -> None:
            data = json.dumps(obj, default=str).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (extra or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            self.wfile.write(data)

        def _send_file(self, path: str) -> None:
            try:
                size = os.path.getsize(path)
                f = open(path, "rb")
            except OSError as e:
                self._send_json(404, {"error": f"no output: {e}"})
                return
            with f:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(size))
                self.end_headers()
                while True:
                    chunk = f.read(1 << 16)
                    if not chunk:
                        break
                    self.wfile.write(chunk)

        def do_GET(self):  # noqa: N802
            from ccsx_tpu_torch.utils import telemetry

            gw = self._gw()
            path, _, _q = self.path.partition("?")
            try:
                if path == "/healthz":
                    reps = gw.replicas()
                    self._send_json(200, {
                        "status": "alive", "replicas": len(reps),
                        "ready": sum(1 for r in reps if r.get("ready")),
                        **spool_counts(gw.spool)})
                elif path == "/readyz":
                    ready, reason = gw.readiness()
                    self._send_json(200 if ready else 503,
                                    {"ready": ready, "reason": reason})
                elif path == "/metrics":
                    body = telemetry.render_fleet_series(gw.summary())
                    hist = gw.fleet_hist()
                    hlines = (telemetry.hist_lines(hist)
                              + telemetry.slo_burn_lines(hist))
                    if hlines:
                        body += "\n".join(hlines) + "\n"
                    self._send(200, body,
                               "text/plain; version=0.0.4; "
                               "charset=utf-8")
                elif path == "/replicas":
                    self._send_json(200, {"replicas": gw.replicas()})
                elif path == "/jobs":
                    jobs = [job_view(gw.spool, jid)
                            for jid in list_job_ids(gw.spool)]
                    self._send_json(200, {"jobs": jobs})
                elif path.startswith("/jobs/"):
                    parts = path.split("/")
                    view = job_view(gw.spool, parts[2])
                    if view is None:
                        self._send_json(404, {"error": "unknown job"})
                    elif len(parts) == 3:
                        self._send_json(200, view)
                    elif len(parts) == 4 and parts[3] == "output":
                        if view["state"] != "done":
                            self._send_json(
                                409, {"error": "job not done",
                                      "state": view["state"]})
                        else:
                            self._send_file(view.get("output") or "")
                    else:
                        self._send_json(404, {"error": "unknown path"})
                else:
                    self._send_json(404, {"error": "unknown path"})
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_POST(self):  # noqa: N802
            gw = self._gw()
            path, _, query = self.path.partition("?")
            try:
                if path != "/jobs":
                    self._send_json(404, {"error": "unknown path"})
                    return
                import urllib.parse

                params = {k: v[-1] for k, v in
                          urllib.parse.parse_qs(query).items()}
                length = int(self.headers.get("Content-Length") or 0)
                ctype = (self.headers.get("Content-Type") or
                         "").split(";")[0].strip().lower()
                try:
                    if ctype == "application/json":
                        raw = self.rfile.read(length)
                        body = json.loads(raw or b"{}")
                        if not isinstance(body, dict):
                            raise ValueError(
                                "JSON body must be an object")
                        params.update(body)
                        input_path = params.pop("input", None)
                        jid = gw.submit(input_path=input_path,
                                        overrides=params)
                    else:
                        jid = gw.submit(body_stream=self.rfile,
                                        body_len=length,
                                        overrides=params)
                except NotReady as e:
                    self._send_json(503, {"error": str(e)},
                                    extra={"Retry-After": 5})
                    return
                except SpoolFull as e:
                    self._send_json(429, {"error": str(e)},
                                    extra={"Retry-After": 5})
                    return
                except (ValueError, OSError) as e:
                    self._send_json(400, {"error": str(e)})
                    return
                self._send_json(201, {"id": jid, "state": "queued",
                                      "status": f"/jobs/{jid}",
                                      "output": f"/jobs/{jid}/output"})
            except (BrokenPipeError, ConnectionResetError):
                pass

        def do_DELETE(self):  # noqa: N802
            gw = self._gw()
            path, _, _q = self.path.partition("?")
            try:
                parts = path.split("/")
                if len(parts) != 3 or parts[1] != "jobs":
                    self._send_json(404, {"error": "unknown path"})
                    return
                try:
                    state, changed = mark_cancel(gw.spool, parts[2])
                except KeyError:
                    self._send_json(404, {"error": "unknown job"})
                    return
                self._send_json(200 if changed else 409,
                                {"id": parts[2], "state": state,
                                 "cancelled": changed})
            except (BrokenPipeError, ConnectionResetError):
                pass

    return _GatewayHandler


# ---- the subcommand -------------------------------------------------------

def gateway_main(argv) -> int:
    """`ccsx-tpu-torch gateway`: the thin balancer over one serve-fleet
    spool.  No torch, no compute — it keeps routing while every
    replica's backend is wedged."""
    import argparse

    from ccsx_tpu_torch.utils import telemetry
    from ccsx_tpu_torch.utils.drain import DrainGuard
    from ccsx_tpu_torch.utils.metrics import Metrics

    ap = argparse.ArgumentParser(
        prog="ccsx-tpu-torch gateway",
        description="Balancer/aggregator for `ccsx-tpu-torch serve --fleet` "
                    "replicas sharing one job spool: health-routed "
                    "submission, fleet job API, ccsx_fleet_* autoscale "
                    "gauges.")
    ap.add_argument("--spool", required=True,
                    help="the shared fleet spool directory (same "
                         "--fleet the replicas serve)")
    ap.add_argument("--port", type=int, default=8850,
                    help="HTTP port (auto-bumps when taken; 0 = "
                         "ephemeral) [8850]")
    ap.add_argument("--gw-host", default="",
                    help="bind host [CCSX_TELEMETRY_HOST or 0.0.0.0]")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="spool-depth cap; submissions beyond it get "
                         "429 + Retry-After [64]")
    ap.add_argument("--probe", type=float, default=1.0,
                    help="replica /readyz probe cache seconds [1.0]")
    a = ap.parse_args(argv)
    gw = Gateway(a.spool, max_queue=a.max_queue, probe_s=a.probe)
    guard = DrainGuard.install()
    try:
        srv = telemetry.TelemetryServer(
            Metrics(verbose=0, stream=None), a.port, host=a.gw_host,
            handler=_gateway_handler(),
            attrs={"ccsx_gateway": gw, "ccsx_ready": gw.readiness})
    except OSError as e:
        print(f"Error: gateway: {e}", file=sys.stderr)
        guard.restore()
        return 1
    print(f"[ccsx-tpu-torch] gateway: http://{srv.host}:{srv.port} "
          f"(spool {a.spool}; POST /jobs, /readyz, /metrics, "
          "/replicas)", file=sys.stderr)
    try:
        while not guard.requested:
            time.sleep(0.2)
    finally:
        srv.close()
        guard.restore()
    return 0
