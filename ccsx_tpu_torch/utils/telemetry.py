"""Live telemetry plane: /metrics, /healthz, /progress and
`ccsx-tpu-torch top` (a copy of the JAX package's utils/telemetry.py; the
port's step counters join ``PROM_COUNTERS``).

* **TelemetryServer** (``--telemetry-port``, 0 = off): a daemon thread
  serving, straight off the run's live ``Metrics`` object,

  - ``GET /metrics``  — Prometheus text format rendered from
    ``Metrics.snapshot()`` (every numeric counter, the per-shape-group
    table as labeled series, the progress/ETA estimate, and the
    resource gauges);
  - ``GET /healthz``  — JSON ``ok`` (HTTP 200) or ``degraded`` (HTTP
    503, wired to the stall watchdog's mark) with the rc-relevant
    detail: stalls, oom_resplits, host_fallbacks, holes_failed;
  - ``GET /progress`` — the full snapshot as JSON (what ``top`` polls).

  The port auto-bumps when taken (up to ``PORT_TRIES`` upward probes —
  several ranks or runs on one host each get the next free port, and
  sharded runs additionally offset by rank, parallel/distributed.py).
  Serving is pull-only: no scrape, no work.

* **`ccsx-tpu-torch top`** — a curses-free ANSI live dashboard over one
  or more sources, each either a telemetry endpoint (``host:port`` /
  ``http://...``) or a ``--metrics`` JSONL path tailed for the last
  event (endpoint-less runs).  Multi-rank aggregation: counters SUM,
  progress is the MINIMUM rank pct (the merge waits for the slowest
  shard), rates sum, and one degraded rank degrades the aggregate.

* **Schema contract**: the module-level key tuples below are the ONE
  declaration of which ``Metrics.snapshot()`` keys the telemetry plane
  consumes; ``tests/test_torch_telemetry.py`` cross-checks them against
  a populated ``RunMetrics`` snapshot in both directions, so a renamed
  counter cannot silently zero a dashboard column (or vanish from
  /metrics).

Neither torch nor jax is imported here: ``top`` runs on a host whose card
is wedged.  No third-party dependencies: http.server + urllib only.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from ccsx_tpu_torch.utils.metrics import (HIST_BUCKETS, Metrics, hist_quantile,
                                    merge_hist, resource_gauges)

# upward probes for a taken port: rank offsets + parallel runs on one
# host land on distinct ports without operator bookkeeping
PORT_TRIES = 32

# ---- the schema contract (see module docstring) ---------------------------
# snapshot keys exported to Prometheus as monotone counters
PROM_COUNTERS = (
    "holes_in", "holes_out", "holes_failed", "holes_filtered",
    "holes_corrupt", "stalls",
    "windows", "pair_alignments", "device_dispatches", "refine_overflows",
    # pre-alignment plane (ops/sketch.py + ops/seed_device.py): screen
    # coverage/rejections and the device-vs-host seeding split
    "pairs_screened", "pairs_prefiltered",
    "pairs_seeded_device", "pairs_seeded_host",
    "oom_resplits", "host_fallbacks", "compile_fallbacks",
    # resilient execution (pipeline/resilience.py): abandoned
    # dispatches + circuit-breaker trips and half-open probes
    "device_hangs", "breaker_trips", "breaker_probes",
    "dp_cells_real", "dp_cells_padded", "distinct_slab_shapes",
    "fused_waves", "ingest_bytes",
    # elastic fleet plane (pipeline/fleet.py): retired ranges, expired/
    # reclaimed leases, and reap-time rebalance sweeps
    "fleet_ranges_retired", "fleet_steals", "fleet_rebalances",
    # the port's own driver steps (utils/run_metrics.PORT_KEYS): packed
    # slabs, bucketed groups and their steps, bare-round groups, device
    # seed and screen steps, the walk's local-fill groups, and batched
    # steps replayed one request at a time
    "slabs", "bucketed_groups", "bucketed_dispatches", "round_groups",
    "seed_steps", "screen_steps", "pair_fills", "failed_steps",
)
# snapshot keys exported as gauges (ratios, seconds, rates)
PROM_GAUGES = (
    "dp_occupancy", "dp_round_occupancy", "dp_length_fill",
    "dp_pass_fill", "dp_z_fill", "dp_row_fill", "prefilter_share",
    "packed_holes_per_dispatch", "fused_slot_fill",
    "ingest_s", "prep_s", "compute_s", "write_s", "elapsed_s",
    "zmws_per_sec", "compile_s", "compile_share",
    # prep plane (pipeline/prep_pool.py): critical-path prep exposure,
    # overlap quality, and the live ready-queue gauges
    "prep_blocked_s", "prep_share", "prep_overlap_share",
    "prep_queue_depth", "prep_queue_peak", "prep_threads",
    # elastic fleet plane: live leased-range queue + fleet membership
    "fleet_ranges_total", "fleet_ranges_queued", "fleet_ranges_leased",
    "fleet_ranks_alive",
    # static-analysis plane (ccsx_tpu_torch/lint/): unsuppressed findings a
    # supervisor published via `ccsx-tpu lint --gauge-file`; None
    # (unpopulated) in runs that never lint
    "lint_findings",
)
# snapshot keys with dedicated (non-scalar) renderings
PROM_STRUCTURED = ("groups", "groups_forced", "degraded", "progress",
                   "filtered_reasons", "corrupt_reasons",
                   # per-implementation banded DP-fill attribution
                   # (ccsx_banded_impl{impl=...}): scan/pallas/rotband
                   "banded_dispatches",
                   "breaker_state", "breaker_strike_log",
                   # failed native .so auto-rebuild (string detail;
                   # rendered as a 0/1 gauge like degraded)
                   "native_build_error",
                   # multi-tenant/fleet identity labels (serve plane):
                   # the job id and the fleet-wide correlation id ride
                   # snapshots as strings, never as scalar samples
                   "job", "cid",
                   # latency histograms (HIST_FAMILIES below renders
                   # them as _bucket/_sum/_count families)
                   "hist")

# latency-histogram families: (snapshot family name, label
# key, Prometheus family name).  The snapshot side lives under
# snap["hist"][<family>][<label>] (Metrics.observe); the exposition
# side renders cumulative `le` buckets + +Inf + _sum/_count per label.
# Schema-guarded BOTH directions (tests/test_telemetry.py): a family
# renamed in Metrics cannot silently vanish from /metrics, and a new
# snapshot family cannot ship unrendered.
HIST_FAMILIES = (
    ("queue_wait_s", "size", "queue_wait_seconds"),
    ("job_wall_s", "size", "job_wall_seconds"),
    ("first_dispatch_s", "size", "first_dispatch_seconds"),
    ("device_execute_s", "group", "device_execute_seconds"),
    ("lease_acquire_s", "kind", "lease_acquire_seconds"),
)

# derived SLO burn gauges: (gauge name, histogram family, threshold
# seconds — MUST be one of metrics.HIST_BUCKETS so the "fraction over
# threshold" is exact, not interpolated — and the objective).  burn =
# (fraction of observations over threshold) / (1 - objective): 1.0
# means the error budget is being spent exactly at the sustainable
# rate, >1 means the SLO is burning down.  Served from every /metrics
# that renders histograms, most usefully the gateway's fleet-merged
# view (alongside the ccsx_fleet_* autoscale set).
SLO_BURN_GAUGES = (
    ("slo_queue_wait_burn", "queue_wait_s", 1.0, 0.95),
    ("slo_job_wall_burn", "job_wall_s", 60.0, 0.99),
)
# per-group table fields exported as ccsx_group_<field>{group="..."}
GROUP_FIELDS = ("compiles", "compile_s", "execute_s", "dispatches",
                "dp_cells", "dp_cells_per_sec")
# progress-estimator fields (Metrics.progress_snapshot)
PROGRESS_KEYS = ("done", "total", "rate_zmws_per_sec", "elapsed_s",
                 "pct", "eta_s")
# snapshot counters `top` SUMS across ranks
TOP_SUM_KEYS = (
    "holes_in", "holes_out", "holes_failed", "holes_filtered",
    "holes_corrupt", "stalls",
    "windows", "device_dispatches", "oom_resplits", "host_fallbacks",
    "refine_overflows", "device_hangs", "breaker_trips", "ingest_bytes",
    "fleet_ranges_total", "fleet_ranges_queued", "fleet_ranges_leased",
    "fleet_ranges_retired", "fleet_ranks_alive", "fleet_steals",
    "fleet_rebalances",
)
# /healthz detail fields (rc-relevant: what an operator triages by)
HEALTH_DETAIL_KEYS = ("stalls", "oom_resplits", "host_fallbacks",
                      "holes_failed", "holes_corrupt",
                      "compile_fallbacks",
                      "refine_overflows", "device_hangs",
                      "breaker_trips", "breaker_state")
# per-job labeled series the serving plane (pipeline/serve.py) exports
# as ccsx_job_<key>{job="..."} from each job's own Metrics snapshot —
# the fault-domain counters an operator triages a tenant by.  Schema-
# guarded like the tuples above (tests/test_serve.py cross-checks them
# against a populated snapshot).
JOB_PROM_COUNTERS = (
    "holes_in", "holes_out", "holes_failed", "holes_filtered",
    "holes_corrupt", "device_hangs", "breaker_trips", "oom_resplits",
    "host_fallbacks",
)
JOB_PROM_GAUGES = ("zmws_per_sec", "elapsed_s")
# serve-fleet autoscale gauges the gateway exports (ccsx_fleet_*):
# fleet-wide scalars from the job spool + replica slot leases
# (pipeline/gateway.py fleet_summary), and per-replica labeled gauges
# ({replica="..."}).  Schema-guarded like the tuples above
# (tests/test_serve_fleet.py cross-checks the renderer both ways).
FLEET_SERVE_GAUGES = (
    "fleet_spool_depth", "fleet_jobs_leased", "fleet_jobs_retired",
    "fleet_replicas", "fleet_replicas_ready",
)
FLEET_REPLICA_GAUGES = ("fleet_window_pressure", "fleet_leases_held")


# ---- Prometheus text rendering --------------------------------------------

def _prom_escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _num(v):
    """Prometheus sample value, or None to skip (snapshot ratios are
    None until their denominators move)."""
    if v is None or isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return v


def _fmt_le(b: float) -> str:
    return format(b, "g")


def hist_lines(hist: dict) -> List[str]:
    """Render snap["hist"] (family -> label -> {counts, sum, count})
    into well-formed Prometheus histogram families: ONE TYPE line per
    family, cumulative `le` buckets ending in +Inf, and _sum/_count per
    label — the exposition shape promtool and histogram_quantile()
    expect.  Families are emitted in HIST_FAMILIES order; snapshot
    families outside the contract are skipped (the schema guard keeps
    that set empty)."""
    lines: List[str] = []
    for fam, label_key, prom in HIST_FAMILIES:
        series = (hist or {}).get(fam)
        if not series:
            continue
        lines.append(f"# TYPE ccsx_{prom} histogram")
        for label, h in sorted(series.items()):
            counts = h.get("counts") or []
            if len(counts) != len(HIST_BUCKETS) + 1:
                continue
            base = (f'{label_key}="{_prom_escape(label)}",'
                    if label else "")
            cum = 0
            for i, b in enumerate(HIST_BUCKETS):
                cum += int(counts[i])
                lines.append(f'ccsx_{prom}_bucket{{{base}le="{_fmt_le(b)}"}}'
                             f" {cum}")
            cum += int(counts[-1])
            lines.append(f'ccsx_{prom}_bucket{{{base}le="+Inf"}} {cum}')
            lab = f'{{{base[:-1]}}}' if label else ""
            lines.append(f"ccsx_{prom}_sum{lab} {h.get('sum', 0)}")
            lines.append(f"ccsx_{prom}_count{lab} {cum}")
    return lines


def merged_family(hist: dict, fam: str) -> dict:
    """One family's label series merged into a single histogram
    snapshot (summing per-`le` counts — the only legal merge)."""
    return merge_hist(list((hist or {}).get(fam, {}).values()))


def slo_burn_lines(hist: dict) -> List[str]:
    """The derived SLO burn gauges over a (possibly fleet-merged)
    histogram snapshot.  A family with no observations emits nothing —
    an idle fleet has no burn, not burn 0 vs NaN ambiguity."""
    lines: List[str] = []
    for gauge, fam, threshold, objective in SLO_BURN_GAUGES:
        m = merged_family(hist, fam)
        total = m["count"]
        if not total:
            continue
        cum = 0
        for i, b in enumerate(HIST_BUCKETS):
            cum += m["counts"][i]
            if b >= threshold:
                break
        frac_over = (total - cum) / total
        burn = frac_over / (1.0 - objective)
        lines.append(f"# TYPE ccsx_{gauge} gauge")
        lines.append(f"ccsx_{gauge} {round(burn, 6)}")
    return lines


def render_prometheus(snap: dict, gauges: Optional[dict] = None) -> str:
    """Metrics.snapshot() -> Prometheus text exposition format."""
    lines: List[str] = []
    typed: set = set()

    def sample(name, value, typ, labels=""):
        v = _num(value)
        if v is None:
            return
        if name not in typed:
            # exactly ONE TYPE line per metric family: strict
            # exposition-format parsers reject a scrape with a second
            # TYPE line, which labeled families (groups, reasons)
            # would otherwise emit per sample
            typed.add(name)
            lines.append(f"# TYPE ccsx_{name} {typ}")
        lines.append(f"ccsx_{name}{labels} {v}")

    for key in PROM_COUNTERS:
        sample(key, snap.get(key), "counter")
    for key in PROM_GAUGES:
        sample(key, snap.get(key), "gauge")
    prog = snap.get("progress") or {}
    for key in PROGRESS_KEYS:
        sample(f"progress_{key}", prog.get(key), "gauge")
    for reason, n in sorted((snap.get("filtered_reasons") or {}).items()):
        sample("filtered_reason", n, "counter",
               labels=f'{{reason="{_prom_escape(reason)}"}}')
    # salvage-mode input corruption, bucketed by the pinned taxonomy
    # (io/corruption.py REASONS)
    for reason, n in sorted((snap.get("corrupt_reasons") or {}).items()):
        sample("corrupt_reason", n, "counter",
               labels=f'{{reason="{_prom_escape(reason)}"}}')
    # banded DP-fill dispatches by implementation (consensus/star.
    # banded_impl three-way: scan / pallas / rotband)
    for impl, n in sorted((snap.get("banded_dispatches") or {}).items()):
        sample("banded_impl", n, "counter",
               labels=f'{{impl="{_prom_escape(impl)}"}}')
    for gkey, st in sorted((snap.get("groups") or {}).items()):
        labels = f'{{group="{_prom_escape(gkey)}"}}'
        for f in GROUP_FIELDS:
            sample(f"group_{f}", st.get(f), "counter"
                   if f in ("compiles", "dispatches", "dp_cells")
                   else "gauge", labels=labels)
    if "groups_forced" in snap:
        sample("groups_forced", int(bool(snap["groups_forced"])), "gauge")
    sample("degraded", int(bool(snap.get("degraded"))), "gauge")
    sample("native_build_error",
           int(bool(snap.get("native_build_error"))), "gauge")
    # circuit-breaker state as a labeled gauge: exactly one sample, its
    # label naming the current state (closed / open / half-open) — the
    # alerting-friendly rendering (breaker_strike_log stays JSON-only:
    # /progress carries it verbatim)
    state = snap.get("breaker_state")
    if state:
        sample("breaker_state", 1, "gauge",
               labels=f'{{state="{_prom_escape(state)}"}}')
    for key, v in sorted((gauges or {}).items()):
        sample(key, v, "gauge")
    hist = snap.get("hist")
    if hist:
        lines.extend(hist_lines(hist))
        lines.extend(slo_burn_lines(hist))
    return "\n".join(lines) + "\n"


def health_payload(snap: dict) -> dict:
    """The /healthz body: ok/degraded + the rc-relevant detail."""
    degraded = snap.get("degraded")
    return {
        "status": "degraded" if degraded else "ok",
        "degraded": degraded,
        "detail": {k: snap.get(k, 0) for k in HEALTH_DETAIL_KEYS},
    }


def render_job_series(jobs: dict) -> str:
    """Per-job labeled Prometheus series for the serving plane:
    ``jobs`` maps job id -> that job's ``Metrics.snapshot()``.  Every
    family is declared once (TYPE line) then sampled per job — the
    multi-tenant view of the same counters render_prometheus exports
    for a single run."""
    lines: List[str] = []
    typed: set = set()

    def sample(name, value, typ, labels):
        v = _num(value)
        if v is None:
            return
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE ccsx_job_{name} {typ}")
        lines.append(f"ccsx_job_{name}{labels} {v}")

    for jid, snap in sorted(jobs.items()):
        labels = f'{{job="{_prom_escape(jid)}"}}'
        for key in JOB_PROM_COUNTERS:
            sample(key, (snap or {}).get(key), "counter", labels)
        for key in JOB_PROM_GAUGES:
            sample(key, (snap or {}).get(key), "gauge", labels)
        if (snap or {}).get("degraded"):
            sample("degraded", 1, "gauge", labels)
    return ("\n".join(lines) + "\n") if lines else ""


def render_fleet_series(summary: dict) -> str:
    """The serve-fleet autoscale gauges (``summary`` is pipeline/
    gateway.fleet_summary's output): fleet-wide scalars from
    FLEET_SERVE_GAUGES, then the per-replica FLEET_REPLICA_GAUGES
    labeled ``{replica="..."}`` — the signals an autoscaler sizes the
    replica count by."""
    lines: List[str] = []
    for key in FLEET_SERVE_GAUGES:
        v = _num(summary.get(key))
        if v is None:
            continue
        lines.append(f"# TYPE ccsx_{key} gauge")
        lines.append(f"ccsx_{key} {v}")
    typed: set = set()
    for name, per in sorted((summary.get("replicas") or {}).items()):
        labels = f'{{replica="{_prom_escape(name)}"}}'
        for key in FLEET_REPLICA_GAUGES:
            v = _num((per or {}).get(key))
            if v is None:
                continue
            if key not in typed:
                typed.add(key)
                lines.append(f"# TYPE ccsx_{key} gauge")
            lines.append(f"ccsx_{key}{labels} {v}")
    return ("\n".join(lines) + "\n") if lines else ""


# ---- the endpoint server --------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    # one scrape must never block the next: each request runs on its
    # own daemon thread (ThreadingHTTPServer below)
    protocol_version = "HTTP/1.1"

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (http.server API)
        metrics: Metrics = self.server.ccsx_metrics  # type: ignore
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._send(200,
                           render_prometheus(metrics.snapshot(),
                                             resource_gauges()),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/healthz":
                h = health_payload(metrics.snapshot())
                self._send(200 if h["status"] == "ok" else 503,
                           json.dumps(h), "application/json")
            elif path == "/readyz":
                # liveness-vs-readiness split: /readyz answers "route
                # traffic here?" — the serving plane hangs its warmup/
                # drain state on ``ccsx_ready`` (a () -> (bool, reason)
                # attribute on the server); a plain run's readiness is
                # its health (degraded = do not route)
                ready_fn = getattr(self.server, "ccsx_ready", None)
                if ready_fn is not None:
                    ready, reason = ready_fn()
                else:
                    snap = metrics.snapshot()
                    ready = not snap.get("degraded")
                    reason = snap.get("degraded")
                self._send(200 if ready else 503,
                           json.dumps({"ready": bool(ready),
                                       "reason": reason}),
                           "application/json")
            elif path in ("/progress", "/"):
                snap = metrics.snapshot()
                snap["status"] = ("degraded" if snap.get("degraded")
                                  else "ok")
                self._send(200, json.dumps(snap, default=str),
                           "application/json")
            else:
                self._send(404, json.dumps(
                    {"error": "unknown path", "paths":
                     ["/metrics", "/healthz", "/readyz", "/progress"]}),
                    "application/json")
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper went away mid-response

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # detect taken ports honestly: SO_REUSEADDR would bind "over" a
    # live sibling server and silently steal/merge scrapes instead of
    # auto-bumping to the next port
    allow_reuse_address = False


class TelemetryServer:
    """The live endpoint daemon for one run's Metrics object.

    Binds the first free port in [port, port + PORT_TRIES); raises
    OSError when all are taken (callers should prefer ``start()``,
    which degrades to a warning — telemetry must never kill a run).
    """

    def __init__(self, metrics: Metrics, port: int, host: str = "",
                 handler=None, attrs: Optional[dict] = None):
        self.host = host or os.environ.get("CCSX_TELEMETRY_HOST",
                                           "0.0.0.0")
        err: Optional[Exception] = None
        self._srv = None
        # clamp the probe window to valid ports: a rank-offset base near
        # the top (distributed.py adds rank) must degrade, not crash —
        # socket raises OverflowError (not OSError) past 65535.
        # ``handler``/``attrs`` are the serving plane's extension point
        # (pipeline/serve.py mounts its job API on this same stack);
        # port 0 binds one ephemeral port, for embedded/test servers.
        handler = handler or _Handler
        for p in range(min(port, 65536),
                       min(max(port + PORT_TRIES, 1), 65536)):
            try:
                self._srv = _Server((self.host, p), handler)
                break
            except (OSError, OverflowError) as e:
                err = e
        if self._srv is None:
            raise OSError(
                f"telemetry: no free port in [{port}, "
                f"{min(port + PORT_TRIES, 65536)}): {err}")
        self._srv.ccsx_metrics = metrics  # type: ignore[attr-defined]
        for k, v in (attrs or {}).items():
            setattr(self._srv, k, v)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name="ccsx-telemetry",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        srv, self._srv = self._srv, None
        if srv is None:
            return
        srv.shutdown()
        srv.server_close()
        self._thread.join(timeout=10.0)


def start(metrics: Metrics, port: int) -> Optional[TelemetryServer]:
    """Start the endpoint server (None when port is 0/None, or — with a
    stderr warning — when no port could be bound: observability must
    never take the run down with it)."""
    if not port:
        return None
    try:
        srv = TelemetryServer(metrics, int(port))
    except OSError as e:
        print(f"[ccsx-tpu-torch] telemetry disabled: {e}", file=sys.stderr)
        return None
    print(f"[ccsx-tpu-torch] telemetry: http://{srv.host}:{srv.port} "
          "(/metrics /healthz /readyz /progress)", file=sys.stderr)
    return srv


# ---- source reading (`top`) -----------------------------------------------

def _fetch_endpoint(url: str, timeout: float) -> dict:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8"))


def tail_metrics_jsonl(path: str, max_bytes: int = 262144):
    """Last parseable metrics event of a JSONL file (None when none):
    the endpoint-less source mode.  Reads only the file tail, so
    tailing a million-hole stream costs one seek, not one parse."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(size - max_bytes, 0))
        chunk = f.read().decode("utf-8", "replace")
    for line in reversed(chunk.splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn first line of the tail window / mid-write
        if isinstance(rec, dict) and "event" in rec:
            return rec
    return None


def expand_sources(sources: List[str]) -> List[str]:
    """A DIRECTORY source is a serve-fleet spool: expand it to the
    replica endpoints advertised in its slot leases (pipeline/
    gateway.replica_endpoints), re-discovered on every refresh so a
    replica join/death shows up within one frame.  A spool with no
    live replicas contributes a sentinel source that renders
    unreachable — an empty fleet must look DOWN, not like an empty
    argument list."""
    out: List[str] = []
    for src in sources:
        if os.path.isdir(src):
            from ccsx_tpu_torch.pipeline.gateway import replica_endpoints

            eps = replica_endpoints(src)
            out.extend(eps if eps else [os.path.join(src, "<no-replicas>")])
        else:
            out.append(src)
    return out


def read_source(src: str, timeout: float = 2.0) -> dict:
    """One `top` source -> {source, status, snap, event?, error?}.

    ``src`` is a telemetry endpoint (``host:port`` or an http URL) or a
    path to a ``--metrics`` JSONL file.  status: ok | degraded |
    unreachable (endpoint down / file unreadable — rendered loudly, a
    dead rank is exactly what the operator must see).
    """
    out = {"source": src, "status": "unreachable", "snap": None}
    if "://" in src or (":" in src and not os.path.exists(src)):
        url = src if "://" in src else f"http://{src}"
        try:
            snap = _fetch_endpoint(url.rstrip("/") + "/progress", timeout)
        except (OSError, ValueError) as e:
            out["error"] = str(e)
            return out
    else:
        try:
            snap = tail_metrics_jsonl(src)
        except OSError as e:
            out["error"] = str(e)
            return out
        if snap is None:
            out["error"] = "no metrics events yet"
            return out
        out["event"] = snap.get("event")
    out["snap"] = snap
    out["status"] = "degraded" if snap.get("degraded") else "ok"
    if out.get("event") == "final":
        out["status"] = ("finished-degraded" if snap.get("degraded")
                         else "finished")
    return out


def aggregate(sources: List[dict]) -> dict:
    """Multi-rank aggregate over read_source() results: counters SUM,
    progress pct is the MIN across ranks (the merge waits for the
    slowest shard), rates sum, ETA is the max, and any degraded or
    unreachable rank degrades the whole."""
    live = [s for s in sources if s.get("snap")]
    agg = {"sources": len(sources), "live": len(live),
           "unreachable": len(sources) - len(live)}
    for k in TOP_SUM_KEYS:
        agg[k] = sum(int(s["snap"].get(k) or 0) for s in live)
    agg["zmws_per_sec"] = round(
        sum(float(s["snap"].get("zmws_per_sec") or 0.0) for s in live), 3)
    progs = [s["snap"].get("progress") or {} for s in live]
    agg["rate_zmws_per_sec"] = round(
        sum(float(p.get("rate_zmws_per_sec") or 0.0) for p in progs), 3)
    agg["done"] = sum(int(p.get("done") or 0) for p in progs)
    totals = [p.get("total") for p in progs]
    agg["total"] = (sum(totals) if progs and all(totals) else None)
    pcts = [p["pct"] for p in progs if p.get("pct") is not None]
    agg["pct"] = min(pcts) if pcts and len(pcts) == len(live) else None
    etas = [p["eta_s"] for p in progs if p.get("eta_s") is not None]
    agg["eta_s"] = max(etas) if etas else None
    degraded = [s for s in live if s["snap"].get("degraded")]
    agg["any_degraded"] = bool(degraded) or agg["unreachable"] > 0
    agg["degraded_sources"] = [s["source"] for s in degraded]
    finished = [s for s in live
                if str(s.get("status", "")).startswith("finished")]
    agg["finished"] = bool(sources) and len(finished) == len(sources)
    # latency histograms: merge per-(family, label) by SUMMING per-`le`
    # bucket counts — never by averaging per-source quantiles, which do
    # not compose (two sources at p95=1s can have a fleet p95 of 10s)
    hists = [s["snap"].get("hist") or {} for s in live]
    merged: dict = {}
    for fam, _label_key, _prom in HIST_FAMILIES:
        labels = set()
        for h in hists:
            labels.update(h.get(fam) or {})
        if labels:
            merged[fam] = {
                lbl: merge_hist([(h.get(fam) or {}).get(lbl)
                                 for h in hists
                                 if (h.get(fam) or {}).get(lbl)])
                for lbl in sorted(labels)}
    agg["hist"] = merged
    for fam, key in (("queue_wait_s", "queue_wait"),
                     ("job_wall_s", "job_wall")):
        m = merged_family(merged, fam)
        agg[f"{key}_p50"] = hist_quantile(m, 0.5)
        agg[f"{key}_p95"] = hist_quantile(m, 0.95)
    return agg


# ---- `ccsx-tpu top` rendering ---------------------------------------------

_RED, _GREEN, _YELLOW, _DIM, _BOLD, _RESET = (
    "\x1b[31m", "\x1b[32m", "\x1b[33m", "\x1b[2m", "\x1b[1m", "\x1b[0m")


def _fmt_eta(s) -> str:
    if s is None:
        return "-"
    s = int(s)
    if s >= 3600:
        return f"{s // 3600}h{(s % 3600) // 60:02d}m"
    if s >= 60:
        return f"{s // 60}m{s % 60:02d}s"
    return f"{s}s"


def _fmt_q(v) -> str:
    """Compact quantile seconds for the top table ('-' when absent)."""
    if v is None:
        return "-"
    return f"{v:.2f}" if v < 10 else f"{v:.0f}"


def _source_quantiles(snap: dict, fam: str):
    """(p50, p95) of one source's family, labels merged (None, None
    when the source has no observations — plain runs, gateways)."""
    m = merged_family(snap.get("hist") or {}, fam)
    if not m["count"]:
        return None, None
    return hist_quantile(m, 0.5), hist_quantile(m, 0.95)


def _bar(pct, width: int = 24) -> str:
    if pct is None:
        return "[" + "?" * width + "]"
    filled = int(round(pct / 100.0 * width))
    return "[" + "#" * filled + "." * (width - filled) + "]"


def render_top(sources: List[dict], agg: dict, color: bool = True) -> str:
    """One dashboard frame (plain ANSI, no curses)."""
    def c(code, s):
        return f"{code}{s}{_RESET}" if color else str(s)

    now = time.strftime("%H:%M:%S")
    if agg["any_degraded"]:
        # degraded outranks finished: a run that completed with a
        # tripped watchdog must not headline green
        state = c(_RED + _BOLD, "FINISHED DEGRADED"
                  if agg.get("finished") else "DEGRADED")
    elif agg.get("finished"):
        state = c(_GREEN, "FINISHED")
    else:
        state = c(_GREEN, "RUNNING ok")
    lines = [
        c(_BOLD, f"ccsx-tpu top — {agg['sources']} source(s) — {now}")
        + f"   {state}",
        f"  holes: in {agg['holes_in']}  out {agg['holes_out']}  "
        f"failed {agg['holes_failed']}  filtered {agg['holes_filtered']}"
        f"   windows {agg['windows']}  dispatches "
        f"{agg['device_dispatches']}",
        f"  rate {agg['rate_zmws_per_sec']} zmw/s   "
        + _bar(agg["pct"])
        + (f" {agg['pct']:.1f}%  of {agg['total']}  "
           f"eta {_fmt_eta(agg['eta_s'])}" if agg["pct"] is not None
           else " total unknown — rate only"),
    ]
    if agg.get("fleet_ranges_total"):
        lines.append(
            f"  fleet: ranges {agg['fleet_ranges_retired']}"
            f"/{agg['fleet_ranges_total']} retired  "
            f"queued {agg['fleet_ranges_queued']}  "
            f"leased {agg['fleet_ranges_leased']}  "
            f"ranks {agg['fleet_ranks_alive']}  "
            f"steals {agg['fleet_steals']}  "
            f"rebalances {agg['fleet_rebalances']}")
    if (agg["stalls"] or agg["oom_resplits"] or agg["host_fallbacks"]
            or agg["holes_failed"] or agg["device_hangs"]
            or agg["breaker_trips"]):
        lines.append(c(_YELLOW,
                       f"  incidents: stalls {agg['stalls']}  "
                       f"oom_resplits {agg['oom_resplits']}  "
                       f"host_fallbacks {agg['host_fallbacks']}  "
                       f"holes_failed {agg['holes_failed']}  "
                       f"device_hangs {agg['device_hangs']}  "
                       f"breaker_trips {agg['breaker_trips']}"))
    if (agg.get("queue_wait_p50") is not None
            or agg.get("job_wall_p50") is not None):
        # fleet latency headline: quantiles of the SUMMED-bucket merge
        lines.append(
            f"  latency: queue-wait p50 {_fmt_q(agg['queue_wait_p50'])}s"
            f" p95 {_fmt_q(agg['queue_wait_p95'])}s   "
            f"job-wall p50 {_fmt_q(agg['job_wall_p50'])}s"
            f" p95 {_fmt_q(agg['job_wall_p95'])}s")
    lines.append(c(_DIM, f"  {'source':<32} {'status':<18} "
                         f"{'out':>8} {'rate':>8} {'pct':>6} "
                         f"{'qw50/95':>11} {'wall50/95':>11}"))
    for s in sources:
        snap = s.get("snap") or {}
        prog = snap.get("progress") or {}
        status = s["status"]
        if status in ("degraded", "unreachable", "finished-degraded"):
            status_c = c(_RED, f"{status:<18}")
        elif status.startswith("finished"):
            status_c = c(_GREEN, f"{status:<18}")
        else:
            status_c = f"{status:<18}"
        pct = prog.get("pct")
        qw = _source_quantiles(snap, "queue_wait_s")
        jw = _source_quantiles(snap, "job_wall_s")
        lines.append(
            f"  {s['source']:<32} {status_c} "
            f"{snap.get('holes_out', '-'):>8} "
            f"{prog.get('rate_zmws_per_sec', '-'):>8} "
            f"{pct if pct is not None else '-':>6} "
            f"{_fmt_q(qw[0]) + '/' + _fmt_q(qw[1]):>11} "
            f"{_fmt_q(jw[0]) + '/' + _fmt_q(jw[1]):>11}")
        if snap.get("degraded"):
            lines.append(c(_RED, f"      {snap['degraded']}"))
        if s.get("error"):
            lines.append(c(_DIM, f"      {s['error']}"))
    return "\n".join(lines)


def top_main(argv) -> int:
    """The `ccsx-tpu top` subcommand (dispatched from cli.main).  No
    jax import, no backend init — safe on a host whose accelerator is
    hung (same discipline as `stats`)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="ccsx-tpu-torch top",
        description="Live dashboard over running ccsx-tpu telemetry "
                    "endpoints (host:port) and/or --metrics JSONL "
                    "files; multi-rank sources aggregate (counters "
                    "sum, min progress, any-degraded).")
    ap.add_argument("sources", nargs="+",
                    help="telemetry endpoints (host:port or http URLs), "
                         "--metrics JSONL paths, and/or serve-fleet "
                         "spool DIRECTORIES (expanded to the replica "
                         "endpoints in their slot leases), any mix")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds [2.0]")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (scripts/tests)")
    ap.add_argument("--no-color", action="store_true")
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-endpoint fetch timeout seconds [2.0]")
    a = ap.parse_args(argv)
    color = not a.no_color and (a.once or sys.stdout.isatty())
    try:
        while True:
            sources = [read_source(s, timeout=a.timeout)
                       for s in expand_sources(a.sources)]
            agg = aggregate(sources)
            frame = render_top(sources, agg, color=color)
            if a.once:
                print(frame)
                return 0
            # home + clear-to-end keeps the frame flicker-free without
            # curses; \x1b[J clears any taller previous frame
            sys.stdout.write("\x1b[H\x1b[2J" + frame + "\n")
            sys.stdout.flush()
            if agg.get("finished"):
                return 0
            time.sleep(max(a.interval, 0.2))
    except KeyboardInterrupt:
        return 0
