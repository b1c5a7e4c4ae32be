"""The port's live telemetry plane and HTML report
(ccsx_tpu_torch/utils/telemetry.py, utils/report.py, --telemetry-port,
``top``, ``report``) against the JAX package's.

Parity: on the same snapshot dicts, ``render_prometheus``,
``health_payload``, ``aggregate`` and ``render_top(color=False)`` give the
JAX package's output, and ``report.render_html`` on the same JSONL files
gives its page apart from the title.  The port twins of
tests/test_telemetry.py's fast tests: the schema guards against the port's
``RunMetrics`` (its own step counters included), port auto-bump and the
65535 clamp, ``top`` over two live endpoints and over a metrics JSONL, the
finished-degraded headline, ``collect_fleet`` with torn records, and the
report's golden structure.  Through the port's CLI on the CPU: a run of
three small holes scraped throughout (``/progress`` totals 3 from a fresh
index, the output bytes equal a run without telemetry) and ``/healthz``
going degraded (503) under an injected stall while the run completes.
"""

import io
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ccsx_tpu.utils import report as jreport
from ccsx_tpu.utils import telemetry as jtelemetry
from ccsx_tpu.utils.metrics import Metrics as JMetrics

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.utils import faultinject, synth, telemetry, trace
from ccsx_tpu_torch.utils import report as report_mod
from ccsx_tpu_torch.utils.metrics import (HIST_BUCKETS, Metrics,
                                          resource_gauges)
from ccsx_tpu_torch.utils.run_metrics import PORT_KEYS, RunMetrics

from test_torch_distributed import few_threads, make_corpus  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R8_TRACE = os.path.join(ROOT, "benchmarks", "trace_r08_scale64.jsonl")
R8_METRICS = os.path.join(ROOT, "benchmarks", "metrics_r08_scale64.jsonl")
PORT = ["-m", "400", "--batch", "on", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.disarm()
    yield
    faultinject.disarm()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(port, path, timeout=1.0):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        # a degraded /healthz is a 503 that still carries its JSON body
        return e.code, e.read().decode()


class _Buf(io.StringIO):
    """A StringIO that Metrics.report() may 'close' and the test still
    reads."""

    def close(self):
        pass


def _populate(m):
    """Every optional field of a Metrics forced present, so key-set
    comparisons see the whole schema."""
    for f in ("holes_in", "holes_out", "holes_failed", "holes_filtered",
              "stalls", "windows", "pair_alignments",
              "pairs_screened", "pairs_prefiltered",
              "pairs_seeded_device", "pairs_seeded_host",
              "device_dispatches", "refine_overflows", "oom_resplits",
              "host_fallbacks", "compile_fallbacks", "dp_cells_real",
              "dp_cells_padded", "dp_round_cells_real",
              "dp_round_cells_padded", "dp_rowcells_real",
              "dp_rowcells_cap", "dp_rows_real", "dp_rows_dispatched",
              "packed_dispatches", "packed_holes",
              "distinct_slab_shapes", "fused_waves",
              "fused_slots", "fused_slabs_real", "ingest_bytes",
              "device_hangs", "breaker_trips", "breaker_probes",
              "holes_corrupt"):
        setattr(m, f, 7)
    m.filtered_reasons["few_passes"] = 7
    m.corrupt_reasons["bgzf_bad_deflate"] = 7
    m.banded_dispatches["scan"] = 7
    m.holes_total = 100
    m.degraded = "x"
    m.breaker_state = "open"
    m.breaker_strike_log = [{"ts": 1.0, "kind": "hang", "group": "g"}]
    m.group_stats["g"] = {"compiles": 1, "compile_s": 0.1,
                          "execute_s": 0.2, "dispatches": 3,
                          "dp_cells": 40, "exec_cells": 30}
    m.job = "j0007"
    m.cid = "cfeedfacecafe"
    m.observe("queue_wait_s", 0.3, "small")
    m.observe("job_wall_s", 70.0, "large")
    m.observe("first_dispatch_s", 0.1, "small")
    m.observe("device_execute_s", 0.02, "g")
    m.observe("lease_acquire_s", 0.001, "job")
    return m


def _mk(cls, holes_out, total=None, degraded=None):
    m = cls()
    m.holes_in = m.holes_out = holes_out
    m._ticked = holes_out
    m.windows = holes_out * 3
    m.device_dispatches = holes_out * 2
    m.holes_total = total
    m.degraded = degraded
    m._rate_ring.extend([(0.0, 0), (10.0, holes_out)])
    return m


# ---- parity on the same inputs ---------------------------------------------


def _jax_snapshots():
    """Snapshot dicts of the JAX schema: a populated one, an idle one, a
    degraded one with a second group and reason, and one without a
    total."""
    full = _populate(JMetrics()).snapshot()
    two = _populate(JMetrics()).snapshot()
    two["groups"]["h"] = dict(two["groups"]["g"])
    two["filtered_reasons"]["too_short"] = 3
    return [full, JMetrics().snapshot(), two,
            _mk(JMetrics, 30, degraded="stall watchdog fired: y").snapshot(),
            _mk(JMetrics, 60, total=100).snapshot()]


@pytest.mark.parametrize("i", range(5))
def test_render_prometheus_and_health_payload_match_jax(i):
    snap = _jax_snapshots()[i]
    gauges = resource_gauges()
    assert telemetry.render_prometheus(snap, gauges) == \
        jtelemetry.render_prometheus(snap, gauges)
    assert telemetry.health_payload(snap) == jtelemetry.health_payload(snap)


def test_aggregate_and_render_top_match_jax(monkeypatch):
    snaps = _jax_snapshots()
    sources = [{"source": f"127.0.0.1:{9000 + k}", "status": status,
                "snap": s}
               for k, (s, status) in enumerate(zip(
                   snaps, ["degraded", "ok", "degraded", "degraded", "ok"]))]
    sources.append({"source": "127.0.0.1:1", "status": "unreachable",
                    "snap": None, "error": "connection refused"})
    finished = [dict(sources[1], status="finished")]
    monkeypatch.setattr(time, "strftime", lambda *a: "12:34:56")
    for srcs in (sources, sources[:2], sources[4:5], finished):
        agg = telemetry.aggregate(srcs)
        assert agg == jtelemetry.aggregate(srcs)
        assert telemetry.render_top(srcs, agg, color=False) == \
            jtelemetry.render_top(srcs, agg, color=False)
        assert telemetry.render_top(srcs, agg) == \
            jtelemetry.render_top(srcs, agg)


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A traced port run of three small holes, two of them with an
    adapter read-through pass (so the strand walk runs its local fill):
    its trace and metrics JSONL."""
    d = tmp_path_factory.mktemp("traced")
    rng = np.random.default_rng(2)
    zs = []
    for h in range(3):
        z = synth.make_zmw(rng, 450, 5, movie="mv", hole=str(h))
        if h % 2 == 0:
            z.passes.insert(2, synth.read_through(rng, z.template))
            z.strands.insert(2, 0)
        zs.append(z)
    fa = d / "in.fa"
    fa.write_text(synth.make_fasta(zs))
    t, m = d / "t.jsonl", d / "m.jsonl"
    assert cli.main(PORT + ["-A", "--trace", str(t), "--metrics", str(m),
                            str(fa), str(d / "o.fa")]) == 0
    return str(t), str(m)


def test_render_html_matches_jax_apart_from_the_title(traced_run):
    for paths in ([R8_TRACE, R8_METRICS], list(traced_run),
                  [traced_run[1]]):
        page = report_mod.render_html(paths)
        jpage = jreport.render_html(paths)
        assert page == jpage.replace("ccsx-tpu run report",
                                     "ccsx-tpu-torch run report")
        assert page != jpage
        assert report_mod.render_html(paths, title="t") == \
            jreport.render_html(paths, title="t")
    page = report_mod.render_html(list(traced_run))
    assert "<svg" in page and "refine_packed" in page
    assert "pair_fill" in page


# ---- the schema guards against the port's RunMetrics ------------------------


def _port_snapshot():
    m = _populate(RunMetrics())
    for k in PORT_KEYS:
        setattr(m, k, 7)
    return m.snapshot()


def test_schema_guard_every_consumed_key_exists():
    snap = _port_snapshot()
    for name, keys in [
            ("prometheus counters", telemetry.PROM_COUNTERS),
            ("prometheus gauges", telemetry.PROM_GAUGES),
            ("top sum keys", telemetry.TOP_SUM_KEYS),
            ("healthz detail", telemetry.HEALTH_DETAIL_KEYS),
            ("stats occupancy", trace.OCCUPANCY_KEYS),
            ("stats resilience", trace.RESILIENCE_KEYS),
            ("report tiles", report_mod.REPORT_TILE_KEYS),
            ("report header", report_mod.REPORT_HEADER_KEYS)]:
        missing = set(keys) - set(snap)
        assert not missing, f"{name} consume unknown keys: {missing}"
    assert set(telemetry.PROGRESS_KEYS) == set(snap["progress"])
    assert set(telemetry.GROUP_FIELDS) == set(snap["groups"]["g"])


def test_schema_guard_every_snapshot_key_documented():
    """Every key of the port's snapshot, its step counters included, is
    exported by /metrics or rendered as a structure."""
    snap = _port_snapshot()
    documented = (set(telemetry.PROM_COUNTERS)
                  | set(telemetry.PROM_GAUGES)
                  | set(telemetry.PROM_STRUCTURED))
    assert not set(snap) - documented
    assert set(PORT_KEYS) <= set(telemetry.PROM_COUNTERS)
    text = telemetry.render_prometheus(snap, resource_gauges())
    for k in PORT_KEYS:
        assert f"# TYPE ccsx_{k} counter\nccsx_{k} 7\n" in text


def test_hist_schema_guard_both_directions():
    snap = _port_snapshot()
    fams = {f for f, _, _ in telemetry.HIST_FAMILIES}
    assert fams == set(snap["hist"])
    for _gauge, fam, threshold, objective in telemetry.SLO_BURN_GAUGES:
        assert fam in fams and threshold in HIST_BUCKETS
        assert 0 < objective < 1


def test_prometheus_render_wellformed():
    snap = _port_snapshot()
    snap["groups"]["h"] = dict(snap["groups"]["g"])
    text = telemetry.render_prometheus(snap, resource_gauges())
    assert text.endswith("\n")
    types = []
    for line in text.splitlines():
        if line.startswith("#"):
            assert line.startswith("# TYPE ccsx_")
            types.append(line)
            continue
        name, _, value = line.rpartition(" ")
        assert name.startswith("ccsx_")
        float(value)
    assert len(types) == len(set(types))
    assert 'ccsx_group_dispatches{group="h"} 3' in text
    assert "ccsx_degraded 1" in text and "ccsx_progress_pct" in text


# ---- the endpoint server and top -------------------------------------------


def test_port_auto_bump_when_taken():
    port = _free_port()
    blocker = socket.socket()
    blocker.bind(("0.0.0.0", port))
    blocker.listen(1)
    try:
        srv = telemetry.TelemetryServer(RunMetrics(), port, host="127.0.0.1")
        try:
            assert port < srv.port < port + telemetry.PORT_TRIES
            code, body = _get(srv.port, "/progress")
            assert code == 200 and json.loads(body)["slabs"] == 0
        finally:
            srv.close()
    finally:
        blocker.close()


def test_port_range_clamped_at_65535(capsys):
    with pytest.raises(OSError):
        telemetry.TelemetryServer(Metrics(), 65536)
    assert telemetry.start(Metrics(), 70000) is None    # warns only
    assert "[ccsx-tpu-torch] telemetry disabled" in capsys.readouterr().err


def test_top_aggregates_two_rank_endpoints(capsys):
    m0 = _mk(RunMetrics, 60, total=100)
    m1 = _mk(RunMetrics, 30, total=100, degraded="stall watchdog fired: x")
    for v in (0.2, 0.2, 0.4):
        m0.observe("queue_wait_s", v, "small")
    for v in (0.9, 0.9, 0.9):
        m1.observe("queue_wait_s", v, "small")
    s0 = telemetry.TelemetryServer(m0, _free_port(), host="127.0.0.1")
    s1 = telemetry.TelemetryServer(m1, _free_port(), host="127.0.0.1")
    try:
        eps = [f"127.0.0.1:{s0.port}", f"127.0.0.1:{s1.port}"]
        srcs = [telemetry.read_source(e) for e in eps]
        agg = telemetry.aggregate(srcs)
        assert agg["holes_out"] == 90 and agg["windows"] == 270
        assert agg["pct"] == 30.0 and agg["total"] == 200
        assert agg["any_degraded"] is True
        assert srcs[1]["status"] == "degraded"
        assert agg["hist"]["queue_wait_s"]["small"]["count"] == 6
        assert agg["queue_wait_p50"] == 0.5
        assert cli.main(["top", "--once", "--no-color", *eps]) == 0
        out = capsys.readouterr().out
        assert "DEGRADED" in out and "out 90" in out
        assert "stall watchdog fired: x" in out
        assert "latency:" in out and "qw50/95" in out
    finally:
        s0.close()
        s1.close()


def test_top_unreachable_endpoint_and_spool_degrade(tmp_path, capsys):
    src = telemetry.read_source(f"127.0.0.1:{_free_port()}", timeout=0.3)
    assert src["status"] == "unreachable"
    assert telemetry.aggregate([src])["any_degraded"] is True
    # a spool directory with no live replica slot is DOWN, not empty
    assert telemetry.expand_sources([str(tmp_path)]) == \
        [os.path.join(str(tmp_path), "<no-replicas>")]
    assert cli.main(["top", "--once", "--no-color", str(tmp_path)]) == 0
    assert "unreachable" in capsys.readouterr().out
    # a replica's slot lease (pipeline/gateway.py) lists its endpoint
    from ccsx_tpu_torch.pipeline import gateway

    port = _free_port()
    gateway.acquire_replica_slot(str(tmp_path), "A", extra={
        "addr": "127.0.0.1", "port": port})
    assert telemetry.expand_sources([str(tmp_path)]) == \
        [f"127.0.0.1:{port}"]


def test_top_tails_metrics_jsonl(tmp_path, capsys):
    buf = io.StringIO()
    m = _mk(RunMetrics, 7, total=10)
    m.stream = buf
    m.emit("progress")
    p = tmp_path / "m.jsonl"
    p.write_text(buf.getvalue() + "not json\n")   # a torn tail
    src = telemetry.read_source(str(p))
    assert src["status"] == "ok" and src["snap"]["holes_out"] == 7
    assert cli.main(["top", "--once", "--no-color", str(p)]) == 0
    assert "out 7" in capsys.readouterr().out


def test_top_finished_and_finished_degraded(tmp_path, capsys):
    for degraded, want in ((None, "FINISHED"),
                           ("stall watchdog fired: x", "FINISHED DEGRADED")):
        buf = _Buf()
        m = _mk(RunMetrics, 5, total=5, degraded=degraded)
        m.stream = buf
        m.report()
        p = tmp_path / "m.jsonl"
        p.write_text(buf.getvalue())
        src = telemetry.read_source(str(p))
        assert src["status"] == ("finished" if degraded is None
                                 else "finished-degraded")
        assert telemetry.aggregate([src])["finished"] is True
        assert cli.main(["top", "--once", "--no-color", str(p)]) == 0
        assert want in capsys.readouterr().out


# ---- report ----------------------------------------------------------------


def test_report_golden_structure_on_r8_artifacts(tmp_path, capsys):
    out = str(tmp_path / "r8.html")
    assert cli.main(["report", R8_TRACE, R8_METRICS, "-o", out]) == 0
    assert "[ccsx-tpu-torch] report:" in capsys.readouterr().err
    page = open(out, encoding="utf-8").read()
    assert page.startswith("<!DOCTYPE html>")
    for section in ("Timeline", "Stage self-time breakdown",
                    "Shape-group compile/execute table",
                    "Occupancy &amp; fill", "Progress: ETA vs actual",
                    "Stall &amp; recovery log"):
        assert section in page, section
    assert "<svg" in page and "packed:" in page and "healthy run" in page
    assert "no ETA samples" in page
    assert "http://" not in page and "https://" not in page
    assert "<script" not in page


def test_report_renders_progress_and_stalls(tmp_path):
    buf = _Buf()
    m = _mk(RunMetrics, 50, total=100)
    m.t0 = time.monotonic() - 20.0
    m.stream = buf
    m.emit("progress")
    m.degraded = "stall watchdog fired: dispatch x"
    m.stalls = 1
    m.emit("stall", span="refine_packed", group="packed:q1", open_s=9.9)
    m.report()
    mp = tmp_path / "m.jsonl"
    mp.write_text(buf.getvalue())
    out = str(tmp_path / "r.html")
    assert cli.main(["report", str(mp), "-o", out]) == 0
    page = open(out, encoding="utf-8").read()
    assert "DEGRADED" in page and "predicted remaining" in page
    assert report_mod.default_out_path("x/t.jsonl") == "x/t.report.html"


def test_collect_fleet_tolerates_torn_records(tmp_path):
    d = tmp_path / "spool"
    d.mkdir()
    good = {"ev": "span", "name": "refine", "cat": "device",
            "ts": 100.0, "dur": 0.5, "tid": "T", "cid": "cgood"}
    torn = {"ev": "span", "name": "refine", "cat": "device",
            "ts": 101.0, "tid": "T", "cid": "ctorn"}   # no 'dur'
    (d / "a.jsonl").write_text(
        json.dumps(good) + "\n" + json.dumps(torn) + "\n")
    data = report_mod.collect_fleet(str(d))
    assert set(data["jobs"]) == {"cgood"}
    assert data["jobs"]["cgood"]["t_end"] == 0.5
    assert data == jreport.collect_fleet(str(d))
    out = str(tmp_path / "f.html")
    assert cli.main(["report", "--fleet", str(d), "-o", out]) == 0
    assert "cgood" in open(out, encoding="utf-8").read()


# ---- through the port's CLI --------------------------------------------------


def _run_in_thread(argv):
    res = {}
    t = threading.Thread(target=lambda: res.update(rc=cli.main(argv)))
    t.start()
    return t, res


def test_endpoint_scrape_during_a_real_run(tmp_path):
    """/progress, /metrics and /healthz answer during a port run on the
    CPU; counters are monotone across scrapes; a fresh index gives the
    total; the server is down after the run; the output bytes equal a run
    without telemetry."""
    _, bm = make_corpus(tmp_path, seed=3, n_holes=3, tlen=450)
    assert cli.main(["--make-index", str(bm), "ignored"]) == 0
    on, off = str(tmp_path / "on.fa"), str(tmp_path / "off.fa")
    port = _free_port()
    t, res = _run_in_thread(PORT + ["--telemetry-port", str(port), str(bm),
                                    on])
    scrapes, prom, health = [], None, None
    while t.is_alive():
        try:
            _, body = _get(port, "/progress", timeout=0.5)
            scrapes.append(json.loads(body))
            _, prom = _get(port, "/metrics", timeout=0.5)
            code, hbody = _get(port, "/healthz", timeout=0.5)
            health = (code, json.loads(hbody))
        except (urllib.error.URLError, OSError, ValueError):
            pass
        time.sleep(0.02)
    t.join()
    assert res["rc"] == 0
    assert scrapes, "the run ended before a scrape landed"
    for key in ("holes_in", "holes_out", "device_dispatches", "slabs"):
        seq = [s[key] for s in scrapes]
        assert seq == sorted(seq), (key, seq)
    assert all(s["progress"]["total"] == 3 for s in scrapes)
    assert scrapes[-1]["status"] == "ok"
    assert health[0] == 200 and health[1]["status"] == "ok"
    assert set(telemetry.HEALTH_DETAIL_KEYS) == set(health[1]["detail"])
    assert "# TYPE ccsx_holes_out counter" in prom
    assert "ccsx_progress_total 3" in prom and "# TYPE ccsx_slabs" in prom
    with pytest.raises((urllib.error.URLError, OSError)):
        _get(port, "/healthz", timeout=0.5)
    assert cli.main(PORT + [str(bm), off]) == 0
    assert open(on, "rb").read() == open(off, "rb").read()
    assert open(on, "rb").read().count(b"/ccs\n") == 3


def test_healthz_flips_degraded_under_injected_stall(tmp_path, monkeypatch):
    """/healthz turns 503 while the stalled step is still open, and the
    run completes (degraded, never killed)."""
    monkeypatch.setenv("CCSX_FAULT_STALL_S", "3.0")
    _, bm = make_corpus(tmp_path, seed=4, n_holes=2, tlen=450)
    port = _free_port()
    m = tmp_path / "m.jsonl"
    t, res = _run_in_thread(PORT + [
        "--stall-timeout", "0.2", "--inject-faults", "stall@1",
        "--telemetry-port", str(port), "--metrics", str(m), str(bm),
        str(tmp_path / "o.fa")])
    flipped = None
    t0 = time.monotonic()
    while t.is_alive() and time.monotonic() - t0 < 60:
        try:
            code, body = _get(port, "/healthz", timeout=0.5)
        except (urllib.error.URLError, OSError):
            time.sleep(0.05)
            continue
        h = json.loads(body)
        if h["status"] == "degraded":
            flipped = (code, h)
            break
        time.sleep(0.05)
    t.join()
    assert res["rc"] == 0
    assert flipped is not None, "/healthz never reported degraded"
    assert flipped[0] == 503 and flipped[1]["detail"]["stalls"] >= 1
    events = [json.loads(line) for line in open(m)]
    assert events[-1]["event"] == "final"
    assert events[-1]["degraded"].startswith("stall watchdog")
