"""The port's serve fleet (pipeline/gateway.py spool protocol, serve.py's
fleet mode, pipeline/fleet.py's ranges, the ``gateway`` subcommand)
against the JAX package's.

The spool protocol half of tests/test_serve_fleet.py runs through either
package's module on the same inputs: id allocation and spooled bodies,
the exclusive retirement fence, cancel and deadline marks, replica slots
and their discovery (``top`` expanding a spool), the fleet gauges' schema
and text.  The raw-hole helpers of the fleet plane (run.count_raw_holes,
run.slice_raw_holes) give the JAX package's counts and records.

End to end, on tests/test_serve.py's 700 bp / 5-pass geometry, every
output is held to the JAX CLI's ``--batch on`` bytes: a job crossing
replicas (submitted through a replica that never leases), a dead
replica's job requeued to the survivor, a cross-replica cancel landing at
the holder's renewal beside an untouched sibling, a cancelled queued job
retired unrun, the gateway's 503 with no ready replica and its routing to
a ready one (discovery, ``ccsx_fleet_*`` gauges, output bytes), a fan-out
job split into leased ranges across two replicas and merged, and the
fleet pull worker's flag refusals.
"""

import io
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ccsx_tpu import cli as jcli
from ccsx_tpu.pipeline import gateway as jgateway
from ccsx_tpu.pipeline import run as jrun
from ccsx_tpu.utils import journal as jjournal
from ccsx_tpu.utils import lease as jlease
from ccsx_tpu.utils import telemetry as jtelemetry

from ccsx_tpu_torch import cli, exitcodes
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.io import fastx
from ccsx_tpu_torch.pipeline import gateway, run
from ccsx_tpu_torch.pipeline.gateway import Gateway, _gateway_handler
from ccsx_tpu_torch.pipeline.serve import ServeCore, _serve_handler
from ccsx_tpu_torch.utils import faultinject, journal
from ccsx_tpu_torch.utils import lease as leaselib
from ccsx_tpu_torch.utils import synth, telemetry

FLAGS = ["-A", "-m", "1000"]
# (spool protocol, lease primitive, json writer, telemetry) of each package
PKGS = {"jax": (jgateway, jlease, jjournal, jtelemetry),
        "port": (gateway, leaselib, journal, telemetry)}


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    faultinject.disarm()
    monkeypatch.setenv("CCSX_FAULT_STALL_S", "3")
    yield
    faultinject.disarm()


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(extra=()):
    args = cli.build_parser().parse_args([*FLAGS, "--device", "cpu",
                                          "--no-warmup", *extra])
    return cli.config_from_args(args)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(3-hole input, the JAX CLI's output, 8-hole input, ditto)."""
    tmp = tmp_path_factory.mktemp("serve_fleet")
    rng = np.random.default_rng(0)

    def make(n, path):
        zs = [synth.make_zmw(rng, template_len=700, n_passes=5,
                             movie="mv", hole=str(100 + h))
              for h in range(n)]
        path.write_text(synth.make_fasta(zs))

    fa3, fa8 = tmp / "in3.fa", tmp / "in8.fa"
    make(3, fa3)
    make(8, fa8)
    refs = []
    for fa in (fa3, fa8):
        ref = tmp / (fa.stem + ".jax.fa")
        assert jcli.main([*FLAGS, "--batch", "on", "--device", "cpu",
                          str(fa), str(ref)]) == 0
        refs.append(ref.read_bytes())
    return str(fa3), refs[0], str(fa8), refs[1]


@pytest.fixture
def fleet_factory(tmp_path):
    """Replica cores over one shared spool, torn down after the test."""
    cores = []
    spool = str(tmp_path / "spool")

    def make(name, extra=(), **kw):
        kw.setdefault("lease_timeout", 1.2)
        kw.setdefault("poll_s", 0.1)
        c = ServeCore(_cfg(extra), spool=spool, fleet=True, replica=name,
                      **kw)
        cores.append(c)
        return c

    yield spool, make
    for c in cores:
        c.close()


def _wait_done(spool, jid, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        view = gateway.job_view(spool, jid)
        if view and view["state"] in ("done", "failed", "cancelled",
                                      "interrupted"):
            return view
        time.sleep(0.1)
    raise AssertionError(f"job {jid} not terminal: "
                         f"{gateway.job_view(spool, jid)}")


def _stable(view):
    """A job view without its wall-clock and per-process fields."""
    return {k: v for k, v in view.items()
            if k not in ("submitted_at", "finished_at", "cid", "input")}


# ---- the spool protocol, through either package ----------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
def test_submit_allocates_sequential_ids_and_spools_body(pkg, tmp_path):
    proto = PKGS[pkg][0]
    spool = str(tmp_path)
    j1 = proto.submit_job(spool, input_path="/x/in.fa", overrides={})
    j2 = proto.submit_job(spool, input_path="/x/in2.fa",
                          overrides={"deadline_s": 5})
    assert (j1, j2) == ("j00001", "j00002")
    assert proto.job_view(spool, j1)["state"] == "queued"
    assert proto.spool_counts(spool) == {"queued": 2, "leased": 0,
                                         "retired": 0, "cancelling": 0}
    j3 = proto.submit_job(spool, body_stream=io.BytesIO(b">a\nACGT\n"),
                          body_len=8, overrides={"format": "fasta"})
    rec = proto.read_job_record(spool, j3)
    assert open(rec["input"], "rb").read() == b">a\nACGT\n"
    assert rec["input"].endswith(".fasta") and rec["cid"].startswith("c")
    with pytest.raises(ValueError):
        proto.submit_job(spool, body_stream=io.BytesIO(b">a"), body_len=8)
    with pytest.raises(ValueError):
        proto.submit_job(spool)
    assert proto.list_job_ids(spool) == ["j00001", "j00002", "j00003"]


def test_spool_written_by_one_package_reads_the_same_in_the_other(tmp_path):
    """The two packages share the on-disk protocol: a spool written by the
    JAX package's gateway reads back the same through the port's, and the
    reverse."""
    for writer, reader in (("jax", "port"), ("port", "jax")):
        spool = str(tmp_path / writer)
        w, r = PKGS[writer][0], PKGS[reader][0]
        jid = w.submit_job(spool, input_path="/x/in.fa",
                           overrides={"inflight": 2})
        other = w.submit_job(spool, input_path="/x/b.fa", overrides={})
        w.mark_cancel(spool, jid)
        PKGS[writer][1].try_acquire(spool, other, "A",
                                    extra={"replica": "A"})
        assert r.list_job_ids(spool) == w.list_job_ids(spool)
        for j in (jid, other):
            assert _stable(r.job_view(spool, j)) == _stable(
                w.job_view(spool, j))
        assert r.spool_counts(spool) == w.spool_counts(spool) == {
            "queued": 0, "leased": 1, "retired": 0, "cancelling": 1}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_exclusive_retirement_admits_one_emitter(pkg, tmp_path):
    proto = PKGS[pkg][0]
    spool = str(tmp_path)
    jid = proto.submit_job(spool, input_path="/x/in.fa", overrides={})
    assert proto.retire_job(spool, jid, "done", 0, "A",
                            output="/x/a.fa") is True
    assert proto.retire_job(spool, jid, "done", 0, "B",
                            output="/x/b.fa") is False
    view = proto.job_view(spool, jid)
    assert view["state"] == "done" and view["replica"] == "A"
    assert view["output"] == "/x/a.fa"
    assert proto.spool_counts(spool)["retired"] == 1


@pytest.mark.parametrize("pkg", list(PKGS))
def test_cancel_and_deadline_marks(pkg, tmp_path):
    proto = PKGS[pkg][0]
    spool = str(tmp_path)
    jid = proto.submit_job(spool, input_path="/x/in.fa", overrides={})
    state, changed = proto.mark_cancel(spool, jid)
    assert changed and state == "cancelled"
    _, changed = proto.mark_cancel(spool, jid)
    assert not changed
    with pytest.raises(KeyError):
        proto.mark_cancel(spool, "j99999")
    assert proto.mark_deadline(spool, jid, 3.5)
    assert proto.read_job_record(spool, jid)["overrides"]["deadline_s"] == \
        3.5
    assert proto.job_view(spool, jid)["state"] == "cancelling"
    with pytest.raises(KeyError):
        proto.mark_deadline(spool, "j99999", 1.0)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_replica_slots_are_deterministic_and_discoverable(pkg, tmp_path):
    proto, lease, jrnl, telem = PKGS[pkg]
    spool = str(tmp_path)
    k0, rec0 = proto.acquire_replica_slot(
        spool, "A", extra={"addr": "127.0.0.1", "port": 8850,
                           "replica": "A", "ready": True})
    k1, _ = proto.acquire_replica_slot(
        spool, "B", extra={"addr": "127.0.0.1", "port": 8851,
                           "replica": "B", "ready": False})
    assert (k0, k1) == (0, 1)
    assert [r["name"] for r in proto.discover_replicas(spool)] == ["A", "B"]
    assert proto.replica_endpoints(spool) == ["127.0.0.1:8850",
                                             "127.0.0.1:8851"]
    jrnl.write_json_atomic(lease.lease_path(spool, "r0"),
                           dict(rec0, pid=987654, renewed=time.time() - 999))
    k2, _ = proto.acquire_replica_slot(spool, "C", extra={"port": 8850},
                                       lease_timeout=10.0)
    assert k2 == 0
    assert telem.expand_sources([spool]) == ["127.0.0.1:8850",
                                             "127.0.0.1:8851"]
    summary = proto.fleet_summary(spool)
    assert summary["fleet_replicas"] == 2 and set(summary["replicas"]) == \
        {"B", "C"}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_expand_sources_empty_fleet_renders_unreachable(pkg, tmp_path):
    telem = PKGS[pkg][3]
    srcs = telem.expand_sources([str(tmp_path)])
    assert len(srcs) == 1 and "<no-replicas>" in srcs[0]
    assert telem.expand_sources(["127.0.0.1:9999"]) == ["127.0.0.1:9999"]


def test_fleet_series_schema_and_text_as_the_jax_packages(tmp_path):
    """Every FLEET_SERVE_GAUGES / FLEET_REPLICA_GAUGES name renders once as
    a ccsx_ family, nothing undeclared renders, and the text is the JAX
    package's on the same summary."""
    spool = str(tmp_path)
    gateway.submit_job(spool, input_path="/x/in.fa", overrides={})
    gateway.acquire_replica_slot(
        spool, "A", extra={"addr": "127.0.0.1", "port": 8850,
                           "replica": "A", "ready": True, "pressure": 0.25,
                           "leases": 1})
    summary = gateway.fleet_summary(spool)
    assert summary == jgateway.fleet_summary(spool)
    text = telemetry.render_fleet_series(summary)
    assert text == jtelemetry.render_fleet_series(summary)
    declared = set(telemetry.FLEET_SERVE_GAUGES
                   + telemetry.FLEET_REPLICA_GAUGES)
    rendered = {ln.split()[2][len("ccsx_"):] for ln in text.splitlines()
                if ln.startswith("# TYPE ")}
    assert rendered == declared
    for g in telemetry.FLEET_REPLICA_GAUGES:
        assert f'ccsx_{g}{{replica="A"}}' in text
    assert telemetry.render_fleet_series({}) == \
        jtelemetry.render_fleet_series({}) == ""


def test_raw_hole_helpers_match_the_jax_packages(corpus, tmp_path):
    """count_raw_holes and slice_raw_holes (the range table's denominator
    and the FASTA/Q range reader) give the JAX package's counts and
    records, FASTA and BAM (the BAM through its hole index)."""
    from ccsx_tpu_torch.io import bam
    from ccsx_tpu_torch.ops import encode as enc

    _, _, fa8, _ = corpus
    cfg = CcsConfig(is_bam=False)
    from ccsx_tpu.config import CcsConfig as JCfg
    from ccsx_tpu.io import fastx as jfastx

    assert run.count_raw_holes(fa8, cfg) == \
        jrun.count_raw_holes(fa8, JCfg(is_bam=False)) == 8
    for lo, hi in ((0, 8), (2, 5), (7, 9), (3, 3)):
        got = [r.name for r in run.slice_raw_holes(
            fastx.read_fastx(open(fa8, "rb")), lo, hi)]
        want = [r.name for r in jrun.slice_raw_holes(
            jfastx.read_fastx(open(fa8, "rb")), lo, hi)]
        assert got == want
    rng = np.random.default_rng(5)
    zs = [synth.make_zmw(rng, 300, 4, movie="mv", hole=str(h))
          for h in range(5)]
    path = str(tmp_path / "in.bam")
    bam.write_bam(path, [(n, enc.decode(p).encode(), None) for z in zs
                         for n, p in zip(z.names, z.passes)])
    assert run.count_raw_holes(path, CcsConfig(is_bam=True)) == \
        jrun.count_raw_holes(path, JCfg(is_bam=True)) == 5


def test_fleet_worker_flag_validation(tmp_path, capsys):
    """The pull worker's refusals, with the JAX CLI's return code and
    message."""
    d = str(tmp_path / "f")
    for argv, text in ((["--hosts", "2"], "fleet scheduler owns those"),
                       (["--batch", "off"], "--batch off is not supported"),
                       (["--bam"], "--bam is not supported with --fleet-dir"),
                       ([], "fleet.json")):
        full = ["--fleet-dir", d, *argv, "in.fa", "o.fa"]
        assert cli.main(["--device", "cpu", *full]) == 1
        port_err = capsys.readouterr().err
        assert jcli.main(full) == 1
        jax_err = capsys.readouterr().err
        assert text in port_err and text in jax_err


# ---- replicas over one spool -------------------------------------------------


def test_job_crosses_replicas_byte_identical(corpus, fleet_factory):
    """Submitted through replica A, whose scan never runs in the test's
    time: B leases the job from the shared spool and retires it with one
    done marker, byte-identical to the JAX CLI.  A's first scan tick lies
    past any run's length: a tick inside the run (30 s was, on a loaded
    CPU) finds B's lease, held in this process under another name, late
    whenever B's renewer was starved past the 1.2 s lease timeout, expires
    it, and B leases the job again and runs it a second time beside the
    first (the JAX package's scan does the same)."""
    fa3, ref3, _, _ = corpus
    spool, make = fleet_factory
    a = make("A", poll_s=3600.0)
    make("B")
    h = a.submit(input_path=fa3, overrides={"prep_threads": 0})
    view = _wait_done(spool, h.id)
    assert view["state"] == "done" and view["replica"] == "B"
    assert open(view["output"], "rb").read() == ref3
    assert os.path.exists(gateway.done_marker_path(spool, h.id))
    assert leaselib.read_lease(spool, h.id) is None
    assert a.wait(h.id, timeout=10) == "done"
    assert not [n for n in os.listdir(spool) if n.startswith("done.")
                and n != f"done.{h.id}.json"]


def test_dead_replica_job_requeues_to_survivor(corpus, fleet_factory):
    """A job leased by a dead replica (stale heartbeat, a pid that does not
    exist) is expired by the survivor's scan, resumed from its journal and
    completed with the JAX CLI's bytes."""
    _, _, fa8, ref8 = corpus
    spool, make = fleet_factory
    jid = gateway.submit_job(spool, input_path=fa8,
                             overrides={"prep_threads": 0})
    rec = leaselib.try_acquire(spool, jid, "dead-replica",
                               extra={"host": "nosuchhost.invalid"})
    journal.write_json_atomic(leaselib.lease_path(spool, jid),
                              dict(rec, pid=987654,
                                   renewed=time.time() - 999))
    make("survivor")
    view = _wait_done(spool, jid)
    assert view["state"] == "done" and view["replica"] == "survivor"
    assert open(view["output"], "rb").read() == ref8
    assert os.listdir(os.path.join(spool, leaselib.GRAVEYARD))


def test_cross_replica_cancel_lands_at_renewal(corpus, fleet_factory):
    """A cancel marked on the spool record (the gateway's DELETE) is seen at
    the holder's next renewal: the job ends cancelled, rc 75, and its
    sibling on the same replica is untouched."""
    fa3, ref3, _, _ = corpus
    spool, make = fleet_factory
    c = make("A", max_active=2)
    victim = c.submit(input_path=fa3, overrides={"faults": "stall@1"})
    sibling = c.submit(input_path=fa3, overrides={"prep_threads": 0})
    deadline = time.monotonic() + 60
    while (leaselib.read_lease(spool, victim.id) is None
           and time.monotonic() < deadline):
        time.sleep(0.05)
    state, changed = gateway.mark_cancel(spool, victim.id)
    assert changed
    view = _wait_done(spool, victim.id)
    assert view["state"] == "cancelled"
    assert view["rc"] == exitcodes.RC_INTERRUPTED
    sview = _wait_done(spool, sibling.id)
    assert sview["state"] == "done"
    assert open(sview["output"], "rb").read() == ref3


def test_cancel_queued_job_retired_without_running(fleet_factory):
    spool, make = fleet_factory
    os.makedirs(spool, exist_ok=True)
    jid = gateway.submit_job(spool, input_path="/nonexistent.fa",
                             overrides={})
    gateway.mark_cancel(spool, jid)
    make("A", max_active=1)
    view = _wait_done(spool, jid, timeout=30)
    assert view["state"] == "cancelled"
    assert view["rc"] == exitcodes.RC_INTERRUPTED


def _http(port):
    base = f"http://127.0.0.1:{port}"

    def req(method, path, data=None):
        r = urllib.request.Request(base + path, data=data, method=method)
        if data is not None:
            r.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(r, timeout=30) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)

    return req


def test_gateway_503_retry_after_when_no_replica_ready(tmp_path):
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    gw = Gateway(spool, probe_s=0.05)
    srv = telemetry.TelemetryServer(
        None, 0, host="127.0.0.1", handler=_gateway_handler(),
        attrs={"ccsx_gateway": gw, "ccsx_ready": gw.readiness})
    try:
        req = _http(srv.port)
        code, body, hdrs = req("POST", "/jobs",
                               json.dumps({"input": "/x.fa"}).encode())
        assert code == 503 and hdrs.get("Retry-After") == "5"
        assert gateway.list_job_ids(spool) == []
        code, body, _ = req("GET", "/readyz")
        assert code == 503 and json.loads(body) == {
            "ready": False, "reason": "no replicas"}
        code, body, _ = req("GET", "/healthz")
        assert code == 200 and json.loads(body)["replicas"] == 0
    finally:
        srv.close()


def test_gateway_routes_submit_to_ready_replica(corpus, fleet_factory):
    """Through HTTP: the replica serves /readyz, the gateway finds it by its
    slot lease, accepts the POST into the spool, the replica completes the
    job, and the gateway serves its bytes and the fleet gauges."""
    fa3, ref3, _, _ = corpus
    spool, make = fleet_factory
    core = make("A")
    rsrv = telemetry.TelemetryServer(
        core.metrics, 0, host="127.0.0.1", handler=_serve_handler(),
        attrs={"ccsx_core": core, "ccsx_ready": core.readiness})
    core.register_replica()
    core.set_advertised(rsrv.port)
    gw = Gateway(spool, probe_s=0.05)
    gsrv = telemetry.TelemetryServer(
        None, 0, host="127.0.0.1", handler=_gateway_handler(),
        attrs={"ccsx_gateway": gw, "ccsx_ready": gw.readiness})
    try:
        req = _http(gsrv.port)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            code, body, _ = req("GET", "/readyz")
            if code == 200:
                break
            time.sleep(0.1)
        assert code == 200, body
        code, body, _ = req("POST", "/jobs", json.dumps(
            {"input": fa3, "prep_threads": 0}).encode())
        assert code == 201, body
        jid = json.loads(body)["id"]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            code, body, _ = req("GET", f"/jobs/{jid}")
            if json.loads(body).get("state") == "done":
                break
            time.sleep(0.2)
        assert json.loads(body)["state"] == "done", body
        code, out, _ = req("GET", f"/jobs/{jid}/output")
        assert code == 200 and out == ref3
        code, body, _ = req("GET", "/replicas")
        reps = json.loads(body)["replicas"]
        assert [r["name"] for r in reps] == ["A"]
        assert reps[0]["port"] == rsrv.port
        code, body, _ = req("GET", "/metrics")
        text = body.decode()
        for g in telemetry.FLEET_SERVE_GAUGES:
            assert f"ccsx_{g}" in text
        assert "ccsx_fleet_jobs_retired 1" in text
        code, _, _ = req("DELETE", f"/jobs/{jid}")
        assert code == 409
        code, _, _ = req("DELETE", "/jobs/j99999")
        assert code == 404
        # the replica's own view of a job it holds carries its counters
        code, body, _ = _http(rsrv.port)("GET", f"/jobs/{jid}")
        m = json.loads(body)["metrics"]
        assert m["slabs"] == m["eager_dispatches"] + m["graph_replays"]
    finally:
        gsrv.close()
        rsrv.close()


def test_fanout_job_splits_and_merges_byte_identical(corpus, fleet_factory):
    """A job of at least --fanout-holes holes splits into leased ranges in
    the spool, pulled by its holder and a helping replica, each range
    through run.run_pipeline under the replica's runtime, and the merge is
    the JAX CLI's bytes."""
    _, _, fa8, ref8 = corpus
    spool, make = fleet_factory
    a = make("A", fanout_holes=4, fanout_ranges=3)
    make("B", fanout_holes=4, fanout_ranges=3)
    h = a.submit(input_path=fa8, overrides={"prep_threads": 0})
    view = _wait_done(spool, h.id, timeout=180)
    assert view["state"] == "done", view
    assert open(view["output"], "rb").read() == ref8
    assert not os.path.exists(os.path.join(spool, f"fanout.{h.id}"))
    assert (gateway.read_job_record(spool, h.id) or {}).get("fanout") == 3


def test_fleet_worker_pulls_every_range_and_the_merge_is_the_jax_bytes(
        corpus, tmp_path):
    """``--fleet-dir``: one pull worker takes every leased range of a fleet
    directory (each through the batched driver into its shard, each retired
    with an exclusive marker), and the merge under the table's hash is the
    JAX CLI's bytes."""
    from ccsx_tpu_torch.parallel import distributed
    from ccsx_tpu_torch.pipeline import fleet

    fa3, ref3, _, _ = corpus
    d, out = str(tmp_path / "f"), str(tmp_path / "out.fa")
    state = fleet.init_fleet(d, fa3, out, run.count_raw_holes(
        fa3, CcsConfig(is_bam=False)), 2, 10.0)
    assert cli.main([*FLAGS, "--device", "cpu", "--prep-threads", "0",
                     "--fleet-dir", d, "--fleet-worker", "w7", "in", "o"]) \
        == 0
    assert fleet.queue_state(d, out, 2) == {"done": 2, "leased": 0,
                                            "queued": 0}
    marker = json.load(open(distributed.done_path(out, 1)))
    assert marker["worker"] == "w7" and marker["table"] == state["table"]
    assert distributed.merge_shards(out, 2, expect_table=state["table"]) == 3
    assert open(out, "rb").read() == ref3
