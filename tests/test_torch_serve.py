"""The port's resident server (ccsx_tpu_torch/pipeline/serve.py) against the
JAX package's.

On the 700 bp / 5-pass geometry of tests/test_serve.py (3- and 8-hole
inputs from rng(0)), every served output is held to the JAX CLI's
``--batch on`` bytes on the same file:

* two jobs at once through one ServeCore, each with its own counters
  (slabs = its eager refine dispatches + its graph replays, counted for
  that job alone by ops/cuda_ext.scope), and a second wave of the same
  jobs that builds no refine program (the server's ``/progress``
  ``programs``) and dispatches nothing eagerly;
* the queue cap (QueueFull; HTTP 429 with Retry-After), submit validation
  (unknown keys), the per-job ``dispatch_deadline_s`` and
  ``breaker_strikes`` overrides applied to the job's own config (its own
  Resilience), a ``device_hang`` under a job's own deadline that degrades
  that job alone, a cancel mid-job beside an untouched sibling, a drain to
  rc 75 and a new core resuming from state.json to the same bytes,
  ``/healthz`` against ``/readyz``;
* the device-fault stop: a kernel failure in one job turns ``/readyz`` 503
  ``device_fault``, drains the sibling, persists both jobs, and a
  restarted core finishes both to the JAX CLI's bytes.

Units: the fair window against the JAX package's on one schedule, the
per-job renderers' text against the JAX package's on one snapshot, the
launch scope across threads, a refine program's dispatch ordinals under
two threads, ``graphs.clear`` against a replay in progress, and
``serve``'s refusals (the flags the JAX server refuses, and no card).
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ccsx_tpu import cli as jcli
from ccsx_tpu.pipeline import serve as jserve
from ccsx_tpu.utils import telemetry as jtelemetry

from ccsx_tpu_torch import cli, exitcodes
from ccsx_tpu_torch.ops import cuda_ext
from ccsx_tpu_torch.pipeline import batch, graphs, serve
from ccsx_tpu_torch.pipeline.serve import (FairWindow, QueueFull, ServeCore,
                                           _serve_handler)
from ccsx_tpu_torch.utils import faultinject, synth, telemetry

FLAGS = ["-A", "-m", "1000"]


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    faultinject.disarm()
    monkeypatch.setenv("CCSX_FAULT_STALL_S", "2")
    yield
    faultinject.disarm()


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the test workers share the host's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(extra=()):
    args = cli.build_parser().parse_args([*FLAGS, "--device", "cpu", *extra])
    return cli.config_from_args(args)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(3-hole input, the JAX CLI's output for it, 8-hole input, ditto)."""
    tmp = tmp_path_factory.mktemp("serve")
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
    assert refs[0].count(b"/ccs\n") == 3 and refs[1].count(b"/ccs\n") == 8
    return str(fa3), refs[0], str(fa8), refs[1]


@pytest.fixture
def core_factory(tmp_path):
    cores = []

    def make(spool="spool", extra=(), **kw):
        c = ServeCore(_cfg(extra), spool=str(tmp_path / spool), **kw)
        cores.append(c)
        return c

    yield make
    for c in cores:
        c.close()


def _http(srv):
    base = f"http://127.0.0.1:{srv.port}"

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


@pytest.fixture
def served(core_factory):
    """(core, req): a ServeCore on an ephemeral port through the telemetry
    stack, torn down after the test."""
    servers = []

    def make(**kw):
        core = core_factory(**kw)
        srv = telemetry.TelemetryServer(
            core.metrics, 0, host="127.0.0.1", handler=_serve_handler(),
            attrs={"ccsx_core": core, "ccsx_ready": core.readiness})
        servers.append(srv)
        return core, _http(srv)

    yield make
    for s in servers:
        s.close()


def _out(job):
    return open(job.out_path, "rb").read()


# ---- units ------------------------------------------------------------------


@pytest.mark.parametrize("mod", [jserve, serve], ids=["jax", "port"])
def test_fair_window_semantics(mod):
    """tests/test_serve.py's schedule, through either package's window."""
    w = mod.FairWindow(4)
    w.register("a")
    assert all(w.try_acquire("a") for _ in range(4))
    assert not w.try_acquire("a")
    w.register("b")
    assert not w.try_acquire("b")
    w.release("a")
    assert not w.try_acquire("a")
    assert w.try_acquire("b")
    w.release("a")
    w.release("a")
    assert w.try_acquire("a") and w.try_acquire("a")
    w.release_all("b")
    w.unregister("b")
    assert w.try_acquire("a")
    assert not w.try_acquire("a")
    assert w.pressure() == 1.0
    w.release_all("a")
    w.unregister("a")


def test_job_series_render_as_the_jax_packages():
    snap = {"holes_in": 3, "holes_out": 2, "holes_failed": 1,
            "zmws_per_sec": 1.5, "elapsed_s": 2.0, "degraded": "x",
            "host_fallbacks": 0}
    jobs = {"j0002": snap, "j0001": dict(snap, degraded=None)}
    text = telemetry.render_job_series(jobs)
    assert text == jtelemetry.render_job_series(jobs)
    assert 'ccsx_job_holes_out{job="j0001"} 2' in text
    assert telemetry.render_job_series({}) == ""


def test_launch_scope_counts_the_context_across_threads():
    """cuda_ext.scope counts this thread's launches and those of threads
    started with faultinject.inherit; each job's scope counts apart from its
    siblings', an unscoped launch goes to LAUNCHES alone, and LAUNCHES gets
    every one — under a short switch interval, with more threads than
    cores, no update is lost."""
    import sys

    before = dict(cuda_ext.LAUNCHES)
    seen = {}
    jobs = [(f"j{k}", 200 + k) for k in range(8)]

    def job(name, n):
        with cuda_ext.scope() as c:
            seen[name] = c
            cuda_ext.count("banded_local")
            pool = [threading.Thread(target=faultinject.inherit(
                lambda: [cuda_ext.count("banded_global") for _ in range(n)]))
                for _ in range(2)]
            for t in pool:
                t.start()
            for _ in range(n):
                cuda_ext.add({"traceback_walk": 1})
                cuda_ext.scoped("graph_replays")
            for t in pool:
                t.join(timeout=60)
            with cuda_ext.tally():
                cuda_ext.count("banded_global")   # a capture's: not counted
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=job, args=a) for a in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    cuda_ext.count("banded_rotband")               # no scope
    for name, n in jobs:
        assert seen[name]["launches"] == {
            "banded_global": 2 * n, "banded_local": 1, "banded_rotband": 0,
            "traceback_walk": n}
        assert seen[name]["graph_replays"] == n
        assert seen[name]["eager_dispatches"] == 0
    total = sum(n for _, n in jobs)
    after = cuda_ext.LAUNCHES
    assert after["banded_global"] - before["banded_global"] == 2 * total
    assert after["banded_local"] - before["banded_local"] == len(jobs)
    assert after["banded_rotband"] - before["banded_rotband"] == 1
    assert after["traceback_walk"] - before["traceback_walk"] == total
    cuda_ext.add({k: before[k] - after[k] for k in before})


def test_one_shape_dispatched_from_two_threads_runs_eagerly_once(
        monkeypatch):
    """Two threads dispatching a new shape at once take distinct ordinals:
    one runs the step eagerly, the other builds the program (CAPTURE_AT
    2); each thread's scope counts its own dispatch."""
    import torch

    monkeypatch.setattr(graphs, "CAPTURE_AT", 2)
    gate = threading.Barrier(2)
    calls = []
    lock = threading.Lock()

    def step(x):
        with lock:
            calls.append(1)
            n = len(calls)
        if n <= 2:
            # the first two runs (one eager dispatch, one build's priming)
            # are in flight together; two eager runs would meet here too
            gate.wait(timeout=30)
        return x * 2

    key = ("test-two-threads", time.monotonic_ns())
    specs = [((4,), torch.int32)]
    outs, scopes = {}, {}

    def run(k):
        with cuda_ext.scope() as c:
            scopes[k] = c
            outs[k] = graphs.dispatch(key, lambda: step, specs, "cpu",
                                      torch.full((4,), k, dtype=torch.int32))

    threads = [threading.Thread(target=run, args=(k,)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    st = graphs.stats()[key]
    assert st["eager"] == 1 and st["builds"] == 1 and st["replays"] == 1
    assert sorted((s["eager_dispatches"], s["graph_replays"])
                  for s in scopes.values()) == [(0, 1), (1, 0)]


def test_clear_waits_for_a_replay_and_its_clone():
    """graphs.clear takes the replay lock: while one thread is between a
    replay and its clone (the lock held), clear does not drop anything."""
    done = threading.Event()
    graphs._replay_lock.acquire()
    try:
        t = threading.Thread(target=lambda: (graphs.clear(), done.set()))
        t.start()
        assert not done.wait(0.5)
    finally:
        graphs._replay_lock.release()
    assert done.wait(30)
    t.join()


@pytest.mark.parametrize("flag", [["--bam"], ["--hosts", "2"],
                                  ["--fleet-dir", "d"],
                                  ["--merge-shards", "2"], ["--make-index"]])
def test_serve_refuses_what_the_jax_server_refuses(flag, tmp_path, capsys):
    argv = ["serve", "--spool", str(tmp_path / "s"), "--port", "0",
            "--device", "cpu", *flag]
    assert cli.main(argv) == 1
    assert f"{flag[0]} is not supported under serve" in \
        capsys.readouterr().err
    assert not (tmp_path / "s").exists()


def test_serve_without_a_card_exits_before_binding(tmp_path, capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    assert cli.main(["serve", "--spool", str(tmp_path / "s"),
                     "--port", "0"]) == 1
    err = capsys.readouterr().err
    assert "Error: serve:" in err and "--device cpu" in err
    assert "http://" not in err and not (tmp_path / "s").exists()


# ---- served jobs ------------------------------------------------------------


def test_two_concurrent_jobs_byte_identical_then_no_builds(corpus,
                                                           core_factory):
    """Two jobs at once give the JAX CLI's bytes, each with its own
    counters; a second wave of the same jobs builds no refine program and
    dispatches nothing eagerly.  Inline prep and a pinned window (8 holes a
    job, under the fair window's 64) keep each job's slabs a function of
    its input alone."""
    fa3, ref3, _, _ = corpus
    core = core_factory(max_active=2, extra=["--no-warmup"])
    ov = {"prep_threads": 0, "inflight": 8}

    def wave():
        jobs = [core.submit(input_path=fa3, overrides=ov) for _ in range(2)]
        for j in jobs:
            assert core.wait(j.id, 120) == "done", (j.state, j.error)
            assert _out(j) == ref3
        return [core.job(j.id).info() for j in jobs]

    # the process's counts (other tests' programs included) before the wave
    base = core.metrics.snapshot()["programs"]["builds"]
    first = wave()
    progs = core.metrics.snapshot()["programs"]
    assert progs["builds"] > base
    for info in first:
        m = info["metrics"]
        assert m["holes_out"] == 3 and m["slabs"] >= 1
        assert m["eager_dispatches"] + m["graph_replays"] == m["slabs"]
        # on the CPU the plain versions run: no kernel launch is counted
        assert not any(m["launches"].values())
    # every shape of the wave: one eager dispatch, the rest replays
    assert sum(i["metrics"]["eager_dispatches"] for i in first) == \
        progs["builds"] - base
    second = wave()
    again = core.metrics.snapshot()["programs"]
    assert again["builds"] == progs["builds"], "the steady wave built"
    for info in second:
        m = info["metrics"]
        assert m["eager_dispatches"] == 0
        assert m["graph_replays"] == m["slabs"] == first[0]["metrics"]["slabs"]
    snaps = core.job_snapshots()
    assert len(snaps) == 4 and all(s["holes_out"] == 3
                                   for s in snaps.values())


def test_queue_cap_429_with_retry_after(corpus, served):
    fa3, ref3, _, _ = corpus
    core, req = served(max_active=1, max_queue=1, extra=["--no-warmup"])
    code, body, _ = req("POST", "/jobs", json.dumps(
        {"input": fa3, "faults": "stall@1"}).encode())
    assert code == 201
    held = json.loads(body)["id"]
    code, body, _ = req("POST", "/jobs", json.dumps({"input": fa3}).encode())
    assert code == 201
    queued = json.loads(body)["id"]
    with pytest.raises(QueueFull):
        core.submit(input_path=fa3)
    code, body, headers = req("POST", "/jobs",
                              json.dumps({"input": fa3}).encode())
    assert code == 429 and int(headers.get("Retry-After", 0)) >= 1
    code, body, _ = req("GET", "/readyz")
    assert code == 503 and json.loads(body)["reason"] == "queue full"
    code, body, _ = req("GET", "/healthz")
    assert code == 200 and json.loads(body)["status"] == "alive"
    for jid in (held, queued):
        assert core.wait(jid, 120) == "done"
        assert _out(core.job(jid)) == ref3
    code, body, _ = req("GET", f"/jobs/{held}/output")
    assert code == 200 and body == ref3
    code, _, _ = req("GET", "/readyz")
    assert code == 200


@pytest.mark.parametrize("key,value,field", [
    ("dispatch_deadline_s", "30", 30.0), ("breaker_strikes", 2, 2)])
def test_resilience_overrides_apply(key, value, field, corpus, served):
    """The JAX server's per-job resilience overrides: accepted over HTTP,
    coerced into the job's own config (from which the batched driver
    builds the job's Resilience), and the job runs to the JAX CLI's
    bytes."""
    fa3, ref3, _, _ = corpus
    core, req = served()
    code, body, _ = req("POST", "/jobs", json.dumps(
        {"input": fa3, key: value}).encode())
    assert code == 201, body
    jid = json.loads(body)["id"]
    assert core.wait(jid, 120) == "done"
    job = core.job(jid)
    assert getattr(job.cfg, key) == field
    assert getattr(core.cfg, key) != field
    assert _out(job) == ref3
    assert key in jserve._CFG_OVERRIDES and key in serve._CFG_OVERRIDES


def _join_abandoned(timeout=60.0):
    """Wait for every abandoned bounded call of this process to end, so
    that none wakes into a later test's refine programs."""
    for t in threading.enumerate():
        if t.name.startswith("ccsx-bounded-"):
            t.join(timeout)
            assert not t.is_alive(), t.name


def test_device_hang_degrades_only_the_faulted_job(corpus, served,
                                                   monkeypatch):
    """Job A's first device step hangs; its own 1.5 s dispatch deadline
    abandons the call and replays A's group per request.  Both jobs give
    the JAX CLI's bytes, the hang and the replays are booked in A alone,
    and the server stays ready (tests/test_serve.py's case).  The hang
    (6 s) is far past the deadline and ends within the test."""
    fa3, ref3, _, _ = corpus
    monkeypatch.setenv("CCSX_DEADLINE_GRACE", "1")
    monkeypatch.setenv("CCSX_FAULT_HANG_S", "6")
    core, req = served(max_active=2)
    bad = core.submit(input_path=fa3, overrides={
        "faults": "device_hang@1", "dispatch_deadline_s": 1.5})
    good = core.submit(input_path=fa3)
    assert core.wait(good.id, 180) == "done"
    assert core.wait(bad.id, 180) == "done", (bad.state, bad.error)
    assert _out(bad) == ref3 and _out(good) == ref3
    snaps = core.job_snapshots()
    assert snaps[bad.id]["device_hangs"] >= 1
    assert snaps[bad.id]["host_fallbacks"] >= 1
    assert snaps[bad.id]["degraded"]
    assert snaps[good.id]["device_hangs"] == 0
    assert snaps[good.id]["host_fallbacks"] == 0
    assert "degraded" not in snaps[good.id]
    code, body, _ = req("GET", "/readyz")
    assert code == 200
    code, body, _ = req("GET", "/metrics")
    text = body.decode()
    assert f'ccsx_job_device_hangs{{job="{good.id}"}} 0' in text
    bad_line = f'ccsx_job_device_hangs{{job="{bad.id}"}}'
    assert bad_line in text and f"{bad_line} 0" not in text
    _join_abandoned()


def test_submit_validation(served):
    _, req = served()
    code, body, _ = req("POST", "/jobs", json.dumps(
        {"input": "/nonexistent", "bogus_knob": 1}).encode())
    assert code == 400 and b"bogus_knob" in body
    code, body, _ = req("POST", "/jobs", b"{}")
    assert code == 400
    code, body, _ = req("POST", "/jobs", json.dumps(
        {"input": "/x.fa", "format": "sam"}).encode())
    assert code == 400 and b"format" in body
    code, body, _ = req("GET", "/jobs/zzz")
    assert code == 404
    code, body, _ = req("DELETE", "/jobs/zzz")
    assert code == 404


def test_cancel_mid_job_leaves_sibling_untouched(corpus, served):
    fa3, ref3, _, _ = corpus
    core, req = served(max_active=2, extra=["--no-warmup"])
    code, body, _ = req("POST", "/jobs", json.dumps(
        {"input": fa3, "faults": "stall@1"}).encode())
    victim = json.loads(body)["id"]
    code, body, _ = req("POST", "/jobs", json.dumps({"input": fa3}).encode())
    sibling = json.loads(body)["id"]
    deadline = time.monotonic() + 60
    while (core.job(victim).state != "running"
           and time.monotonic() < deadline):
        time.sleep(0.05)
    time.sleep(0.5)  # stall@1 holds the victim mid-flight
    code, body, _ = req("DELETE", f"/jobs/{victim}")
    assert code == 200 and json.loads(body)["cancelled"]
    assert core.wait(victim, 60) == "cancelled"
    assert core.job(victim).rc == exitcodes.RC_INTERRUPTED
    code, body, _ = req("DELETE", f"/jobs/{victim}")
    assert code == 409
    assert core.wait(sibling, 120) == "done"
    assert _out(core.job(sibling)) == ref3
    code, body, _ = req("GET", f"/jobs/{victim}/output")
    assert code == 409


def test_drain_rc75_and_restart_resumes_byte_identical(corpus, tmp_path):
    _, _, fa8, ref8 = corpus
    spool = str(tmp_path / "spool")
    core = ServeCore(_cfg(["--no-warmup"]), spool=spool, max_active=1)
    try:
        # a window of two holes bounds ingest-ahead to 8 holes, so a drain
        # during the stalled first dispatch leaves work for the resume
        j = core.submit(input_path=fa8, overrides={
            "faults": "stall@1", "inflight": 2, "prep_threads": 0})
        deadline = time.monotonic() + 60
        while (core.job(j.id).state != "running"
               and time.monotonic() < deadline):
            time.sleep(0.05)
        time.sleep(0.8)
        assert core.drain(timeout=120) == exitcodes.RC_INTERRUPTED
        job = core.job(j.id)
        assert job.state == "interrupted"
        assert job.rc == exitcodes.RC_INTERRUPTED
        done = json.loads(open(job.journal_path).read())["holes_done"]
        assert 0 < done < 8
        state = json.load(open(os.path.join(spool, serve.STATE_FILE)))
        assert [r["state"] for r in state["jobs"]] == ["interrupted"]
    finally:
        core.close()
    core2 = ServeCore(_cfg(["--no-warmup"]), spool=spool, max_active=1)
    try:
        assert core2.wait(j.id, 120) == "done"
        assert _out(core2.job(j.id)) == ref8
    finally:
        core2.close()


def test_liveness_vs_readiness_split(served):
    core, req = served()
    code, body, _ = req("GET", "/healthz")
    assert code == 200 and json.loads(body)["status"] == "alive"
    code, body, _ = req("GET", "/readyz")
    assert code == 200 and json.loads(body)["ready"] is True
    code, body, _ = req("GET", "/progress")
    assert code == 200 and "programs" in json.loads(body)
    assert core.drain(timeout=10) == exitcodes.RC_OK  # idle drain
    code, body, _ = req("GET", "/healthz")
    assert code == 200
    code, body, _ = req("GET", "/readyz")
    assert code == 503 and json.loads(body)["reason"] == "draining"
    code, body, _ = req("POST", "/jobs", b"{}")
    assert code == 503


def test_job_prom_schema_matches_snapshot(corpus, core_factory):
    fa3, _, _, _ = corpus
    core = core_factory(extra=["--no-warmup"])
    j = core.submit(input_path=fa3, overrides={"prep_threads": 0})
    assert core.wait(j.id, 120) == "done"
    snap = core.job_snapshots()[j.id]
    missing = [k for k in (telemetry.JOB_PROM_COUNTERS
                           + telemetry.JOB_PROM_GAUGES) if k not in snap]
    assert not missing
    text = telemetry.render_job_series({j.id: snap})
    assert text == jtelemetry.render_job_series({j.id: snap})
    for key in telemetry.JOB_PROM_COUNTERS:
        assert f'ccsx_job_{key}{{job="{j.id}"}}' in text


def test_device_fault_stops_the_server_and_a_restart_resumes(
        corpus, served, monkeypatch, tmp_path):
    """A kernel failure in one job: /readyz 503 device_fault, no further job
    starts, the sibling drains, state.json holds both, and a new core on
    the same spool finishes both to the JAX CLI's bytes."""
    fa3, ref3, _, _ = corpus
    real = batch.BatchExecutor.run
    fired = []
    # the fault waits for the sibling's first refine sweep: a fault before
    # the sibling's submit has pumped it (a starved test thread) would
    # leave the sibling queued, never started
    sibling_running = threading.Event()

    def run(self, reqs):
        name = threading.current_thread().name
        if name == "ccsx-job-j0001":
            sibling_running.wait(120)
            fired.append(1)
            raise cuda_ext.KernelError("banded global fill: CUDA launch "
                                       "failed (injected)")
        if name == "ccsx-job-j0002":
            sibling_running.set()
        return real(self, reqs)

    monkeypatch.setattr(batch.BatchExecutor, "run", run)
    core, req = served(max_active=2, extra=["--no-warmup"])
    bad = core.submit(input_path=fa3)
    # the sibling is held mid-flight by its stall, so the stop drains it
    good = core.submit(input_path=fa3, overrides={
        "faults": "stall@1", "inflight": 1, "prep_threads": 0})
    assert core.wait(bad.id, 120) == "interrupted"
    assert fired
    code, body, _ = req("GET", "/readyz")
    assert code == 503 and json.loads(body)["reason"] == "device_fault"
    assert core.device_fault and "injected" in core.device_fault
    assert core.wait(good.id, 120) == "interrupted"
    assert core.job(bad.id).rc == exitcodes.RC_FATAL
    assert "device fault" in core.job(bad.id).error
    code, _, _ = req("POST", "/jobs", json.dumps({"input": fa3}).encode())
    assert code == 503
    assert core.drain(timeout=60) == exitcodes.RC_INTERRUPTED
    spool = core.spool
    state = json.load(open(os.path.join(spool, serve.STATE_FILE)))
    assert {r["id"]: r["state"] for r in state["jobs"]} == {
        bad.id: "interrupted", good.id: "interrupted"}
    core.close()
    monkeypatch.setattr(batch.BatchExecutor, "run", real)
    core2 = ServeCore(_cfg(["--no-warmup"]), spool=spool, max_active=2)
    try:
        assert core2.wait(bad.id, 120) == "done"
        assert core2.wait(good.id, 120) == "done"
        assert _out(core2.job(bad.id)) == ref3
        assert _out(core2.job(good.id)) == ref3
        assert core2.readiness() == (True, "ok")
    finally:
        core2.close()
