"""The port's supervisor (pipeline/supervisor.py, ``shepherd``) against the
JAX package's.

Units run through either package's module on the same inputs: the
shepherd-only flag stripping, the heartbeat paths and their newest mtime,
and every refusal of ``shepherd_main`` (same rc, same first stderr line).
The port's runner prelude and the command lines it launches name neither
jax nor the JAX package, whatever JAX_PLATFORMS says.

End to end, on tests/test_supervisor.py's geometry (4 holes of 700 bp, 5
passes), every child is a ``--device cpu --batch on`` process of the port
and every merged or served output is held to the JAX CLI's ``--batch on``
bytes: a rank death restarted and resumed from its shard journal, a
budget abort (rc 2) not restarted, exhausted restarts (rc 1), a fleet
worker killed mid-range whose ranges the survivor absorbs, and a
``--serve-replicas 2`` fleet behind its gateway with a replica SIGKILLed
and relaunched.  The JAX package's slow cases are ported as slow.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from ccsx_tpu import cli as jcli
from ccsx_tpu.pipeline import supervisor as jsupervisor

from ccsx_tpu_torch import cli, exitcodes
from ccsx_tpu_torch.pipeline import fleet, gateway, supervisor
from ccsx_tpu_torch.utils import faultinject, synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-A", "-m", "1000", "--batch", "on"]
PORT = FLAGS + ["--device", "cpu"]
MODS = {"jax": jsupervisor, "port": supervisor}


def _child_env(**extra):
    # children of one test share the CPU with the other test workers
    return dict(os.environ, CCSX_JOURNAL_FSYNC_S="0", OMP_NUM_THREADS="2",
                PYTHONPATH=ROOT, **extra)


# ---- units, both packages ---------------------------------------------------


@pytest.mark.parametrize("argv,want", [
    (["-A", "--max-rank-restarts", "3", "in.fa", "--rank-backoff", "0.5",
      "--rank-stall-timeout=9", "out.fa", "--hosts", "2"],
     ["-A", "in.fa", "out.fa", "--hosts", "2"]),
    (["--fleet-ranges", "8", "--lease-timeout", "4", "--join", "d",
      "--device", "cpu", "a", "b"], ["--device", "cpu", "a", "b"]),
    (["--fleet-ranges=8", "--lease-timeout=4", "--max-rank-restarts",
      "0", "x"], ["x"]),
    (["-A", "in.fa", "out.fa"], ["-A", "in.fa", "out.fa"]),
])
@pytest.mark.parametrize("pkg", list(MODS))
def test_strip_shepherd_flags(pkg, argv, want):
    assert MODS[pkg].strip_shepherd_flags(argv) == want


@pytest.mark.parametrize("pkg", list(MODS))
def test_strip_named_flags_as_the_restarts_do(pkg):
    argv = ["--inject-faults", "rank_death@1", "-A", "--hosts", "2",
            "--journal=j", "in", "out"]
    got = MODS[pkg].strip_shepherd_flags(argv, flags=("--inject-faults",
                                                      "--journal"))
    assert got == ["-A", "--hosts", "2", "in", "out"]


@pytest.mark.parametrize("pkg", list(MODS))
def test_beat_paths_and_latest_mtime(pkg, tmp_path):
    mod = MODS[pkg]
    out, jp = str(tmp_path / "o.fa"), str(tmp_path / "j")
    paths = mod._beat_paths(out, jp, 1)
    assert paths == supervisor._beat_paths(out, jp, 1) == \
        jsupervisor._beat_paths(out, jp, 1) == \
        [f"{jp}.shard1", f"{out}.shard1", f"{out}.shard1.idx"]
    assert mod._latest_mtime(paths) is None
    a, b = paths[0], paths[2]
    open(a, "w").write("x")
    open(b, "w").write("y")
    os.utime(a, (1000.0, 1000.0))
    os.utime(b, (2000.0, 2000.0))
    assert mod._latest_mtime(paths) == 2000.0
    assert mod._latest_mtime([a, str(tmp_path / "nope")]) == 1000.0


REFUSALS = {
    "no_hosts": ["in.fa", "OUT"],
    "hosts_zero": ["--hosts", "0", "in.fa", "OUT"],
    "host_id": ["--hosts", "2", "--host-id", "0", "in.fa", "OUT"],
    "stdin": ["--hosts", "2"],
    "stdout": ["--hosts", "2", "in.fa", "-"],
    "batch_off": ["--hosts", "2", "--batch", "off", "in.fa", "OUT"],
    "merge_shards": ["--hosts", "2", "--merge-shards", "2", "in.fa", "OUT"],
    "make_index": ["--hosts", "2", "--make-index", "in.fa", "OUT"],
    "bam": ["--hosts", "2", "--bam", "in.fa", "OUT"],
    "min_count": ["--hosts", "2", "-c", "2", "in.fa", "OUT"],
    "join_no_state": ["--join", "FLEET", "--hosts", "1", "in.fa", "OUT"],
    "serve_no_spool": ["--serve-replicas", "2"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_shepherd_main_refusals_match(case, tmp_path, capsys):
    """Every refusal: the JAX package's rc and first stderr line, and no
    child started (nothing but the message is written)."""
    argv = [a.replace("OUT", str(tmp_path / "o.fa"))
            .replace("FLEET", str(tmp_path / "f")) for a in REFUSALS[case]]
    got = {}
    for pkg in ("port", "jax"):
        rc = MODS[pkg].shepherd_main(list(argv))
        err = capsys.readouterr().err.strip().splitlines()
        got[pkg] = (rc, err[0] if err else "")
    assert got["port"] == got["jax"]
    assert got["port"][0] != 0 and got["port"][1]
    assert sorted(os.listdir(tmp_path)) == []


def test_shepherd_is_a_subcommand_and_help_is_the_usage(tmp_path, capsys):
    out = str(tmp_path / "o.fa")
    assert cli.main(["shepherd", "in.fa", out]) == exitcodes.RC_FATAL
    assert "--hosts" in capsys.readouterr().err
    assert cli.main(["shepherd", "-h"]) == jcli.main(["shepherd", "-h"]) \
        == exitcodes.RC_FATAL
    port_out = capsys.readouterr().out
    assert port_out.startswith(cli.USAGE)
    for flag in ("--max-rank-restarts", "--rank-stall-timeout",
                 "--fleet-ranges", "--lease-timeout", "--join",
                 "--serve-replicas", "--gateway-port",
                 "--max-replica-restarts", "--replica-backoff"):
        assert flag in cli.USAGE


# ---- the children's command lines -------------------------------------------


class _FakeChild:
    """A child that has already exited rc 0; records its command line."""
    launched = []

    def __init__(self, cmd, env=None, **kw):
        self.cmd, self.env = list(cmd), env
        self.pid = 4_000_000 + len(_FakeChild.launched)
        self.returncode = 0
        _FakeChild.launched.append(self)

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0

    def send_signal(self, sig):
        pass

    def kill(self):
        pass


@pytest.mark.parametrize("platforms", ["cpu", "unset"])
def test_children_run_the_port_cli_only(platforms, tmp_path, monkeypatch,
                                        capsys):
    """Under JAX_PLATFORMS=cpu and without it, the prelude is empty and
    every rank, fleet worker, joined worker, replica and gateway command
    runs ``ccsx_tpu_torch.cli`` and names neither jax nor the JAX package;
    a child's device is its argv's (``--device cpu`` forwarded here)."""
    if platforms == "unset":
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    assert supervisor.default_prelude() == ""
    monkeypatch.setattr(supervisor.subprocess, "Popen", _FakeChild)
    _FakeChild.launched = []
    fa = tmp_path / "in.fa"
    rng = np.random.default_rng(1)
    fa.write_text(synth.make_fasta([
        synth.make_zmw(rng, 300, 4, movie="mv", hole=str(h))
        for h in range(3)]))
    out = str(tmp_path / "o.fa")
    fwd = PORT + ["--hosts", "2", str(fa), out]
    # the fake ranks wrote no shards: the merge refuses, rc 1
    assert supervisor.shepherd_run(str(fa), out, 2, fwd,
                                   poll_s=0.01) == exitcodes.RC_FATAL
    cfg = cli.config_from_args(cli.build_parser().parse_args(fwd))
    supervisor.fleet_run(str(fa), out, cfg, 2, fwd, ranges=2, poll_s=0.01)
    assert supervisor.fleet_join(fleet.fleet_dir_for(out), 1,
                                 poll_s=0.01) == 0
    spool = str(tmp_path / "spool")
    assert supervisor.serve_fleet_run(
        spool, 2, ["--fleet", spool, "--device", "cpu"], gateway_port=9,
        poll_s=0.01) == 0
    capsys.readouterr()
    kinds = []
    for child in _FakeChild.launched:
        assert child.cmd[:2] == [sys.executable, "-c"]
        assert child.cmd[2] == supervisor._RUNNER
        assert "from ccsx_tpu_torch.cli import main" in child.cmd[2]
        line = " ".join(child.cmd)
        assert "jax" not in line and "ccsx_tpu." not in line
        assert child.env.get("JAX_PLATFORMS") == os.environ.get(
            "JAX_PLATFORMS")
        argv = child.cmd[3:]
        if argv[0] == "gateway":
            kinds.append("gateway")
            continue
        assert argv[argv.index("--device") + 1] == "cpu"
        kinds.append("serve" if argv[0] == "serve" else
                     "rank" if "--host-id" in argv else "worker")
    assert kinds == ["rank"] * 2 + ["worker"] * 3 + ["serve"] * 2 + \
        ["gateway"]


# ---- end to end, subprocess children ----------------------------------------


@pytest.fixture(scope="module")
def corpus4(tmp_path_factory):
    """(4-hole input, the JAX CLI's --batch on bytes): rank 1 of 2 owns
    two holes, so a death at its first retirement lands mid-shard."""
    tmp = tmp_path_factory.mktemp("shepherd")
    rng = np.random.default_rng(0)
    zs = [synth.make_zmw(rng, template_len=700, n_passes=5, movie="mv",
                         hole=str(100 + h)) for h in range(4)]
    fa = tmp / "in.fa"
    fa.write_text(synth.make_fasta(zs))
    ref = tmp / "ref.fa"
    assert jcli.main(FLAGS + ["--device", "cpu", str(fa), str(ref)]) == 0
    return str(fa), ref.read_bytes()


@pytest.fixture(autouse=True)
def _disarmed():
    faultinject.disarm()
    yield
    faultinject.disarm()


def test_shepherd_restarts_dead_rank_and_merges(corpus4, tmp_path, capsys):
    """Rank 1's first launch dies at its first retirement (rank_death, rc
    57); the restart runs clean, resumes from its shard journal, and the
    merge is the JAX CLI's bytes."""
    fa, ref = corpus4
    out = str(tmp_path / "o.fa")
    fwd = PORT + ["--hosts", "2", fa, out]
    rc = supervisor.shepherd_run(
        fa, out, 2, fwd, max_restarts=2, backoff_s=0.1, poll_s=0.1,
        env=_child_env(),
        first_launch_env={1: {"CCSX_FAULTS": "rank_death@1"}})
    err = capsys.readouterr().err
    assert rc == 0, err
    assert open(out, "rb").read() == ref
    assert f"died (rc {faultinject.EXIT_CODE})" in err
    assert "restarting in" in err and "merged 4 records from 2 ranks" in err
    log1 = open(out + ".shard1.log").read()
    assert "attempt 0" in log1 and "attempt 1" in log1
    assert "rank_death" in log1
    assert "attempt 1" not in open(out + ".shard0.log").read()


def test_shepherd_budget_abort_is_not_restarted(corpus4, tmp_path, capsys):
    fa, _ = corpus4
    out = str(tmp_path / "o.fa")
    fwd = PORT + ["--hosts", "1", "--max-failed-holes", "0", fa, out]
    rc = supervisor.shepherd_run(
        fa, out, 1, fwd, max_restarts=3, backoff_s=0.05, poll_s=0.05,
        env=_child_env(),
        first_launch_env={0: {"CCSX_FAULTS": "compute@1+"}})
    assert rc == exitcodes.RC_FAILED_HOLES
    assert "not restartable" in capsys.readouterr().err
    log0 = open(out + ".shard0.log").read()
    assert "attempt 0" in log0 and "attempt 1" not in log0


def test_shepherd_exhausted_restarts_fails_cleanly(corpus4, tmp_path,
                                                   capsys):
    """A rank that fails on every launch (its output directory does not
    exist) exhausts its restarts: rc 1, naming the rank."""
    fa, _ = corpus4
    out = str(tmp_path / "ro" / "sub" / "o.fa")
    os.makedirs(tmp_path / "ro")
    fwd = PORT + ["--hosts", "1", fa, out]
    rc = supervisor.shepherd_run(fa, out, 1, fwd, max_restarts=1,
                                 backoff_s=0.05, poll_s=0.05,
                                 env=_child_env())
    assert rc == exitcodes.RC_FATAL
    err = capsys.readouterr().err
    assert "exhausted its 1 restart(s)" in err and "rank 0" in err


def _fleet(fa, out, hosts, **kw):
    fwd = PORT + [fa, out]
    cfg = cli.config_from_args(cli.build_parser().parse_args(fwd))
    kw.setdefault("env", _child_env())
    return supervisor.fleet_run(fa, out, cfg, hosts, fwd, ranges=4,
                                lease_timeout=5.0, poll_s=0.1,
                                backoff_s=0.1, **kw)


def test_fleet_run_dead_worker_rebalances(corpus4, tmp_path, capsys):
    """Worker 1 dies at its first retirement with no restart budget: its
    lease is reclaimed at reap time, the survivor resumes the range from
    its journal, and the merge of the 4 range markers is the JAX CLI's
    bytes."""
    fa, ref = corpus4
    out = str(tmp_path / "o.fa")
    rc = _fleet(fa, out, 2, max_restarts=0,
                first_launch_env={1: {"CCSX_FAULTS": "rank_death@1"}})
    err = capsys.readouterr().err
    assert rc == 0, err
    assert open(out, "rb").read() == ref
    assert "requeued range(s)" in err
    assert "merged 4 records from 4 leased ranges" in err
    assert not os.path.exists(fleet.fleet_dir_for(out))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _http(method, url, body=None):
    import json
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            code, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        code, raw = e.code, e.read()
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw


def _wait(pred, what, timeout=240.0, proc=None, log=None):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"shepherd exited {proc.returncode} "
                                 f"waiting for {what}:\n"
                                 f"{open(log).read()[-4000:]}")
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def test_serve_replicas_fleet_relaunches_a_killed_replica(corpus4, tmp_path):
    """``shepherd --serve-replicas 2 --gateway-port P --fleet SPOOL``: a job
    through the gateway gives the JAX CLI's bytes; a replica SIGKILLed
    is relaunched (attempt 1 in its log) and comes back ready, and the
    fleet serves a second job to the same bytes; SIGTERM drains every
    child and the shepherd ends rc 0, as the JAX package's does."""
    fa, ref = corpus4
    spool = str(tmp_path / "spool")
    log = str(tmp_path / "shepherd.log")
    argv = [sys.executable, "-m", "ccsx_tpu_torch.cli", "shepherd",
            "--serve-replicas", "2", "--gateway-port", str(_free_port()),
            "--replica-backoff", "0.2", "--fleet", spool,
            "--port", str(_free_port()), "--lease-timeout", "5",
            "--poll", "0.1", "-A", "-m", "1000", "--device", "cpu",
            "--no-warmup"]
    with open(log, "w") as f:
        proc = subprocess.Popen(argv, cwd=ROOT, env=_child_env(),
                                stdout=f, stderr=subprocess.STDOUT)
    try:
        def text():
            return open(log).read()

        def gw_url():
            try:
                m = re.findall(r"gateway: http://[^:]+:(\d+) ",
                               open(os.path.join(spool,
                                                 "gateway.log")).read())
            except OSError:
                return None
            return f"http://127.0.0.1:{m[-1]}" if m else None

        def ready(pids):
            reps = gateway.discover_replicas(spool)
            live = {r["pid"] for r in reps if r.get("ready")}
            return pids <= live

        def pids(name):
            return [int(p) for p in re.findall(
                rf"serve-fleet: {name} up \(pid (\d+), attempt", text())]

        gw = _wait(gw_url, "the gateway", proc=proc, log=log)
        _wait(lambda: len(pids("s0")) == len(pids("s1")) == 1,
              "both replicas", proc=proc, log=log)
        _wait(lambda: ready({pids("s0")[0], pids("s1")[0]}),
              "both replicas ready", proc=proc, log=log)

        def serve_one():
            code, body = _http("POST", gw + "/jobs",
                               {"input": fa, "prep_threads": 0})
            assert code == 201, body
            jid = body["id"]

            def terminal():
                view = _http("GET", f"{gw}/jobs/{jid}")[1]
                return view if view.get("state") in (
                    "done", "failed", "cancelled") else None

            view = _wait(terminal, f"job {jid}", proc=proc, log=log)
            assert view["state"] == "done", view
            code, data = _http("GET", f"{gw}/jobs/{jid}/output")
            assert code == 200 and data == ref
            return jid

        first = serve_one()
        old = pids("s0")[0]
        os.kill(old, signal.SIGKILL)
        _wait(lambda: len(pids("s0")) == 2, "s0's relaunch", proc=proc,
              log=log)
        new = pids("s0")[1]
        assert "attempt 1" in open(os.path.join(spool, "s0.log")).read()
        assert f"s0 died (rc {-signal.SIGKILL})" in text()
        _wait(lambda: ready({new}), "the relaunched s0 ready", proc=proc,
              log=log)
        second = serve_one()
        markers = sorted(n for n in os.listdir(spool)
                         if n.startswith("done.") and n.endswith(".json"))
        assert markers == sorted(f"done.{j}.json" for j in (first, second))
        children = [new, pids("s1")[-1]] + [int(p) for p in re.findall(
            r"serve-fleet: gateway up \(pid (\d+)", text())]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == exitcodes.RC_OK, text()[-4000:]
        for pid in children:
            assert not os.path.exists(f"/proc/{pid}") or \
                open(f"/proc/{pid}/stat").read().split()[2] == "Z"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# ---- the JAX package's slow cases -------------------------------------------


@pytest.mark.slow
def test_shepherd_drained_rank_is_not_charged_a_restart(corpus4, tmp_path,
                                                        capsys):
    """A rank draining rc 75 is relaunched at once, as attempt 0 again,
    without spending the (zero) restart budget; the merge is the JAX
    CLI's bytes."""
    fa, ref = corpus4
    out = str(tmp_path / "o.fa")
    fwd = PORT + ["--hosts", "2", fa, out]
    rc = supervisor.shepherd_run(
        fa, out, 2, fwd, max_restarts=0, backoff_s=0.1, poll_s=0.1,
        env=_child_env(),
        first_launch_env={1: {"CCSX_FAULTS": "sigterm@1"}})
    err = capsys.readouterr().err
    assert rc == 0, err
    assert open(out, "rb").read() == ref
    assert "voluntary preemption" in err and "drained (rc 75)" in err
    assert "restarting in" not in err
    log1 = open(out + ".shard1.log").read()
    assert log1.count("attempt 0") == 2 and "attempt 1" not in log1


@pytest.mark.slow
def test_fleet_run_no_faults_byte_identical(corpus4, tmp_path, capsys):
    fa, ref = corpus4
    out = str(tmp_path / "o.fa")
    rc = _fleet(fa, out, 2)
    err = capsys.readouterr().err
    assert rc == 0, err
    assert open(out, "rb").read() == ref
    assert "merged 4 records from 4 leased ranges" in err
    assert not os.path.exists(fleet.fleet_dir_for(out))


@pytest.mark.slow
def test_fleet_run_sigterm_drain_is_voluntary_leave(corpus4, tmp_path,
                                                    capsys):
    fa, ref = corpus4
    out = str(tmp_path / "o.fa")
    rc = _fleet(fa, out, 2, max_restarts=0,
                first_launch_env={1: {"CCSX_FAULTS": "sigterm@1"}})
    err = capsys.readouterr().err
    assert rc == 0, err
    assert open(out, "rb").read() == ref
    log1 = open(out + ".fleet.w1.log").read()
    assert "sigterm" in log1
    assert "drained" in log1 or "voluntary leave" in err


@pytest.mark.slow
def test_fleet_join_mid_run(corpus4, tmp_path, capsys):
    fa, ref = corpus4
    out = str(tmp_path / "o.fa")
    d = fleet.fleet_dir_for(out)
    join_rc = []

    def joiner():
        for _ in range(400):
            if fleet.load_fleet(d):
                break
            time.sleep(0.05)
        join_rc.append(supervisor.fleet_join(d, 1, poll_s=0.1,
                                             env=_child_env()))

    t = threading.Thread(target=joiner)
    t.start()
    rc = _fleet(fa, out, 1)
    t.join()
    err = capsys.readouterr().err
    assert rc == 0, err
    assert open(out, "rb").read() == ref
    assert "joined worker" in err
    assert join_rc == [0]


@pytest.mark.slow
def test_fleet_run_whole_fleet_drained_resumes(corpus4, tmp_path, capsys):
    fa, ref = corpus4
    out = str(tmp_path / "o.fa")
    rc = _fleet(fa, out, 1, max_restarts=0,
                first_launch_env={0: {"CCSX_FAULTS": "sigterm@2"}})
    err = capsys.readouterr().err
    assert rc == exitcodes.RC_INTERRUPTED, err
    assert "re-run the same command to resume" in err
    assert os.path.exists(fleet.fleet_dir_for(out))
    rc = _fleet(fa, out, 1)
    err = capsys.readouterr().err
    assert rc == 0, err
    assert open(out, "rb").read() == ref
