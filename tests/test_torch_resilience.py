"""The port's resilience plane (ccsx_tpu_torch/pipeline/resilience.py and its
wiring in pipeline/batch.py and cli.py) against the JAX package's.

The units of tests/test_resilience.py run through both packages' modules:
``bounded_call``, the first-call grace, the circuit breaker (trip, probe,
the token-bound verdict, the probe released on a data failure, disabled,
the window), a half-open probe that recovers through each package's
recovery ladder, and ``classify_failure`` giving ``hang``.

The CLI cases run the port on the CPU on tests/test_resilience.py's corpus
(3 holes of 700-bp templates, 5 passes, rng(0)) and hold its output to the
JAX CLI's ``--batch on`` bytes on the same file: an injected permanent hang
abandoned at ``--dispatch-deadline`` (rc 0, degraded, ``device_hangs`` >= 1,
a wall far under the hang), a run with deadlines off (no resilience counter
moves), a ``device_oom@1+`` breaker trip (``open``), and a hang that ends
inside the run (the abandoned call wakes and dispatches; its result is
discarded and the bytes do not move).  Bad flag values give the JAX CLI's
rc and first stderr line.  No test waits out a real hang:
``CCSX_DEADLINE_GRACE=1`` and deadlines of a few seconds.  Bytes and counts
are integers: the tolerance is exact equality.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from ccsx_tpu import cli as jcli
from ccsx_tpu.pipeline import batch as jbatch
from ccsx_tpu.pipeline import resilience as jresil
from ccsx_tpu.utils.metrics import Metrics as JMetrics

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.pipeline import batch, resilience
from ccsx_tpu_torch.utils import faultinject, synth
from ccsx_tpu_torch.utils.run_metrics import RunMetrics

# (resilience module, batch module, Metrics, a device step's output)
PACKAGES = {
    "jax": (jresil, jbatch, JMetrics, lambda: np.zeros(2)),
    "port": (resilience, batch, RunMetrics, lambda: torch.zeros(2)),
}
ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ["-A", "-m", "1000", "--device", "cpu", "--batch", "on",
        "--prep-threads", "0"]


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    """Unit-scale budgets: grace x1 and a bounded hang sleep, so the
    abandoned daemon threads do not outlive the suite by an hour."""
    faultinject.disarm()
    monkeypatch.setenv("CCSX_DEADLINE_GRACE", "1")
    monkeypatch.setenv("CCSX_FAULT_HANG_S", "60")
    yield
    faultinject.disarm()


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(deadline=0.0, strikes=3, probe=0.0):
    return types.SimpleNamespace(dispatch_deadline_s=deadline,
                                 breaker_strikes=strikes,
                                 breaker_window_s=60.0,
                                 breaker_probe_s=probe)


# ---- units, through both packages ------------------------------------------


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_bounded_call_semantics(pkg):
    mod = PACKAGES[pkg][0]
    assert mod.bounded_call(lambda: 42, 0) == 42          # inline
    assert mod.bounded_call(lambda: 42, 5.0) == 42        # bounded, in time
    with pytest.raises(ValueError, match="boom"):
        mod.bounded_call(lambda: (_ for _ in ()).throw(ValueError("boom")),
                         5.0)
    t0 = time.monotonic()
    with pytest.raises(mod.DeadlineExpired, match="exceeded"):
        mod.bounded_call(lambda: time.sleep(30), 0.2, "g", "dispatch")
    assert time.monotonic() - t0 < 5.0   # the waiter returns promptly


def test_bounded_call_carries_the_callers_context():
    """The worker runs in a copy of the caller's context: the fault scope,
    the trace cid and a served job's launch scope all reach it."""
    from ccsx_tpu_torch.ops import cuda_ext
    from ccsx_tpu_torch.utils import trace

    token = faultinject.scope_arm("compute@1")
    try:
        with trace.cid_scope("job-7"), cuda_ext.scope() as sc:
            seen = resilience.bounded_call(
                lambda: (faultinject.current_scope(), trace.current_cid(),
                         cuda_ext._scope.get()), 5.0)
            assert seen == (faultinject.current_scope(), "job-7", sc)
    finally:
        faultinject.scope_reset(token)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_classify_failure_hang(pkg):
    mod, bmod = PACKAGES[pkg][:2]
    assert bmod.classify_failure(
        mod.DeadlineExpired("packed:q1024", "dispatch", 2.0)) == "hang"
    assert bmod.classify_failure(ValueError("bad draft")) == "data"
    oom = (RuntimeError("RESOURCE_EXHAUSTED: x") if pkg == "jax"
           else torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert bmod.classify_failure(oom) == "oom"


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_deadline_grace_first_call_only(pkg, monkeypatch):
    mod = PACKAGES[pkg][0]
    r = mod.Resilience(_cfg(deadline=2.0))
    assert r.grace == 1.0
    assert r.budget("g", "dispatch") == r.budget("g", "dispatch") == 2.0
    monkeypatch.setenv("CCSX_DEADLINE_GRACE", "10")
    r = mod.Resilience(_cfg(deadline=2.0))
    assert r.budget("g", "dispatch") == 20.0      # first: the grace
    assert r.budget("g", "dispatch") == 2.0       # steady state
    assert r.budget("g", "materialize") == 20.0   # per phase
    assert not mod.Resilience(_cfg()).enabled


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_breaker_trips_and_probes(pkg):
    mod, _, metrics_cls, _ = PACKAGES[pkg]
    m = metrics_cls()
    b = mod.CircuitBreaker(strikes=2, window_s=60.0, probe_s=0.05,
                           metrics=m)
    assert b.admit() == "closed" and b.state == "closed"
    b.strike("oom", "g")
    assert b.admit() == "closed"
    b.strike("hang", "g")
    assert b.state == "open" and m.breaker_trips == 1
    assert b.admit() == "host"
    time.sleep(0.06)
    assert b.admit() == "probe"
    assert b.state == "half-open" and m.breaker_probes == 1
    assert b.admit() == "host"            # one probe in flight
    b.strike("oom", "g", probe=True)      # the probe failed: re-open
    assert b.state == "open"
    time.sleep(0.06)
    assert b.admit() == "probe"
    b.probe_succeeded()
    assert b.state == "closed" and m.breaker_state == "closed"
    assert len(m.breaker_strike_log) == 3
    assert {s["kind"] for s in m.breaker_strike_log} == {"oom", "hang"}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_breaker_probe_verdict_is_token_bound(pkg):
    mod = PACKAGES[pkg][0]
    b = mod.CircuitBreaker(strikes=1, window_s=60.0, probe_s=0.05)
    b.strike("oom", "g")
    time.sleep(0.06)
    assert b.admit() == "probe"
    b.strike("oom", "other")              # not the probe's: ignored
    assert b.state == "half-open"
    b.strike("hang", "g", probe=True)
    assert b.state == "open"


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_breaker_disabled_and_window(pkg):
    mod = PACKAGES[pkg][0]
    b = mod.CircuitBreaker(strikes=0)
    for _ in range(10):
        b.strike("oom", "g")
        assert b.admit() == "closed" and b.state == "closed"
    b = mod.CircuitBreaker(strikes=2, window_s=0.05)
    b.strike("oom", "g")
    time.sleep(0.08)
    b.strike("oom", "g")                  # the first aged out
    assert b.state == "closed"


def _ladder(pkg, plan, resil, m):
    """One single-request group through the package's recovery ladder;
    ``plan[n]`` is what the n-th dispatch does (an exception to raise, or
    None for a device output).  Returns (result, dispatches)."""
    bmod, out = PACKAGES[pkg][1], PACKAGES[pkg][3]
    calls = {"n": 0}
    results = [None]

    def dispatch(idxs, key):
        step = plan[min(calls["n"], len(plan) - 1)]
        calls["n"] += 1
        if step is not None:
            raise step
        return out()

    def finish(idxs, key, res):
        results[0] = "device"

    bmod._run_groups_recovering({"g": [0]}, dispatch, finish,
                                lambda i: "host", results, m,
                                label=lambda k: "grp", resil=resil)
    return results[0], calls["n"]


def _oom(pkg):
    return (RuntimeError("RESOURCE_EXHAUSTED: injected") if pkg == "jax"
            else torch.cuda.OutOfMemoryError("CUDA out of memory"))


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_breaker_probe_recovers_through_recovery_ladder(pkg):
    mod, _, metrics_cls, _ = PACKAGES[pkg]
    m = metrics_cls()
    resil = mod.Resilience(_cfg(strikes=1, probe=0.05), metrics=m)
    # a one-request group OOMs: the ladder's bottom strikes and trips
    assert _ladder(pkg, [_oom(pkg)], resil, m) == ("host", 1)
    assert m.breaker_state == "open" and m.breaker_trips == 1
    assert m.host_fallbacks == 1
    # open: the per-request path, no device step
    assert _ladder(pkg, [None], resil, m) == ("host", 0)
    assert m.host_fallbacks == 2
    # the probe is due: one device step, whose success closes the breaker
    time.sleep(0.06)
    assert _ladder(pkg, [None], resil, m) == ("device", 1)
    assert m.breaker_state == "closed" and m.breaker_probes == 1


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_breaker_probe_settles_on_data_failure(pkg):
    mod, _, metrics_cls, _ = PACKAGES[pkg]
    m = metrics_cls()
    resil = mod.Resilience(_cfg(strikes=1, probe=0.05), metrics=m)
    assert _ladder(pkg, [_oom(pkg)], resil, m)[0] == "host"
    assert m.breaker_state == "open"
    time.sleep(0.06)
    # the probe fails with a data error: no strike, the token released
    assert _ladder(pkg, [ValueError("bad draft")], resil, m)[0] == "host"
    assert m.breaker_state == "open"
    time.sleep(0.06)
    assert _ladder(pkg, [None], resil, m)[0] == "device"
    assert m.breaker_state == "closed"


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_deadline_expiry_replays_the_group(pkg):
    """A dispatch past its deadline is abandoned into the ``hang`` class:
    device_hangs, the degraded mark and a strike are booked, and the
    request is replayed, never dispatched again."""
    mod, _, metrics_cls, _ = PACKAGES[pkg]
    m = metrics_cls()
    resil = mod.Resilience(_cfg(deadline=0.2), metrics=m)
    bmod, out = PACKAGES[pkg][1], PACKAGES[pkg][3]
    results = [None]
    calls = []

    def dispatch(idxs, key):
        calls.append(key)
        time.sleep(3)
        return out()

    t0 = time.monotonic()
    bmod._run_groups_recovering({"g": [0]}, dispatch,
                                lambda *a: results.__setitem__(0, "device"),
                                lambda i: "host", results, m,
                                label=lambda k: "grp", resil=resil)
    assert time.monotonic() - t0 < 2.5
    assert results == ["host"] and calls == ["g"]
    assert m.device_hangs == 1 and m.degraded.startswith(
        "dispatch deadline expired")
    assert m.host_fallbacks == 1
    assert [s["kind"] for s in m.breaker_strike_log] == ["hang"]


def test_kernel_fault_ends_the_run_without_a_strike():
    """The port has no 'compile' class: with no Resilience wired (the
    executors' default) a device output is finished as before, and with
    one a kernel that cannot launch still ends the run
    (cuda_ext.KernelError), neither routed nor struck."""
    from ccsx_tpu_torch.ops import cuda_ext

    m = RunMetrics()
    assert _ladder("port", [None], None, m) == ("device", 1)
    resil = resilience.Resilience(_cfg(strikes=1), metrics=m)
    with pytest.raises(cuda_ext.KernelError):
        _ladder("port", [cuda_ext.KernelError("launch failed")], resil, m)
    assert m.breaker_state == "closed" and not m.breaker_strike_log


# ---- the CLI on the CPU, against the JAX CLI's bytes -----------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(input, the JAX CLI's --batch on output): tests/test_resilience.py's
    corpus."""
    tmp = tmp_path_factory.mktemp("resil")
    rng = np.random.default_rng(0)
    zs = [synth.make_zmw(rng, template_len=700, n_passes=5, movie="mv",
                         hole=str(100 + h)) for h in range(3)]
    fa = tmp / "in.fa"
    fa.write_text(synth.make_fasta(zs))
    ref = tmp / "ref.fa"
    assert jcli.main(["-A", "-m", "1000", "--batch", "on", "--device", "cpu",
                      "--prep-threads", "0", "--no-warmup",
                      str(fa), str(ref)]) == 0
    data = ref.read_bytes()
    assert data.count(b"/ccs\n") == 3
    return fa, data


def _final(path):
    events = [json.loads(line) for line in open(path) if line.strip()]
    assert events[-1]["event"] == "final"
    return events[-1]


def _join_abandoned(timeout=60.0):
    """Wait for every abandoned bounded call of this process to end, so
    that none wakes into a later test's refine programs."""
    for t in threading.enumerate():
        if t.name.startswith("ccsx-bounded-"):
            t.join(timeout)
            assert not t.is_alive(), t.name


def test_injected_permanent_hang_completes_byte_identical(corpus, tmp_path):
    """The wedged step (device_hang sleeps 60 s) is abandoned at the 2 s
    deadline and its group replays per request on the per-hole path: rc 0,
    the JAX CLI's bytes, degraded, in far less than the hang.  A CLI
    process of its own, which also shows that the parked daemon thread
    does not hold up the process's exit."""
    fa, ref = corpus
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT), CCSX_DEADLINE_GRACE="1",
               CCSX_FAULT_HANG_S="60", OMP_NUM_THREADS="2")
    env.pop("CCSX_FAULTS", None)
    t0 = time.monotonic()
    r = subprocess.run([sys.executable, "-m", "ccsx_tpu_torch.cli", *PORT,
                        "--dispatch-deadline", "2", "--inject-faults",
                        "device_hang@1", "--metrics", str(m), str(fa),
                        str(out)], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=55)
    assert r.returncode == 0, r.stderr
    assert time.monotonic() - t0 < 50
    assert out.read_bytes() == ref
    final = _final(m)
    assert final["device_hangs"] >= 1 and final["degraded"]
    assert final["host_fallbacks"] >= 1 and final["failed_steps"] >= 1
    assert final["holes_out"] == 3 and final["holes_failed"] == 0
    assert "dispatch deadline" in r.stderr and "per-hole path" in r.stderr


def test_deadline_off_moves_no_resilience_counter(corpus, tmp_path,
                                                  monkeypatch):
    """Deadlines off (the default): a transient stall sleeps and returns,
    the bytes are the JAX CLI's, and no resilience counter moves."""
    fa, ref = corpus
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    monkeypatch.setenv("CCSX_FAULT_STALL_S", "0.1")
    assert cli.main(PORT + ["--inject-faults", "stall@1", "--metrics",
                            str(m), str(fa), str(out)]) == 0
    assert out.read_bytes() == ref
    final = _final(m)
    assert final["device_hangs"] == 0 and final["breaker_trips"] == 0
    assert final["breaker_state"] == "closed"
    assert final["host_fallbacks"] == 0 and "degraded" not in final


def test_breaker_trip_completes_per_request(corpus, tmp_path, capsys):
    """Every device step OOMs: two ladder bottoms trip the breaker, which
    stays open (no probe), and the run ends with the JAX CLI's bytes."""
    fa, ref = corpus
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    assert cli.main(PORT + ["--breaker-strikes", "2", "--inject-faults",
                            "device_oom@1+", "--metrics", str(m), str(fa),
                            str(out)]) == 0
    assert out.read_bytes() == ref
    final = _final(m)
    assert final["breaker_trips"] >= 1 and final["breaker_state"] == "open"
    assert final["host_fallbacks"] >= 1
    assert len(final["breaker_strike_log"]) >= 2
    assert "CIRCUIT BREAKER OPEN" in capsys.readouterr().err


def test_hang_ending_inside_the_run_leaves_the_bytes(corpus, tmp_path,
                                                     monkeypatch):
    """The injected hang ends while the replay runs: the abandoned call
    wakes and dispatches its step (a slab counted, launches made), its
    result lands in a slot nobody reads, and the bytes do not move."""
    fa, ref = corpus
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    monkeypatch.setenv("CCSX_FAULT_HANG_S", "1.5")
    from ccsx_tpu_torch.pipeline import graphs

    graphs.reset_stats()
    assert cli.main(PORT + ["--dispatch-deadline", "0.5", "--inject-faults",
                            "device_hang@1", "--metrics", str(m), str(fa),
                            str(out)]) == 0
    assert out.read_bytes() == ref
    final = _final(m)
    assert final["device_hangs"] >= 1 and final["holes_out"] == 3
    # the woken call went on into the refine programs
    _join_abandoned()
    assert sum(v["eager"] + v["replays"]
               for v in graphs.stats().values()) >= 1
    assert out.read_bytes() == ref


@pytest.mark.parametrize("flag,value", [
    ("--dispatch-deadline", "-1"), ("--breaker-strikes", "-2"),
    ("--breaker-probe-s", "-0.5")])
def test_bad_flag_values_fail_as_the_jax_cli(flag, value, tmp_path, capsys):
    args = [flag, value, "x.fa", str(tmp_path / "y.fa")]
    assert cli.main(args) == 1
    port_err = capsys.readouterr().err
    assert jcli.main(args) == 1
    jax_err = capsys.readouterr().err
    assert port_err.splitlines()[0] == jax_err.splitlines()[0]
    assert port_err.startswith(f"Error: {flag} must be >= 0")


def test_usage_names_the_resilience_flags():
    for flag in ("--dispatch-deadline", "--breaker-strikes",
                 "--breaker-probe-s"):
        assert flag in cli.USAGE
