"""The port's fault-injection harness (ccsx_tpu_torch/utils/faultinject.py)
against the JAX package's, and the recoveries it drives in the port.

The JAX package's cases of the same names (tests/test_faults.py: the spec
and schedule, the env spec, the CLI's refusal, quarantine in both
drivers, the ingest fault, the OOM bisection and its per-request replay;
tests/test_resilience.py: a hang with deadlines off completes;
tests/test_trace.py: an injected stall fires the watchdog through the
CLI), run on the port's CLI with ``--device cpu``.  Bytes are compared
with the JAX package's: one module-scoped JAX CLI process on the CPU gives
the reference output and the number of times each fault point was
reached, which the port must reach as often on the same corpus and flags
(the points sit at the JAX package's places).  Bytes and counts are
integers: the tolerance is exact equality.
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccsx_tpu import cli as jcli
from ccsx_tpu import exitcodes as jexitcodes
from ccsx_tpu.utils import faultinject as jfault

from ccsx_tpu_torch import cli, exitcodes
from ccsx_tpu_torch.pipeline import batch
from ccsx_tpu_torch.utils import faultinject, synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["-A", "-m", "1000"]
# the port's inline prep: fault positions follow the driver's schedule
PORT = BASE + ["--device", "cpu", "--prep-threads", "0"]
# the JAX package's inline-prep batched path, which is the port's
JAX_INLINE = ["--prep-threads", "0", "--no-warmup"]

# runs the JAX CLI once per argv list (JSON in argv[1]) in one process,
# counting how often each fault point is reached; prints [[rc, counts]...]
JAX_RUNNER = """
import collections, json, sys
import jax
jax.config.update('jax_platforms', 'cpu')
from ccsx_tpu.cli import main
from ccsx_tpu.utils import faultinject
counts = collections.Counter()
real = faultinject.fire
def fire(point):
    counts[point] += 1
    return real(point)
faultinject.fire = fire
res = []
for argv in json.loads(sys.argv[1]):
    counts.clear()
    res.append([main(argv), dict(counts)])
print(json.dumps(res))
"""


def run_jax(argvs, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", CCSX_SKIP_PROBE="1",
               XLA_FLAGS="", PYTHONPATH=ROOT, **(env_extra or {}))
    r = subprocess.run([sys.executable, "-c", JAX_RUNNER, json.dumps(argvs)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def write_corpus(path, read_through=False):
    """3 holes of 500-bp templates, 5 passes; with ``read_through`` the
    last two carry an adapter read-through pass, so the strand walk
    aligns pairs (the local fill's span)."""
    rng = np.random.default_rng(0)
    zs = []
    for h in range(3):
        z = synth.make_zmw(rng, template_len=500, n_passes=5, movie="mv",
                           hole=str(100 + h))
        if read_through and h:
            z.passes.insert(2 + h, synth.read_through(rng, z.template))
            z.strands.insert(2 + h, 0)
        zs.append(z)
    path.write_text(synth.make_fasta(zs))


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.disarm()
    jfault.disarm()
    yield
    faultinject.disarm()
    jfault.disarm()


# the fault-point parity runs: (name, corpus with read-throughs, flags)
PARITY = {
    # pair_fill, seed_device and refine_packed spans; journal points
    "packed": (True, ["--batch", "on", "--seed-device-min-t", "64"]),
    # the bucketed refine span
    "bucketed": (False, ["--batch", "on", "--pass-buckets", "4,8,16,32"]),
    "per_hole": (False, ["--batch", "off"]),
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The corpora, the JAX package's output on the plain one (batched,
    journaled), and the JAX package's fault-point counts for each PARITY
    case, from one JAX CLI process."""
    d = tmp_path_factory.mktemp("faultinject")
    fa, rt = d / "in.fa", d / "rt.fa"
    write_corpus(fa)
    write_corpus(rt, read_through=True)
    argvs = [BASE + ["--batch", "on"] + JAX_INLINE
             + [str(fa), str(d / "ref.fa")]]
    for name, (read_through, flags) in PARITY.items():
        extra = JAX_INLINE if "on" in flags else []
        argvs.append(BASE + flags + extra + [
            "--journal", str(d / f"j_{name}.json"),
            str(rt if read_through else fa), str(d / f"jax_{name}.fa")])
    res = run_jax(argvs, {"CCSX_JOURNAL_FSYNC_S": "0"})
    assert [rc for rc, _ in res] == [0] * len(argvs)
    return {"dir": d, "fa": fa, "rt": rt,
            "bytes": (d / "ref.fa").read_bytes(),
            "fires": {name: counts for name, (_, counts)
                      in zip(PARITY, res[1:])}}


def _records(b: bytes) -> dict:
    """FASTA bytes -> {hole name: its record's bytes}, in order."""
    return {c.split("\n", 1)[0]: ">" + c for c in b.decode().split(">")[1:]}


def _final(path):
    events = [json.loads(line) for line in open(path) if line.strip()]
    assert events[-1]["event"] == "final"
    return events[-1]


# ---- the harness against the JAX package's ----------------------------------

SPECS = ["device_oom@2,write", "compute@3+", "frobnicate@1", "write@0",
         "write@x", "ingest", "", " , ", "stall@1,stall@2", "sigterm@10+",
         "disk_full@1+,input_corrupt@5", "journal@", "rank_death@-1",
         "compute@+", "write@2++", "device_hang@3 , ingest@1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equals_the_jax_package(spec):
    def parse(mod):
        try:
            return "ok", mod.parse_spec(spec)
        except ValueError as e:
            return "error", str(e)

    assert parse(faultinject) == parse(jfault)
    assert faultinject.POINTS == jfault.POINTS


def test_faultinject_spec_and_schedule():
    assert faultinject.parse_spec("device_oom@2,write") == {
        "device_oom": [2, False], "write": [1, False]}
    assert faultinject.parse_spec("compute@3+") == {"compute": [3, True]}
    with pytest.raises(ValueError, match="unknown fault point"):
        faultinject.parse_spec("frobnicate@1")
    with pytest.raises(ValueError, match=">= 1"):
        faultinject.parse_spec("write@0")
    with pytest.raises(ValueError, match="bad fault schedule"):
        faultinject.parse_spec("write@x")
    # once-schedule fires exactly on the Nth call
    faultinject.arm("compute@2")
    faultinject.fire("compute")  # call 1: no-op
    with pytest.raises(RuntimeError, match="injected compute fault"):
        faultinject.fire("compute")
    faultinject.fire("compute")  # call 3: past the schedule, no-op
    # repeat-schedule keeps firing; the port's device_oom is the type its
    # ladder classifies as an out-of-memory error
    faultinject.arm("device_oom@1+")
    for _ in range(3):
        with pytest.raises(torch.cuda.OutOfMemoryError,
                           match="out of memory") as ei:
            faultinject.fire("device_oom")
        assert batch.classify_failure(ei.value) == "oom"


def test_bad_env_spec_fails_attributed(monkeypatch):
    monkeypatch.setenv("CCSX_FAULTS", "wrte@2")
    faultinject._plan = faultinject._UNSET  # force re-init from env
    with pytest.raises(SystemExit, match="CCSX_FAULTS"):
        faultinject.fire("ingest")
    faultinject.fire("ingest")  # after the report: disarmed, no-op


def test_cli_rejects_bad_fault_spec(tmp_path, capsys):
    args = ["--inject-faults", "bogus@1", "x.fa", str(tmp_path / "y.fa")]
    assert cli.main(args) == 1
    port_err = capsys.readouterr().err
    assert jcli.main(args) == 1
    assert port_err == capsys.readouterr().err
    assert port_err.startswith("Error: --inject-faults: unknown fault point")


def test_exit_codes_equal_the_jax_package():
    names = ("RC_OK", "RC_FATAL", "RC_FAILED_HOLES", "RC_INTERRUPTED",
             "RC_INJECTED_KILL")
    assert exitcodes.__all__ == jexitcodes.__all__ == list(names)
    assert ([getattr(exitcodes, n) for n in names]
            == [getattr(jexitcodes, n) for n in names] == [0, 1, 2, 75, 57])
    assert exitcodes.RC_INJECTED_KILL == faultinject.EXIT_CODE


# ---- every point at the JAX package's place ---------------------------------


@pytest.mark.parametrize("name", list(PARITY))
def test_fault_points_reached_as_often_as_in_the_jax_package(
        name, ref, monkeypatch, tmp_path):
    """Counted without firing: the port reaches each point as often as the
    JAX package does on the same corpus and flags (six device spans,
    compute, ingest, the writer, the journal, the retirement points and
    the stream guard)."""
    read_through, flags = PARITY[name]
    counts = collections.Counter()
    monkeypatch.setattr(faultinject, "fire",
                        lambda point: counts.update([point]))
    monkeypatch.setenv("CCSX_JOURNAL_FSYNC_S", "0")
    out = tmp_path / "o.fa"
    assert cli.main(PORT + flags + [
        "--journal", str(tmp_path / "j.json"),
        str(ref["rt"] if read_through else ref["fa"]), str(out)]) == 0
    assert dict(counts) == ref["fires"][name]
    assert out.read_bytes() == (ref["dir"] / f"jax_{name}.fa").read_bytes()
    if name == "packed":
        assert counts["device_oom"] > counts["compute"]  # pair fills ran


# ---- quarantine -------------------------------------------------------------


@pytest.mark.parametrize("batch_arg", ["on", "off"])
def test_compute_fault_quarantines_one_hole(batch_arg, ref, tmp_path,
                                            capsys):
    out = tmp_path / "o.fa"
    faultinject.arm("compute@2")
    assert cli.main(PORT + ["--batch", batch_arg, str(ref["fa"]),
                            str(out)]) == 0
    assert "hole mv/101 failed: injected compute fault" in \
        capsys.readouterr().err
    want = _records(ref["bytes"])
    del want["mv/101/ccs"]
    assert out.read_bytes() == "".join(want.values()).encode()


def test_ingest_fault_clean_rc1(ref, tmp_path, capsys):
    rc = cli.main(PORT + ["--batch", "on", "--inject-faults", "ingest@1",
                          str(ref["fa"]), str(tmp_path / "o.fa")])
    err = capsys.readouterr().err
    assert rc == 1
    assert "invalid input stream" in err and "Traceback" not in err


# ---- the OOM ladder ---------------------------------------------------------


def test_injected_oom_resplit_output_identical(ref, tmp_path, capsys):
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    faultinject.arm("device_oom@1")
    assert cli.main(PORT + ["--batch", "on", "--inflight", "8",
                            "--metrics", str(m), str(ref["fa"]),
                            str(out)]) == 0
    assert out.read_bytes() == ref["bytes"]
    assert "resplitting" in capsys.readouterr().err
    final = _final(m)
    assert final["oom_resplits"] >= 1
    assert final["failed_steps"] == 0 and final["host_fallbacks"] == 0


def test_persistent_oom_replays_per_request(ref, tmp_path, capsys):
    """Every device step OOMing rides the ladder down to the per-request
    replay on the run's device, with the same bytes."""
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    faultinject.arm("device_oom@1+")
    assert cli.main(PORT + ["--batch", "on", "--metrics", str(m),
                            str(ref["fa"]), str(out)]) == 0
    assert out.read_bytes() == ref["bytes"]
    assert "replaying per request" in capsys.readouterr().err
    final = _final(m)
    assert final["host_fallbacks"] >= 1 and final["oom_resplits"] >= 1
    assert final["failed_steps"] >= 1
    assert final["holes_out"] == 3 and final["holes_failed"] == 0


# ---- hangs with no dispatch deadline ----------------------------------------


@pytest.mark.parametrize("point,env", [("stall", "CCSX_FAULT_STALL_S"),
                                       ("device_hang", "CCSX_FAULT_HANG_S")])
def test_hang_without_deadline_completes(point, env, ref, tmp_path,
                                         monkeypatch, capsys):
    """With deadlines off (--dispatch-deadline 0, the default), as in the
    JAX package, a stalled or hung step sleeps with its span open and then
    completes, with the same bytes and no resilience counter moved
    (tests/test_torch_resilience.py has the deadline's cases)."""
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    monkeypatch.setenv(env, "0.1")
    faultinject.arm(f"{point}@1")
    assert cli.main(PORT + ["--batch", "on", "--metrics", str(m),
                            str(ref["fa"]), str(out)]) == 0
    assert f"firing {point!r}" in capsys.readouterr().err
    assert out.read_bytes() == ref["bytes"]
    final = _final(m)
    assert final["device_hangs"] == 0 and final["breaker_trips"] == 0
    assert final["breaker_state"] == "closed"


def test_injected_stall_fires_watchdog_in_pipeline(ref, tmp_path,
                                                   monkeypatch, capsys):
    """The stall outlasts the first-of-shape grace (10 x 0.2 s): the
    watchdog dumps the stacks and the in-flight group and degrades, never
    kills, the run."""
    monkeypatch.setenv("CCSX_FAULT_STALL_S", "2.6")
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    rc = cli.main(PORT + ["--batch", "on", "--stall-timeout", "0.2",
                          "--inject-faults", "stall@1", "--metrics", str(m),
                          str(ref["fa"]), str(out)])
    assert rc == 0
    err = capsys.readouterr().err
    assert "STALL WATCHDOG" in err
    assert "packed:" in err
    assert "File \"" in err
    events = [json.loads(line) for line in open(m)]
    assert any(e["event"] == "stall" for e in events)
    fin = events[-1]
    assert fin["event"] == "final"
    assert fin["degraded"].startswith("stall watchdog")
    assert fin["holes_out"] == 3
    assert out.read_bytes() == ref["bytes"]
