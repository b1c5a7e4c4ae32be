"""The port's prep pool (ccsx_tpu_torch/pipeline/prep_pool.py, --prep-threads)
against the JAX package's.

The port twin of tests/test_prep_overlap.py: on one module-scoped corpus of
three holes under 1 kb (read-through passes, so the strand walk aligns pairs
through the pool's pair gate), the port's bytes under --prep-threads 0, 1, 3
and auto equal the JAX CLI's, and the traced pooled run shows the prep
spans on the pool's threads; a prep fault and a failed pair-gate replay
each quarantine one hole; a run killed under the pool resumes with
--journal to the same bytes; a resumed stretch longer than the ingest
budget does not stall the pool.  And
the port's own rule: a fault of the card or a kernel met on the pool's
threads ends the run, never a quarantined hole
(tests/test_torch_batch.py drives it through the CLI).  Bytes and counts:
exact equality.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from ccsx_tpu import cli as jcli
from ccsx_tpu.utils import synth as jsynth

from ccsx_tpu_torch import cli, exitcodes
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.ops import cuda_ext
from ccsx_tpu_torch.pipeline import batch, run
from ccsx_tpu_torch.pipeline.prep_pool import PrepPool, resolve_prep_threads
from ccsx_tpu_torch.utils import faultinject
from ccsx_tpu_torch.utils.run_metrics import RunMetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ["-A", "-m", "1000", "--batch", "on", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.disarm()
    yield
    faultinject.disarm()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(input FASTA, the JAX CLI's output): three holes of 450-bp
    templates, the first and the last with an adapter read-through pass."""
    d = tmp_path_factory.mktemp("prep_pool")
    rng = np.random.default_rng(7)
    zs = []
    for h in range(3):
        z = jsynth.make_zmw(rng, 450, 5 + (h % 3), movie="mv",
                            hole=str(100 + h))
        if h % 2 == 0:
            z.passes.insert(len(z.passes) // 2,
                            jsynth.read_through(rng, z.template))
            z.strands.insert(len(z.strands) // 2, 0)
        zs.append(z)
    fa = d / "in.fa"
    fa.write_text(jsynth.make_fasta(zs))
    ref = d / "ref.fa"
    assert jcli.main(["-A", "-m", "1000", "--batch", "on", "--device", "cpu",
                      str(fa), str(ref)]) == 0
    assert ref.read_bytes().count(b"/ccs\n") == 3
    return fa, ref.read_bytes()


def _records(b: bytes) -> list:
    return [">" + c for c in b.decode().split(">")[1:]]


def _run(fa, out, *extra):
    """The port's CLI; returns its final metrics event."""
    m = out.with_suffix(".jsonl")
    assert cli.main(PORT + [*extra, "--metrics", str(m), str(fa),
                            str(out)]) == 0
    events = [json.loads(line) for line in open(m)]
    assert events[-1]["event"] == "final"
    return events[-1]


@pytest.mark.parametrize("threads", ["0", "1", "3", "auto"])
def test_pool_settings_give_the_jax_bytes(threads, corpus, tmp_path):
    """Inline prep and every pool width give the JAX CLI's bytes; the
    inline run's prep reads unoverlapped (blocked == worked).  The run of
    three threads is traced: prep_hole spans on the pool's workers, pair
    sweeps and their local fills on the pair-gate pump, the refine steps
    on the driver thread."""
    fa, ref = corpus
    out, tr = tmp_path / "o.fa", tmp_path / "t.jsonl"
    m = _run(fa, out, *(["--prep-threads", threads]
                        if threads != "auto" else []),
             *(["--trace", str(tr)] if threads == "3" else []))
    assert out.read_bytes() == ref
    want = (resolve_prep_threads(CcsConfig()) if threads == "auto"
            else int(threads))
    assert m["prep_threads"] == want
    if want == 0:
        assert m["prep_queue_peak"] == 0
        assert m["prep_blocked_s"] == pytest.approx(m["prep_s"], rel=1e-2)
    else:
        assert m["prep_queue_peak"] >= 1 and m["prep_s"] > 0
    assert m["pair_alignments"] > 0 and m["holes_out"] == 3
    if threads == "3":
        spans = [json.loads(line) for line in open(tr)
                 if '"ev": "span"' in line]
        tids = {name: {s["tid"] for s in spans if s["name"] == name}
                for name in ("prep_hole", "pair_sweep", "pair_fill")}
        assert tids["prep_hole"] and all(
            t.startswith("ccsx-prep-") for t in tids["prep_hole"])
        assert tids["pair_sweep"] == tids["pair_fill"] == {"ccsx-prep-pairs"}
        dev = [s for s in spans if s["cat"] == "device"
               and s["name"] in ("refine_packed", "refine", "round")]
        assert dev and all(s["tid"] == "MainThread" for s in dev)


def test_resolve_prep_threads(monkeypatch):
    assert resolve_prep_threads(CcsConfig(prep_threads=0)) == 0
    assert resolve_prep_threads(CcsConfig(prep_threads=7)) == 7
    monkeypatch.setattr(os, "cpu_count", lambda: 16)
    assert resolve_prep_threads(CcsConfig()) == 4
    monkeypatch.setattr(os, "cpu_count", lambda: 3)
    assert resolve_prep_threads(CcsConfig()) == 1
    monkeypatch.setattr(os, "cpu_count", lambda: None)
    assert resolve_prep_threads(CcsConfig()) == 1


@pytest.mark.parametrize("batch_arg", ["off", "on"])
def test_prep_threads_note_with_batch_off(batch_arg, corpus, tmp_path,
                                          capsys):
    """The JAX package's note, printed by the per-hole driver only (every
    hole of this run is filtered: nothing to compute)."""
    fa, _ = corpus
    args = ["-A", "-m", "100000", "--device", "cpu", "--batch", batch_arg,
            "--prep-threads", "2", str(fa), str(tmp_path / "o.fa")]
    assert cli.main(args) == 0
    note = "--prep-threads has no effect with --batch off"
    assert (note in capsys.readouterr().err) == (batch_arg == "off")


def test_prep_fault_quarantines_one_hole(corpus, tmp_path):
    """An injected compute fault on a pool thread quarantines exactly that
    hole: the output is the reference less one record, in order.  (Which
    hole takes the second call depends on the threads' schedule.)"""
    fa, ref = corpus
    out = tmp_path / "o.fa"
    faultinject.arm("compute@2")
    m = _run(fa, out, "--prep-threads", "2")
    assert m["holes_failed"] == 1
    got, want = _records(out.read_bytes()), _records(ref)
    assert len(got) == len(want) - 1
    it = iter(want)
    assert all(any(r == w for w in it) for r in got)


def test_pair_gate_replay_failure_quarantines(corpus, tmp_path,
                                              monkeypatch):
    """A pair result that is an Exception (the executor's last-resort
    replay failed) quarantines the calling hole, not the run."""
    fa, ref = corpus
    calls = {"n": 0}
    orig = batch.PairExecutor.run

    def flaky(self, pairs):
        calls["n"] += 1
        if calls["n"] == 1:
            return [RuntimeError("injected pair replay failure")
                    for _ in pairs]
        return orig(self, pairs)

    monkeypatch.setattr(batch.PairExecutor, "run", flaky)
    out = tmp_path / "o.fa"
    m = _run(fa, out, "--prep-threads", "2")
    assert m["holes_failed"] >= 1
    assert len(_records(out.read_bytes())) == 3 - m["holes_failed"]


def test_device_fault_on_the_pump_ends_the_run(corpus):
    """A CUDA error escaping the pair executor on the pump thread is kept
    for the driver thread: its next get() raises it as a
    cuda_ext.KernelError, before any hole of that batch is handed over."""
    fa, _ = corpus
    cfg = CcsConfig(is_bam=False, min_subread_len=1000, device="cpu")

    class Faulty:
        def run(self, pairs):
            raise RuntimeError("CUDA error: an illegal memory access")

    stream = run.open_zmw_stream(str(fa), cfg)
    pool = PrepPool(stream, cfg, Faulty(), RunMetrics(), threads=2,
                    max_outstanding=8)
    got = []
    try:
        with pytest.raises(cuda_ext.KernelError, match="illegal memory"):
            for _ in range(200):
                h = pool.get(timeout=1.0)
                if h is not None:
                    got.append(h)
                elif pool.drained():
                    break
        # the holes handed over before the fault never waited on a pair
        assert all(h.err is None for h in got)
        with pytest.raises(cuda_ext.KernelError):
            pool.poll()
    finally:
        pool.close()


def test_kill_and_resume_with_prep_threads(corpus, tmp_path):
    """A hard kill at the second retirement with the pool on leaves a torn
    tail; the resume (pool still on) gives the JAX CLI's bytes."""
    fa, ref = corpus
    out, jp = tmp_path / "o.fa", tmp_path / "j.json"
    args = PORT + ["--prep-threads", "2", "--journal", str(jp), str(fa),
                   str(out)]
    runner = ("import sys; from ccsx_tpu_torch.cli import main; "
              "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, PYTHONPATH=ROOT, CCSX_FAULTS="write@2",
               CCSX_JOURNAL_FSYNC_S="0")
    r = subprocess.run([sys.executable, "-c", runner, *args], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == exitcodes.RC_INJECTED_KILL, r.stderr
    j = json.loads(jp.read_text())
    assert j["holes_done"] == 1
    assert os.path.getsize(out) > j["out_bytes"]     # the torn tail
    assert cli.main(args) == 0
    assert out.read_bytes() == ref
    assert json.loads(jp.read_text())["holes_done"] == 3


def test_resumed_stretch_does_not_stall_pool(tmp_path, monkeypatch):
    """A resume whose done stretch (six holes) is longer than the pool's
    ingest budget (4 x --inflight 1) must keep retiring resumed holes while
    the driver waits: the budget is released at emission.  Every hole of
    the first run fails at its first prep step (compute@1+), so nothing is
    computed and the journal still reaches the end."""
    rng = np.random.default_rng(5)
    fa = tmp_path / "in.fa"
    fa.write_text(jsynth.make_fasta([
        jsynth.make_zmw(rng, 300, 5, movie="mv", hole=str(h))
        for h in range(6)]))
    out, jp = tmp_path / "o.fa", tmp_path / "j.json"
    args = ["-A", "-m", "100", "--batch", "on", "--device", "cpu",
            "--prep-threads", "2", "--inflight", "1", "--journal", str(jp),
            str(fa), str(out)]
    monkeypatch.setenv("CCSX_JOURNAL_FSYNC_S", "0")
    faultinject.arm("compute@1+")
    assert cli.main(args) == 0
    faultinject.disarm()
    j = json.loads(jp.read_text())
    assert (j["holes_done"], j["holes_failed"]) == (6, 6)
    done = threading.Event()
    res = {}

    def again():
        res["rc"] = cli.main(args)
        done.set()

    t = threading.Thread(target=again, daemon=True)
    t.start()
    assert done.wait(60), "a resumed stretch stalled the prep pool"
    assert res["rc"] == 0 and out.read_bytes() == b""
    assert json.loads(jp.read_text())["holes_done"] == 6
