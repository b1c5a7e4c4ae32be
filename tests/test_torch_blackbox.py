"""The port's crash-persistent black-box recorder
(ccsx_tpu_torch/utils/blackbox.py) against the JAX package's.

The JAX package's black-box tests (tests/test_blackbox.py) of the same
names, run on the port's module: the ring read back without a close, a lap
dropping the torn oldest record, an exactly full ring, a foreign file and a
capacity change, in-flight pairing, the environment variable gating the
process ring, an unwritable directory disabling it loudly, the correlation
id stamping trace and ring records, and output bytes equal with the plane
on and off.  The ring format is the JAX package's: each package reads the
other's dumps to the same events.
"""

import json
import os

import numpy as np
import pytest

from ccsx_tpu.utils import blackbox as jblackbox
from ccsx_tpu.utils import synth as jsynth

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.utils import blackbox, trace


@pytest.fixture(autouse=True)
def _isolated_singleton(monkeypatch):
    """Each test starts with the plane off and a fresh process ring."""
    monkeypatch.delenv(blackbox.ENV_DIR, raising=False)
    blackbox.reset()
    yield
    blackbox.reset()


def test_ring_recovers_without_close(tmp_path):
    p = str(tmp_path / "bb.bin")
    box = blackbox.BlackBox(p, capacity=4096)
    for i in range(5):
        box.record({"i": i})
    events = blackbox.read_dump(p)          # no close, no flush
    assert [e["i"] for e in events] == list(range(5))
    assert jblackbox.read_dump(p) == events  # the JAX reader agrees
    box.close()


def test_restart_resumes_and_lap_drops_torn_oldest(tmp_path):
    p = str(tmp_path / "bb.bin")
    box = blackbox.BlackBox(p, capacity=4096)
    box.record({"n": 0})
    box.close()
    box = blackbox.BlackBox(p, capacity=4096)
    assert box.head > 0                     # resumed, not zeroed
    pad = "x" * 80
    for n in range(1, 200):                 # ~100 B a record: laps 4 KiB
        box.record({"n": n, "pad": pad})
    box.close()
    ns = [e["n"] for e in blackbox.read_dump(p)]
    assert ns and ns == list(range(ns[0], 200))
    assert 0 < ns[0] < 199
    assert [e["n"] for e in jblackbox.read_dump(p)] == ns


def test_read_dump_exactly_full_ring(tmp_path):
    p = str(tmp_path / "bb.bin")
    box = blackbox.BlackBox(p, capacity=4096)
    pad = "x" * (4096 - 11)        # {"pad":"..."}\n == capacity bytes
    box.record({"pad": pad})
    assert box.head == box.capacity
    events = blackbox.read_dump(p)
    assert len(events) == 1 and events[0]["pad"] == pad
    box.close()


def test_reader_rejects_foreign_and_capacity_change_resets(tmp_path):
    bad = tmp_path / "junk.bin"
    bad.write_bytes(b"not a ring")
    with pytest.raises(ValueError):
        blackbox.read_dump(str(bad))
    p = str(tmp_path / "bb.bin")
    box = blackbox.BlackBox(p, capacity=4096)
    box.record({"n": 1})
    box.close()
    box = blackbox.BlackBox(p, capacity=8192)
    assert box.head == 0
    box.close()


def test_inflight_pairing():
    events = [
        {"bb": "inflight", "what": "job", "id": "j1"},
        {"bb": "inflight", "what": "range", "id": 3},
        {"bb": "done", "what": "job", "id": "j1"},
        {"ev": "begin", "tid": "T", "name": "refine"},
        {"ev": "begin", "tid": "T", "name": "poa"},
        {"ev": "span", "tid": "T", "name": "poa"},
    ]
    live = blackbox.inflight(events)
    assert live == jblackbox.inflight(events)
    notes = {(e.get("what"), e.get("id")) for e in live if e.get("bb")}
    assert notes == {("range", 3)}
    assert [e["name"] for e in live if e.get("ev") == "begin"] == ["refine"]


def test_env_gates_singleton(tmp_path, monkeypatch):
    assert blackbox.get() is None
    blackbox.note("inflight", what="job", id="j9")     # no-op
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv(blackbox.ENV_DIR, str(tmp_path))
    bb = blackbox.get()
    assert bb is not None and blackbox.get() is bb     # cached per pid
    blackbox.note("inflight", what="job", id="j9")
    blackbox.reset()
    events = blackbox.read_dump(blackbox.box_path(str(tmp_path)))
    last = events[-1]
    assert (last["bb"], last["what"], last["id"]) == ("inflight", "job", "j9")
    assert last["pid"] == os.getpid() and last["ts"] > 0


def test_unwritable_dir_disables_loudly(tmp_path, monkeypatch, capsys):
    f = tmp_path / "not_a_dir"
    f.write_text("x")
    monkeypatch.setenv(blackbox.ENV_DIR, str(f))
    assert blackbox.get() is None
    assert blackbox.ENV_DIR not in os.environ
    assert "[ccsx-tpu-torch] blackbox disabled" in capsys.readouterr().err


def test_cid_scope_stamps_trace_records_and_ring_mirror(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv(blackbox.ENV_DIR, str(tmp_path))
    tp = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(tp)
    assert trace.current_cid() is None
    with trace.cid_scope("cabc123def456"):
        with tr.span("stitch"):
            pass
        with tr.device_span("refine_packed", group="packed:q9"):
            pass
        tr.instant("mark")
    with tr.span("outside"):
        pass
    tr.close()
    recs = [json.loads(ln) for ln in open(tp) if ln.strip()]
    by = {r["name"]: r for r in recs if "name" in r}
    for name in ("stitch", "refine_packed", "mark"):
        assert by[name]["cid"] == "cabc123def456", name
    assert "cid" not in by["outside"]
    blackbox.reset()
    ring = blackbox.read_dump(blackbox.box_path(str(tmp_path)))
    assert any(r.get("ev") == "span" and r.get("name") == "stitch"
               and r.get("cid") == "cabc123def456" for r in ring)
    assert any(r.get("ev") == "begin" and r.get("name") == "refine_packed"
               and r.get("cid") == "cabc123def456" for r in ring)
    assert not blackbox.inflight(ring)


def test_output_bytes_identical_plane_on_off(tmp_path, monkeypatch, capsys):
    """Observability, not semantics: a CLI run with the ring armed writes
    the bytes of one without; the ring holds the run's spans, nothing is
    in flight after the clean exit, and the ``blackbox`` subcommand renders
    it."""
    rng = np.random.default_rng(0)
    zs = [jsynth.make_zmw(rng, template_len=700, n_passes=5, movie="mv",
                          hole=str(h)) for h in range(2)]
    fa = tmp_path / "in.fa"
    fa.write_text(jsynth.make_fasta(zs))
    outs = {}
    for plane in ("off", "on"):
        if plane == "on":
            monkeypatch.setenv(blackbox.ENV_DIR, str(tmp_path / "bb"))
        outs[plane] = str(tmp_path / f"{plane}.fa")
        assert cli.main(["-A", "-m", "1000", "--device", "cpu", "--batch",
                         "on", str(fa), outs[plane]]) == 0
    blackbox.reset()
    assert open(outs["on"], "rb").read() == open(outs["off"], "rb").read()
    events = blackbox.read_dump(blackbox.box_path(str(tmp_path / "bb")))
    names = {e.get("name") for e in events if e.get("ev") == "span"}
    assert {"ingest_hole", "refine_packed", "write_record"} <= names
    assert not blackbox.inflight(events)
    capsys.readouterr()
    assert cli.main(["blackbox", str(tmp_path / "bb"), "--tail", "2"]) == 0
    assert "-- nothing in flight --" in capsys.readouterr().out
    assert cli.main(["blackbox", str(tmp_path / "none")]) == 1
