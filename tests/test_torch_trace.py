"""The port's flight recorder (ccsx_tpu_torch/utils/trace.py) against the
JAX package's.

The JAX package's recorder tests (tests/test_trace.py) of the same names,
run on the port's module: span nesting and self time, JSONL lines under
threads, first-of-shape attribution, failed and materialize spans, the
Chrome export, the stall watchdog, an unwritable --trace path and an
unforced group table.  Then what is the port's own: ``Span.force`` is the
identity unless a trace file is open and a CUDA tensor is in its output;
the three copied modules (trace, metrics, blackbox) differ from the JAX
package's only in ``Span.force``, the tracer's recording into the
in-memory captures (``Tracer.__init__``, ``Tracer.span``,
``Tracer.device_span``), ``resource_gauges`` and text (an AST comparison
with docstrings and the package prefix normalized away); and
``stats_main``'s output, ``summarize``'s dict and ``export_chrome``'s JSON
equal the JAX package's on the same files.  Exact equality throughout,
apart from the wall-clock bounds the JAX tests themselves use.
"""

import ast
import collections
import io
import json
import pathlib
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from ccsx_tpu import cli as jcli
from ccsx_tpu.utils import synth as jsynth
from ccsx_tpu.utils import trace as jtrace

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.pipeline import batch
from ccsx_tpu_torch.utils import capture, synth, trace
from ccsx_tpu_torch.utils.metrics import Metrics
from ccsx_tpu_torch.utils.run_metrics import RunMetrics

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _read_jsonl(path):
    return [json.loads(line) for line in open(path) if line.strip()]


# ---- the JAX package's recorder tests, on the port's module ---------------


def test_span_nesting_and_record_fields(tmp_path):
    p = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(p)
    with tr.span("outer", cat="compute", n=2):
        with tr.span("inner", cat="prep"):
            time.sleep(0.01)
    tr.close()
    recs = _read_jsonl(p)
    assert recs[0]["ev"] == "meta"
    spans = {r["name"]: r for r in recs if r["ev"] == "span"}
    outer, inner = spans["outer"], spans["inner"]
    assert recs[1]["name"] == "inner"          # close-ordered
    assert inner["mono"] >= outer["mono"]
    assert inner["mono"] + inner["dur"] <= outer["mono"] + outer["dur"] + 1e-6
    assert inner["dur"] >= 0.01
    assert outer["args"] == {"n": 2}
    assert abs(outer["ts"] - time.time()) < 60


def test_thread_safety_every_line_valid(tmp_path):
    p = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(p)

    def work(i):
        for j in range(100):
            with tr.span(f"w{i}", cat="compute", j=j):
                pass

    threads = [threading.Thread(target=work, args=(i,), name=f"wk{i}")
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    tr.close()
    spans = [r for r in _read_jsonl(p) if r["ev"] == "span"]
    assert len(spans) == 800
    for i in range(8):
        mine = [r for r in spans if r["name"] == f"w{i}"]
        assert len(mine) == 100
        assert all(r["tid"] == f"wk{i}" for r in mine)


def test_device_span_attribution_first_call_is_compile(tmp_path):
    m = Metrics()
    tr = trace.Tracer(str(tmp_path / "t.jsonl"), metrics=m)
    for _ in range(3):
        with tr.device_span("refine", group="g:q1:t1:i1", cells=100) as sp:
            assert sp.force("x") == "x"
            time.sleep(0.002)
    tr.close()
    st = m.snapshot()["groups"]["g:q1:t1:i1"]
    assert (st["compiles"], st["dispatches"], st["dp_cells"]) == (1, 3, 300)
    assert st["compile_s"] > 0 and st["execute_s"] > 0
    raw = m.group_stats["g:q1:t1:i1"]
    assert st["dp_cells_per_sec"] == round(200 / raw["execute_s"])
    recs = _read_jsonl(str(tmp_path / "t.jsonl"))
    assert len([r for r in recs if r["ev"] == "span" and r.get("compile")]) \
        == 1


def test_device_span_recompile_per_shape(tmp_path):
    m = Metrics()
    tr = trace.Tracer(str(tmp_path / "t.jsonl"), metrics=m)
    for shape in ("Z4", "Z8", "Z4"):
        with tr.device_span("round", group="round:P8:q1:t1", shape=shape,
                            cells=10):
            pass
    tr.close()
    st = m.snapshot()["groups"]["round:P8:q1:t1"]
    assert (st["compiles"], st["dispatches"]) == (2, 3)
    recs = _read_jsonl(str(tmp_path / "t.jsonl"))
    assert [r["compile"] for r in recs if r["ev"] == "span"] == \
        [True, True, False]


def test_failed_dispatch_not_attributed(tmp_path):
    m = Metrics()
    tr = trace.Tracer(str(tmp_path / "t.jsonl"), metrics=m)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with tr.device_span("refine", group="g", cells=100):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
    with tr.device_span("refine", group="g", cells=50):
        pass
    tr.close()
    st = m.snapshot()["groups"]["g"]
    assert (st["dispatches"], st["dp_cells"], st["compiles"]) == (1, 50, 1)
    recs = [r for r in _read_jsonl(str(tmp_path / "t.jsonl"))
            if r["ev"] == "span"]
    assert recs[0]["args"]["error"] is True and "compile" not in recs[0]


def test_materialize_span_watched_but_not_attributed(tmp_path, capsys):
    m = Metrics()
    p = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(p, stall_timeout=0.15, metrics=m)
    with tr.device_span("materialize", group="(8, 1536)", attribute=False):
        pass          # the first-of-shape grace
    with tr.device_span("materialize", group="(8, 1536)", attribute=False):
        time.sleep(0.5)
    with tr.device_span("refine", group="g", cells=10):
        pass
    tr.close()
    err = capsys.readouterr().err
    assert "[ccsx-tpu-torch] STALL WATCHDOG" in err and "(8, 1536)" in err
    assert m.degraded
    assert set(m.group_stats) == {"g"}
    d = trace.summarize([p])
    assert set(d["groups"]) == {"g"}
    assert "(8, 1536)" in {s["group"] for s in d["slowest"]}


def test_span_eof_stopiteration_not_an_error(tmp_path):
    p = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(p)
    with pytest.raises(StopIteration):
        with tr.span("ingest_hole", cat="ingest"):
            next(iter(()))
    tr.close()
    spans = [r for r in _read_jsonl(p) if r["ev"] == "span"]
    assert len(spans) == 1 and "error" not in spans[0].get("args", {})


def test_nested_span_self_time_disjoint(tmp_path):
    p = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(p)
    with tr.span("refine_sweep", cat="compute"):
        with tr.device_span("refine", group="g"):
            time.sleep(0.05)
    tr.close()
    recs = {r["name"]: r for r in _read_jsonl(p) if r["ev"] == "span"}
    outer, dev = recs["refine_sweep"], recs["refine"]
    assert "self" not in dev
    assert outer["self"] <= outer["dur"] - dev["dur"] + 2e-6
    d = trace.summarize([p])
    assert d["stage_seconds"]["device"] >= 0.05
    assert d["stage_seconds"]["compute"] < 0.05


def test_chrome_export_is_loadable(tmp_path):
    p = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(p)
    with tr.span("host_work", cat="prep"):
        pass
    with tr.device_span("refine", group="g", cells=10):
        pass
    tr.instant("recover", cat="recover", kind="oom")
    tr.close()
    cp = trace.chrome_path(p)
    assert cp.endswith(".chrome.json")
    events = json.load(open(cp))["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    assert len(xs) == 2
    for e in xs:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert e["cat"] in trace.CATEGORIES and "tid" in e
    assert any(e.get("ph") == "i" for e in events)
    assert any(e.get("ph") == "M" and e.get("name") == "thread_name"
               for e in events)


def test_watchdog_fires_while_span_open(tmp_path, capsys):
    buf = io.StringIO()
    m = Metrics(stream=buf)
    p = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(p, stall_timeout=0.15, metrics=m)
    with tr.device_span("refine_packed", group="packed:q9:t9:i9",
                        plan={"rows": 8, "holes": 2}):
        pass
    with tr.device_span("refine_packed", group="packed:q9:t9:i9",
                        plan={"rows": 8, "holes": 2}):
        time.sleep(1.0)
    tr.close()
    err = capsys.readouterr().err
    assert "STALL WATCHDOG" in err and "packed:q9:t9:i9" in err
    assert "File \"" in err and "\"rows\": 8" in err
    assert m.degraded and m.degraded.startswith("stall watchdog")
    assert m.stalls == 1
    stalls = [r for r in _read_jsonl(p) if r["ev"] == "stall"]
    assert len(stalls) == 1
    assert 0.15 <= stalls[0]["open_s"] < 1.0
    assert any("sleep" in s for s in stalls[0]["stacks"].values())
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [e["event"] for e in events if e["event"] == "stall"] == ["stall"]


def test_watchdog_quiet_on_healthy_spans(capsys):
    m = Metrics()
    tr = trace.Tracer(None, stall_timeout=60.0, metrics=m)
    with tr.device_span("refine", group="g"):
        pass
    tr.close()
    assert "STALL" not in capsys.readouterr().err
    assert m.degraded is None
    assert m.group_stats["g"]["dispatches"] == 1


def test_watchdog_compile_grace_first_of_shape(tmp_path, capsys):
    m = Metrics()
    tr = trace.Tracer(str(tmp_path / "t.jsonl"), stall_timeout=0.15,
                      metrics=m)
    with tr.device_span("round", group="g", shape="Z4"):
        time.sleep(0.5)    # > timeout, < timeout * COMPILE_GRACE
    assert "STALL" not in capsys.readouterr().err
    with tr.device_span("round", group="g", shape="Z8"):
        time.sleep(0.5)    # a new shape: the grace again
    assert "STALL" not in capsys.readouterr().err
    with tr.device_span("round", group="g", shape="Z4"):
        time.sleep(0.5)    # steady state: the bare timeout fires
    tr.close()
    assert "STALL WATCHDOG" in capsys.readouterr().err
    assert m.degraded and m.degraded.startswith("stall watchdog")
    assert "compile grace" not in m.degraded


def test_retry_path_materialize_span_stable_group(tmp_path):
    """The port's retry path (_run_group_sync) reads a step's output back
    inside a watchdog-visible materialize span under the dispatch's group
    label (no slab ordinal) and the output's shape tag."""
    assert batch._out_shape_tag(torch.zeros((4, 2))) == "4x2"
    p = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(p)
    trace.install(tr)
    got = []
    try:
        batch._run_group_sync(
            [0], (1, 2, 3, 7), lambda idxs, key: torch.zeros((4, 2)),
            lambda idxs, key, out: got.append(out), lambda i: None, [None],
            RunMetrics(), 0, 3, 0.0,
            label=lambda k: f"packed:q{k[0]}:t{k[1]}")
    finally:
        trace.uninstall()
        tr.close()
    assert isinstance(got[0], np.ndarray) and got[0].shape == (4, 2)
    mats = [r for r in _read_jsonl(p) if r.get("ev") == "span"
            and r["name"] == "materialize"]
    assert len(mats) == 1
    assert mats[0]["args"]["group"] == "packed:q1:t2"
    assert mats[0]["args"]["shape"] == "4x2"
    assert "compile" not in mats[0]


def test_unwritable_trace_path_polite_rc1(tmp_path, capsys):
    """Refused with rc 1 and no traceback, as by the JAX CLI on the same
    input; nothing is left installed and the output is closed."""
    rng = np.random.default_rng(0)
    zs = [jsynth.make_zmw(rng, template_len=700, n_passes=5, movie="mv",
                          hole=str(h)) for h in range(2)]
    fa = tmp_path / "in.fa"
    fa.write_text(jsynth.make_fasta(zs))
    bad = str(tmp_path / "no-such-dir" / "t.jsonl")
    want = jcli.main(["-A", "-m", "1000", "--batch", "on", "--device", "cpu",
                      "--prep-threads", "0", "--no-warmup", "--trace", bad,
                      str(fa), str(tmp_path / "j.fa")])
    assert "Cannot open trace file" in capsys.readouterr().err
    for arm in ("on", "off"):
        rc = cli.main(["-A", "-m", "1000", "--batch", arm, "--device", "cpu",
                       "--trace", bad, str(fa), str(tmp_path / "o.fa")])
        assert rc == want == 1
        assert "Cannot open trace file for write!" in \
            capsys.readouterr().err
        assert trace.current() is None


def test_unforced_group_table_flagged(tmp_path):
    m = Metrics()
    tr = trace.Tracer(None, stall_timeout=0, metrics=m)
    with tr.device_span("refine", group="g", cells=10):
        pass
    tr.close()
    snap = m.snapshot()
    assert snap["groups_forced"] is False
    mp = tmp_path / "m.jsonl"
    mp.write_text(json.dumps({"event": "final", **snap}) + "\n")
    d = trace.summarize([str(mp)])
    assert d["groups_forced"] is False
    assert "UNFORCED" in trace.format_summary(d)
    m2 = Metrics()
    tr2 = trace.Tracer(str(tmp_path / "t.jsonl"), metrics=m2)
    with tr2.device_span("refine", group="g", cells=10):
        pass
    tr2.close()
    assert m2.snapshot()["groups_forced"] is True


# ---- Span.force -------------------------------------------------------------


class _FakeCuda(torch.Tensor):
    """A CPU tensor that says it lives on the card: what force looks for."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def _syncs(monkeypatch):
    """Record every stream synchronisation force asks for."""
    calls = []

    class _Stream:
        def __init__(self, dev):
            self.dev = dev

        def synchronize(self):
            calls.append(self.dev)

    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    return calls


def test_force_is_identity_when_nothing_forces(tmp_path, monkeypatch):
    """No synchronisation and the same object back: with no tracer
    installed, with a watchdog-only tracer (path=None), and under a trace
    file when the output holds no CUDA tensor."""
    calls = _syncs(monkeypatch)
    fake = torch.Tensor._make_subclass(_FakeCuda, torch.zeros(3))
    cpu = torch.arange(4)
    out = {"a": np.zeros(2), "b": (cpu, [fake])}
    assert trace.current() is None
    with trace.device_span("refine", group="g") as sp:
        assert sp.force(out) is out
    tr = trace.Tracer(None, stall_timeout=0)
    assert not tr.forced
    with tr.device_span("refine", group="g") as sp:
        assert sp.force(out) is out and sp.force(fake) is fake
    tr.close()
    tr = trace.Tracer(str(tmp_path / "t.jsonl"))
    assert tr.forced
    with tr.device_span("refine", group="g") as sp:
        for x in (cpu, (cpu, np.ones(2)), {"k": [cpu]}, "x", None):
            assert sp.force(x) is x
    tr.close()
    assert calls == []


def test_force_syncs_the_first_cuda_tensor_under_a_trace(tmp_path,
                                                         monkeypatch):
    calls = _syncs(monkeypatch)
    fake = torch.Tensor._make_subclass(_FakeCuda, torch.zeros(3))
    out = {"a": np.zeros(2), "b": (torch.arange(4), [fake, fake])}
    tr = trace.Tracer(str(tmp_path / "t.jsonl"))
    with tr.device_span("refine", group="g") as sp:
        assert sp.force(out) is out
    tr.close()
    assert calls == [torch.device("cuda", 0)]


# ---- the copies against the JAX package's modules -------------------------


def _is_branch(stmt, value):
    """``if <name> == <value>:`` (a dispatch branch on a constant)."""
    return (isinstance(stmt, ast.If) and isinstance(stmt.test, ast.Compare)
            and len(stmt.test.comparators) == 1
            and isinstance(stmt.test.comparators[0], ast.Constant)
            and stmt.test.comparators[0].value == value)


def _normalized(path, allowed):
    """The module's AST with docstrings dropped, the package prefix of
    strings and imports mapped to the JAX package's, the bodies of the
    ``allowed`` functions ('Class.method' or 'function') emptied, and the
    ``if x == VALUE:`` branch of an allowed 'function#VALUE' removed."""
    tree = ast.parse(path.read_text())

    class Norm(ast.NodeTransformer):
        def visit_Constant(self, n):
            if isinstance(n.value, str):
                n.value = (n.value.replace("ccsx-tpu-torch", "ccsx-tpu")
                           .replace("ccsx_tpu_torch", "ccsx_tpu"))
            return n

        def visit_ImportFrom(self, n):
            if n.module:
                n.module = n.module.replace("ccsx_tpu_torch", "ccsx_tpu")
            return n

    tree = Norm().visit(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    emptied = set()
    for node in tree.body:
        defs = ([(node.name, node)] if isinstance(node, ast.FunctionDef)
                else [(f"{node.name}.{d.name}", d) for d in node.body
                      if isinstance(d, ast.FunctionDef)]
                if isinstance(node, ast.ClassDef) else [])
        for name, d in defs:
            if name in allowed:
                d.body = [ast.Pass()]
                emptied.add(name)
            for a in allowed:
                fn, _, value = a.partition("#")
                if value and fn == name:
                    keep = [b for b in d.body if not _is_branch(b, value)]
                    if len(keep) == len(d.body) - 1:
                        emptied.add(a)
                    d.body = keep
    assert emptied == set(allowed), (path, emptied)
    return ast.dump(tree)


@pytest.mark.parametrize("mod,allowed", [
    # the port's tracer also records into the open in-memory captures
    # (utils/capture.py), the port's own
    ("utils/trace.py", ("Span.force", "Tracer.__init__", "Tracer.span",
                        "Tracer.device_span")),
    ("utils/metrics.py", ("resource_gauges",)),
    ("utils/blackbox.py", ()),
    # the port's device_oom raises the type its ladder classifies
    ("utils/faultinject.py", ("fire#device_oom",)),
    # the port's kernels are CUDA sources, hashed with the modules
    ("utils/fingerprint.py", ("code_fingerprint",)),
    ("utils/journal.py", ()),
    ("utils/drain.py", ()),
])
def test_copies_differ_from_jax_only_where_allowed(mod, allowed):
    port = _normalized(ROOT / "ccsx_tpu_torch" / mod, allowed)
    ref = _normalized(ROOT / "ccsx_tpu" / mod, allowed)
    assert port == ref


# ---- stats, summarize and the Chrome export against the JAX package -------


def _artifacts(d):
    """A trace and a metrics JSONL with every record kind the readers
    know: meta, nested spans with self time, device spans booked as compile
    and execute, a warmup span, a materialize and a failed span, instants,
    a stall, progress and final events with groups, occupancy and
    resilience keys."""
    t = d / "t.jsonl"
    recs = [{"ev": "meta", "pid": 4242, "ts": 1700000000.0,
             "stall_timeout_s": 120.0}]
    mono = 0.0
    for i in range(14):
        group = f"packed:q{1024 * (1 + i % 3)}:t2048:i2:bscan"
        recs.append({"ev": "span", "name": "refine_packed", "cat": "device",
                     "ts": 1700000000.0 + mono, "mono": mono,
                     "dur": 0.01 * (1 + i % 5), "tid": "MainThread",
                     "compile": i < 3,
                     "args": {"group": group, "cells": 1000 * (i + 1),
                              "shape": f"R128:S{32 >> (i % 2)}",
                              "plan": {"slab": i, "rows": 128,
                                       "holes": 3}}})
        recs.append({"ev": "span", "name": "materialize", "cat": "device",
                     "ts": 1700000000.0 + mono, "mono": mono + 0.02,
                     "dur": 0.001, "tid": "MainThread",
                     "args": {"group": group, "shape": "4x9", "n": 3}})
        mono += 0.05
    recs += [
        {"ev": "span", "name": "warmup", "cat": "device", "ts": 1.0,
         "mono": 0.001, "dur": 0.5, "tid": "warm", "compile": True,
         "warmup": True, "args": {"group": "pair:q512:t512"}},
        {"ev": "span", "name": "pair_fill", "cat": "device", "ts": 2.0,
         "mono": 0.7, "dur": 0.003, "tid": "MainThread", "compile": False,
         "args": {"group": "pair:q512:t512", "cells": 65536,
                  "shape": "N4"}},
        {"ev": "span", "name": "refine_packed", "cat": "device", "ts": 3.0,
         "mono": 0.8, "dur": 0.2, "tid": "MainThread",
         "args": {"group": "packed:q1024:t2048:i2:bscan", "error": True}},
        {"ev": "span", "name": "refine_sweep", "cat": "compute", "ts": 4.0,
         "mono": 0.0, "dur": 0.9, "self": 0.05, "tid": "MainThread",
         "args": {"n": 7}},
        {"ev": "span", "name": "ingest_hole", "cat": "ingest", "ts": 4.0,
         "mono": 0.9, "dur": 0.0004, "tid": "MainThread"},
        {"ev": "span", "name": "write_record", "cat": "write", "ts": 4.0,
         "mono": 0.95, "dur": 0.00002, "tid": "MainThread"},
        {"ev": "instant", "name": "recover", "cat": "recover", "ts": 5.0,
         "mono": 0.85, "tid": "MainThread",
         "args": {"kind": "oom", "group": "packed:q1024", "n": 3,
                  "depth": 0}},
        {"ev": "instant", "name": "zmw_filtered", "cat": "ingest",
         "ts": 5.0, "mono": 0.01, "tid": "MainThread"},
        {"ev": "stall", "name": "refine_packed", "group": "packed:q1024",
         "open_s": 130.5, "ts": 6.0, "mono": 1.0, "tid": "MainThread",
         "args": {"group": "packed:q1024"}, "stacks": {"MainThread(1)": "x"}},
    ]
    t.write_text("".join(json.dumps(r) + "\n" for r in recs)
                 + "not json\n\n")
    m = d / "m.jsonl"
    groups = {"packed:q1024:t2048:i2:bscan": {
        "compiles": 2, "compile_s": 0.5, "execute_s": 1.25,
        "dispatches": 9, "dp_cells": 123456, "dp_cells_per_sec": 98765}}
    final = {"event": "final", "ts": 7.0, "holes_out": 64,
             "holes_failed": 1, "stalls": 1, "device_dispatches": 75,
             "dp_occupancy": 0.51, "dp_row_fill": 0.8, "prep_share": 0.2,
             "zmws_per_sec": 120.5, "elapsed_s": 0.53, "host_fallbacks": 2,
             "breaker_state": "closed", "breaker_trips": 0,
             "oom_resplits": 1, "groups": groups, "groups_forced": True,
             "breaker_strike_log": [{"kind": "oom", "group": "g",
                                     "ts": 6.5}],
             "degraded": "stall watchdog fired: dispatch refine_packed"}
    m.write_text(json.dumps({"event": "progress", "ts": 6.0, "holes_out": 3,
                             "groups": groups}) + "\n"
                 + json.dumps(final) + "\n")
    return t, m


@pytest.mark.parametrize("argv", [[], ["--top", "3"]])
def test_stats_output_equals_the_jax_package(tmp_path, capsys, argv):
    t, m = _artifacts(tmp_path)
    outs = {}
    for name, main in (("jax", jtrace.stats_main),
                       ("port", trace.stats_main)):
        js = tmp_path / f"{name}.json"
        assert main([str(t), str(m), *argv, "--json", str(js)]) == 0
        outs[name] = (capsys.readouterr().out, js.read_bytes())
    assert outs["port"] == outs["jax"]
    assert "shape groups:" in outs["port"][0]
    assert "resilience recap:" in outs["port"][0]
    for main in (jtrace.stats_main, trace.stats_main):
        assert main([str(tmp_path / "missing.jsonl")]) == 1
    assert capsys.readouterr().err.count("Error: stats:") == 2


def test_summarize_and_chrome_export_equal_the_jax_package(tmp_path):
    t, m = _artifacts(tmp_path)
    for paths in ([t], [m], [t, m], [m, t]):
        paths = [str(p) for p in paths]
        assert trace.summarize(paths, top=4) == jtrace.summarize(paths,
                                                                 top=4)
    chrome = {}
    for name, mod in (("jax", jtrace), ("port", trace)):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(t, d / "t.jsonl")
        chrome[name] = pathlib.Path(
            mod.export_chrome(str(d / "t.jsonl"))).read_bytes()
    assert chrome["port"] == chrome["jax"]
    events = json.loads(chrome["port"])["traceEvents"]
    assert {e["ph"] for e in events} == {"M", "X", "i"}


def test_profile_flag_writes_a_chrome_trace(tmp_path, monkeypatch):
    """--profile DIR runs the run under torch.profiler (the counterpart of
    the JAX package's jax.profiler.trace) and leaves its Chrome trace in
    DIR; the run's rc passes through."""
    from ccsx_tpu_torch.pipeline import run

    def tiny_run(*a, **k):
        torch.ones(8).add_(1)
        return 0

    monkeypatch.setattr(run, "run_pipeline", tiny_run)
    pdir = tmp_path / "prof"
    assert cli.main(["--device", "cpu", "--profile", str(pdir), "in.fa",
                     str(tmp_path / "o.fa")]) == 0
    files = list(pdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("add_" in e.get("name", "") for e in events)


# ---- the in-memory capture (utils/capture.py) -----------------------------

# the batched driver thread's spans (pipeline/batch.py's "Recording")
DRIVER_SPANS = ("admit", "emit", "refine_sweep", "plan", "slab_pack",
                "refine_packed", "materialize", "unpack", "hole_step")
# driver spans that lie inside one refine_sweep
SWEEP_CHILDREN = ("plan", "slab_pack", "refine_packed", "materialize",
                  "unpack", "hole_step")


class _Clock:
    """A fake ``time``: perf_counter steps 1 s a read, thread_time 0.25 s."""

    def __init__(self):
        self.t, self.cpu = 100.0, 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t

    def thread_time(self):
        self.cpu += 0.25
        return self.cpu

    def time(self):
        return 1.7e9


def test_capture_records_bounds_self_and_cpu_on_the_clock(monkeypatch):
    """Each span's perf_counter bounds and self seconds (its own minus
    its children's), device spans included, and a plain span's thread-CPU
    seconds on the capture's own thread, with no trace file; close order;
    the capture's own bounds."""
    tr = trace.Tracer(None, stall_timeout=0)
    clock = _Clock()
    monkeypatch.setattr(trace, "time", clock)
    monkeypatch.setattr(capture, "time", clock)
    with capture.Capture() as cap:                       # start 101
        with tr.span("sweep", cat="compute", n=2):       # 102 .. 107
            with tr.device_span("refine_packed", group="g"):   # 103 .. 104
                pass
            with tr.span("unpack", cat="compute"):       # 105 .. 106
                pass
    me = threading.get_ident()
    assert cap.thread == me and (cap.start, cap.end) == (101.0, 108.0)
    assert cap.records == [
        ("refine_packed", "device", me, 103.0, 104.0, 1.0, None),
        ("unpack", "compute", me, 105.0, 106.0, 1.0, 0.25),
        ("sweep", "compute", me, 102.0, 107.0, 3.0, 0.75),
    ]
    assert cap.records[2].self_s == 3.0 and cap.records[2].cpu_s == 0.75
    tr.close()


def test_no_record_without_a_capture(monkeypatch):
    """With no capture open, no trace file and no blackbox, a plain span
    is the null span and keeps nothing; a capture opened later holds only
    what follows."""
    tr = trace.Tracer(None, stall_timeout=0)
    assert capture.ACTIVE == []
    kept = []
    monkeypatch.setattr(capture, "keep", lambda *a: kept.append(a))
    with tr.span("admit") as sp:
        assert sp is trace._NULL_SPAN
    with tr.device_span("refine_packed", group="g"):
        pass
    assert kept == []
    monkeypatch.undo()
    with capture.Capture() as cap:
        with tr.span("emit", cat="write"):
            pass
    with tr.span("admit"):
        pass
    assert [r.name for r in cap.records] == ["emit"]
    assert capture.ACTIVE == []
    tr.close()


def test_a_capture_never_synchronises(monkeypatch):
    """A captured device span's force is the identity, a CUDA tensor in
    its output or not: only a trace file forces."""
    calls = _syncs(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("device"))
    fake = torch.Tensor._make_subclass(_FakeCuda, torch.zeros(3))
    tr = trace.Tracer(None, stall_timeout=0)
    with capture.Capture() as cap:
        with tr.device_span("refine_packed", group="g") as sp:
            assert sp.force(fake) is fake
        with tr.device_span("materialize", group="g",
                            attribute=False) as sp:
            assert sp.force((fake, [fake])) is not None
    tr.close()
    assert calls == []
    assert [r.name for r in cap.records] == ["refine_packed", "materialize"]


@pytest.fixture(scope="module")
def tiny_fasta(tmp_path_factory):
    """Four holes of 400-bp templates, one with an adapter read-through,
    as FASTA."""
    d = tmp_path_factory.mktemp("capture")
    rng = np.random.default_rng(11)
    zs = []
    for h in range(4):
        z = synth.make_zmw(rng, 400, 5 + h % 2, movie="mv", hole=str(h))
        if h == 1:
            z.passes.insert(2, synth.read_through(rng, z.template))
            z.strands.insert(2, 0)
        zs.append(z)
    fa = d / "in.fa"
    fa.write_text(synth.make_fasta(zs))
    return fa


TINY = ["-A", "-m", "500", "--batch", "on", "--device", "cpu"]


@pytest.fixture(scope="module")
def captured_runs(tiny_fasta, tmp_path_factory):
    """The port's batched driver on the CPU, three ways: under a capture
    with no trace file (the prep pool's threads, the default); under
    --trace alone and under --trace and a capture (inline prep, so both
    admit and sweep alike).  No synchronise may be asked for in any of
    them."""
    d = tmp_path_factory.mktemp("captured")
    calls = []
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    runs = {}
    try:
        for name, traced, captured in (("capture", False, True),
                                       ("trace", True, False),
                                       ("both", True, True)):
            out, t = d / f"{name}.fa", d / f"{name}.jsonl"
            argv = TINY + (["--trace", str(t), "--prep-threads", "0"]
                           if traced else []) + [str(tiny_fasta), str(out)]
            cap = capture.Capture()
            if captured:
                with cap:
                    assert cli.main(argv) == 0
            else:
                assert cli.main(argv) == 0
            runs[name] = {"cap": cap, "out": out.read_bytes(),
                          "trace": t if traced else None}
    finally:
        mp.undo()
    assert calls == []
    return runs


def _inside(r, outer):
    return outer.start <= r.start and r.end <= outer.end


def test_capture_records_the_driver_spans(captured_runs):
    """Every phase of the driver thread is a span of the capture: admit,
    emit (write_record inside), refine_sweep with plan, slab_pack,
    refine_packed, materialize, unpack and hole_step inside it, one
    hole_step a sweep and one slab_pack, materialize and unpack a
    refine_packed; each sweep's self time is its own minus its
    children's."""
    cap = captured_runs["capture"]["cap"]
    mine = [r for r in cap.records if r.thread == cap.thread]
    names = collections.Counter(r.name for r in mine)
    assert set(DRIVER_SPANS) <= set(names)
    assert names["hole_step"] == names["refine_sweep"] == names["plan"]
    assert (names["slab_pack"] == names["refine_packed"]
            == names["materialize"] == names["unpack"])
    assert names["write_record"] == 4
    assert "prep_hole" not in names    # on the pool's threads
    sweeps = [r for r in mine if r.name == "refine_sweep"]
    for r in mine:
        assert cap.start <= r.start <= r.end <= cap.end
        assert -1e-9 <= r.self_s <= r.end - r.start + 1e-9
        # the thread clock is read for the opener's plain spans only
        assert (r.cpu_s is None) == (r.cat == "device")
        assert r.cpu_s is None or r.cpu_s >= 0.0
        if r.name in SWEEP_CHILDREN:
            assert sum(_inside(r, s) for s in sweeps) == 1, r
    assert all(r.cpu_s is None for r in cap.records
               if r.thread != cap.thread)
    emits = [r for r in mine if r.name == "emit"]
    for r in mine:
        if r.name == "write_record":
            assert any(_inside(r, e) for e in emits)
    for s in sweeps:
        kids = [r for r in mine if r.name in SWEEP_CHILDREN
                and _inside(r, s)]
        assert s.self_s == pytest.approx(
            (s.end - s.start) - sum(k.end - k.start for k in kids),
            abs=1e-6)
    assert any(r.name == "prep_hole" for r in cap.records)


def test_trace_files_keep_every_old_span(captured_runs):
    """A --trace file carries the same span records with or without a
    capture open (names, categories, threads, args), the new driver
    spans among them in the documented categories; the bytes of the
    output are the same in all three runs, and the captured spans of the
    traced run are its file's."""
    def spans(path):
        return collections.Counter(
            (r["name"], r["cat"], r["tid"],
             json.dumps({k: v for k, v in r.get("args", {}).items()
                         if k != "plan"}, sort_keys=True))
            for r in _read_jsonl(path) if r["ev"] == "span")

    a = spans(captured_runs["trace"]["trace"])
    b = spans(captured_runs["both"]["trace"])
    assert a == b
    cats = {(k[0], k[1]) for k in a}
    for name, cat in (("admit", "host"), ("emit", "write"),
                      ("plan", "compute"), ("slab_pack", "compute"),
                      ("unpack", "compute"), ("hole_step", "compute"),
                      ("refine_sweep", "compute"),
                      ("refine_packed", "device"),
                      ("materialize", "device"),
                      ("write_record", "write"), ("prep_hole", "prep"),
                      ("ingest_hole", "ingest")):
        assert (name, cat) in cats
    # the file's keys are the recorder's, as before
    for r in _read_jsonl(captured_runs["both"]["trace"]):
        if r["ev"] == "span":
            assert set(r) <= {"ev", "name", "cat", "ts", "mono", "dur",
                              "tid", "self", "args", "compile", "cid",
                              "warmup"}
    outs = {run["out"] for run in captured_runs.values()}
    assert len(outs) == 1 and next(iter(outs)).count(b"/ccs\n") == 4
    # the captured spans of the traced run are the file's
    cap = captured_runs["both"]["cap"]
    assert collections.Counter(r.name for r in cap.records) == \
        collections.Counter(r["name"] for r in
                            _read_jsonl(captured_runs["both"]["trace"])
                            if r["ev"] == "span")


def test_a_profiled_run_keeps_its_capture(tiny_fasta, tmp_path,
                                          monkeypatch):
    """run_pipeline opens a capture for its run while torch.profiler
    records, on the thread that called it, and leaves it on the run's
    metrics once closed; without the profiler it takes none."""
    from torch.profiler import ProfilerActivity, profile

    from ccsx_tpu_torch.pipeline import run

    def drive(*a, **k):
        with trace.span("admit"):
            pass
        with trace.device_span("refine_packed", group="g"):
            pass

    monkeypatch.setattr(batch, "drive_batched", drive)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        TINY + [str(tiny_fasta), str(tmp_path / "o.fa")]))
    m = RunMetrics()
    assert run.run_pipeline(str(tiny_fasta), str(tmp_path / "o.fa"), cfg,
                            batch="on", metrics=m) == 0
    assert m.capture is None
    with profile(activities=[ProfilerActivity.CPU]):
        m = RunMetrics()
        assert run.run_pipeline(str(tiny_fasta), str(tmp_path / "p.fa"),
                                cfg, batch="on", metrics=m) == 0
        assert capture.ACTIVE == []
    cap = m.capture
    assert cap.thread == threading.get_ident() and cap.end is not None
    assert [(r.name, r.thread) for r in cap.records] == [
        ("admit", cap.thread), ("refine_packed", cap.thread)]
