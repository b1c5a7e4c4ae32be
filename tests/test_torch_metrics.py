"""The port's counters (ccsx_tpu_torch/utils/metrics.py, run_metrics.py)
and the recording wired into its drivers, against the JAX package's.

The JAX package's metrics tests (tests/test_metrics.py) of the same names,
run on the port: stage timers and windows for both drivers, progress
events, the report closing its stream, the verbose ladder and the DP
occupancy counters.  The failure budget (check_failure_budget): its
count and fraction rules, and rc 2 through the CLI, the JAX CLI's rc on
the same input with the same hole failing in both.  resource_gauges never
imports torch nor initialises CUDA.  Then one small corpus through the JAX
CLI (JAX:CPU, its inline-prep batched path) and through the port's CLI
(``--device cpu --batch on``), each under ``--trace --metrics``: equal
output bytes, equal final counters, the port's snapshot keys a superset of
the JAX package's, and equal multisets of device spans (name, group).
Counters and bytes are integers: the tolerance is exact equality.
"""

import collections
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from ccsx_tpu import cli as jcli
from ccsx_tpu.pipeline import batch as jbatch
from ccsx_tpu.utils import synth as jsynth
from ccsx_tpu.utils import trace as jtrace

from ccsx_tpu_torch import cli, exitcodes
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.io import fastx
from ccsx_tpu_torch.pipeline import batch
from ccsx_tpu_torch.pipeline.run import run_pipeline
from ccsx_tpu_torch.utils import trace
from ccsx_tpu_torch.utils.metrics import (FailureBudgetExceeded,
                                          check_failure_budget,
                                          resource_gauges)
from ccsx_tpu_torch.utils.run_metrics import PORT_KEYS, RunMetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BATCHED = ["--batch", "on", "--device", "cpu", "--prep-threads", "0",
               "--no-warmup"]
# the port's inline-prep batched path: spans, counters and the patched
# hole generator run on the driver thread, as on the JAX side
PORT_BATCHED = ["--batch", "on", "--device", "cpu", "--prep-threads", "0"]


def _read_jsonl(path):
    return [json.loads(line) for line in open(path) if line.strip()]


def _final_event(path):
    events = _read_jsonl(path)
    finals = [e for e in events if e["event"] == "final"]
    assert len(finals) == 1 and events[-1] is finals[0]
    return finals[0]


def _write_fasta(path, rng, n_holes=3, tlen=700, n_passes=5, **kw):
    zs = [jsynth.make_zmw(rng, template_len=tlen, n_passes=n_passes,
                          movie="mv", hole=str(h), **kw)
          for h in range(n_holes)]
    path.write_text(jsynth.make_fasta(zs))
    return zs


# ---- the JAX package's metrics tests, on the port ---------------------------


@pytest.mark.parametrize("batch_arg", ["off", "on"])
def test_stage_timers_and_windows_are_written(tmp_path, batch_arg):
    fa = tmp_path / "in.fa"
    _write_fasta(fa, np.random.default_rng(0))
    mpath = tmp_path / "m.jsonl"
    assert cli.main(["-A", "-m", "1000", "--batch", batch_arg, "--device",
                     "cpu", "--metrics", str(mpath), str(fa),
                     str(tmp_path / "o.fa")]) == 0
    final = _final_event(mpath)
    assert (final["holes_in"], final["holes_out"]) == (3, 3)
    assert final["ingest_s"] > 0 and final["compute_s"] > 0
    assert final["write_s"] > 0
    assert final["windows"] >= 3 and final["device_dispatches"] > 0
    if batch_arg == "on":
        assert final["prep_s"] > 0 and final["slabs"] > 0
    assert all("ts" in e for e in _read_jsonl(mpath))


def test_progress_events_every_n_holes():
    buf = io.StringIO()
    m = RunMetrics(stream=buf, progress_every=2)
    for _ in range(5):
        m.holes_out += 1
        m.tick()
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    progress = [e for e in events if e["event"] == "progress"]
    assert [e["holes_out"] for e in progress] == [2, 4]
    assert all(e["slabs"] == 0 for e in progress)     # the port's keys ride


def test_report_closes_file_stream(tmp_path):
    p = tmp_path / "m.jsonl"
    f = open(p, "a")
    m = RunMetrics(stream=f)
    m.report()
    assert f.closed and m.stream is None
    final = _final_event(p)
    assert set(PORT_KEYS) <= set(final)
    assert {"peak_rss_bytes", "device_buffer_bytes"} <= set(final)


def test_verbose_ladder(tmp_path, capsys):
    """-v levels through the port's per-hole driver: 1 = segment dump,
    2 = consensus begin/end per hole, 3 = per-window breakpoint stats; and
    the last stderr line is the final metrics snapshot."""
    fa = tmp_path / "in.fa"
    _write_fasta(fa, np.random.default_rng(0), n_holes=1, tlen=1500)
    cfg = CcsConfig(is_bam=False, min_subread_len=1000, verbose=3,
                    device="cpu", window_init=512, window_add=512,
                    window_minlen=256, max_window=2048)
    assert run_pipeline(str(fa), str(tmp_path / "o.fa"), cfg) == 0
    err = capsys.readouterr().err
    assert "segment offs=" in err
    assert "consensus begin mv/0" in err and "consensus end mv/0" in err
    assert "window size=" in err and "breakpoint=" in err
    prefix, snap = err.strip().splitlines()[-1].split(" ", 1)
    assert prefix == "[ccsx-tpu-torch]"
    assert json.loads(snap)["holes_out"] == 1


def test_dp_occupancy_counters(parity):
    """The batched run's padding occupancy: present, in (0, 1], and the
    round occupancy factorizes exactly into length x pass x z fill."""
    fin = parity["port"]["final"]
    assert fin["dp_cells_padded"] >= fin["dp_cells_real"] > 0
    for k in ("dp_occupancy", "dp_round_occupancy", "dp_length_fill",
              "dp_pass_fill", "dp_z_fill", "dp_row_fill"):
        assert 0 < fin[k] <= 1, k
    prod = fin["dp_length_fill"] * fin["dp_pass_fill"] * fin["dp_z_fill"]
    assert abs(prod - fin["dp_round_occupancy"]) < 2e-3


# ---- the failure budget ------------------------------------------------------


def test_failure_budget_units():
    cfg = types.SimpleNamespace(max_failed_holes=None)
    m = RunMetrics()
    m.holes_failed = 10 ** 6
    check_failure_budget(m, cfg)                     # unbounded
    cfg.max_failed_holes = 0.0                       # count 0: any fails
    with pytest.raises(FailureBudgetExceeded):
        check_failure_budget(m, cfg)
    m = RunMetrics()
    m.holes_failed, m.holes_out = 2, 8
    cfg.max_failed_holes = 2.0
    check_failure_budget(m, cfg, final=True)         # at the budget
    m.holes_failed = 3
    with pytest.raises(FailureBudgetExceeded):
        check_failure_budget(m, cfg)                 # past it
    m.holes_failed = 2
    cfg.max_failed_holes = 0.25
    check_failure_budget(m, cfg, final=True)         # 2/10 <= 25%
    cfg.max_failed_holes = 0.1
    with pytest.raises(FailureBudgetExceeded):
        check_failure_budget(m, cfg, final=True)     # 2/10 > 10%
    m2 = RunMetrics()
    m2.holes_failed, m2.holes_total = 5, 10          # a known total
    cfg.max_failed_holes = 0.2
    with pytest.raises(FailureBudgetExceeded):
        check_failure_budget(m2, cfg)


def test_cli_rejects_bad_budget(tmp_path, capsys):
    for bad in ("-3", "inf", "nan", "x", "1.5"):
        argv = ["--max-failed-holes", bad, "x.fa", str(tmp_path / "y.fa")]
        assert cli.main(argv) == jcli.main(argv) == 1, bad
        assert capsys.readouterr().err.count("--max-failed-holes") == 2
    assert cli.main(["--stall-timeout", "-1", "x.fa",
                     str(tmp_path / "y.fa")]) == 1


@pytest.fixture(scope="module")
def budget_corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("budget")
    fa = d / "in.fa"
    _write_fasta(fa, np.random.default_rng(3), tlen=600)
    return fa


@pytest.mark.parametrize("budget,want", [("0", 2), ("1", 0), ("0.2", 2),
                                         ("0.5", 0)])
def test_failure_budget_rc_matches_jax_cli(budget_corpus, tmp_path,
                                           monkeypatch, capsys, budget, want):
    """The second of three holes fails at its first generator step in both
    packages; a count budget of 0 or a fraction of 0.2 exits rc 2, 1 and
    0.5 keep rc 0, in both CLIs; the port writes the two good holes."""
    def failing(real):
        def gen(zmw, cfg):
            if zmw.hole == "1":
                raise ValueError("injected hole failure")
            return real(zmw, cfg)
        return gen

    monkeypatch.setattr(jbatch, "full_gen_for_zmw",
                        failing(jbatch.full_gen_for_zmw))
    monkeypatch.setattr(batch, "full_gen_for_zmw",
                        failing(batch.full_gen_for_zmw))
    fa = str(budget_corpus)
    rcs = {}
    for name, main, flags in (("jax", jcli.main, JAX_BATCHED),
                              ("port", cli.main, PORT_BATCHED)):
        m = tmp_path / f"{name}.jsonl"
        rcs[name] = main(["-A", "-m", "1000", *flags, "--metrics", str(m),
                          "--max-failed-holes", budget, fa,
                          str(tmp_path / f"{name}.fa")])
        err = capsys.readouterr().err
        assert "injected hole failure" in err
        assert ("failed-hole budget exceeded" in err) == (want == 2)
        assert _final_event(m)["holes_failed"] == 1
    assert rcs == {"jax": want, "port": want}
    assert want != 2 or want == exitcodes.RC_FAILED_HOLES
    if want == 0:
        names = [r.name for r in fastx.read_fastx(str(tmp_path / "port.fa"))]
        assert names == ["mv/0/ccs", "mv/2/ccs"]


# ---- resource_gauges -----------------------------------------------------------


def test_resource_gauges_never_import_torch_nor_init_cuda():
    code = ("import sys\n"
            "from ccsx_tpu_torch.utils.metrics import resource_gauges\n"
            "g = resource_gauges()\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n"
            "assert g['device_buffer_bytes'] == 0 and "
            "g['peak_rss_bytes'] > 0\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    # torch loaded, CUDA never initialised: read nothing, start nothing
    was = torch.cuda.is_initialized()
    g = resource_gauges()
    assert torch.cuda.is_initialized() == was
    if not was:
        assert g["device_buffer_bytes"] == 0


# ---- one corpus through both CLIs ----------------------------------------------


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Three holes of 800-bp templates, two with an adapter read-through
    pass (so the strand walk aligns pairs), device seeding from 512-base
    templates (so the seed step runs), through both CLIs with --trace and
    --metrics."""
    d = tmp_path_factory.mktemp("parity")
    fa = d / "in.fa"
    rng = np.random.default_rng(8)
    zs = []
    for h in range(3):
        z = jsynth.make_zmw(rng, template_len=800, n_passes=5 + h,
                            movie="mv", hole=str(h))
        if h:
            z.passes.insert(2 + h, jsynth.read_through(rng, z.template))
            z.strands.insert(2 + h, 0)
        zs.append(z)
    fa.write_text(jsynth.make_fasta(zs))
    runs = {}
    for name, main, flags in (("jax", jcli.main, JAX_BATCHED),
                              ("port", cli.main, PORT_BATCHED)):
        t, m, o = (str(d / f"{name}.{x}") for x in ("trace.jsonl",
                                                    "metrics.jsonl", "fa"))
        assert main(["-A", "-m", "1000", *flags, "--seed-device-min-t",
                     "512", "--trace", t, "--metrics", m, str(fa), o]) == 0
        runs[name] = {"trace": t, "metrics": m,
                      "out": open(o, "rb").read(),
                      "final": _final_event(m)}
    return runs


def test_cli_parity_output_bytes_equal(parity):
    assert parity["port"]["out"] == parity["jax"]["out"]
    assert parity["port"]["out"].count(b"/ccs\n") == 3


# counters the two packages keep alike on this corpus
SAME = ("holes_in", "holes_out", "holes_failed", "holes_filtered", "windows",
        "pair_alignments", "pairs_screened", "pairs_prefiltered",
        "pairs_seeded_device", "pairs_seeded_host", "refine_overflows",
        "dp_cells_real", "device_dispatches", "banded_dispatches",
        "dp_round_occupancy", "dp_length_fill",
        "dp_pass_fill", "dp_z_fill", "dp_row_fill",
        "packed_holes_per_dispatch", "oom_resplits", "host_fallbacks",
        "stalls", "groups_forced", "breaker_state", "distinct_slab_shapes")


def test_cli_parity_final_counters(parity):
    jf, pf = parity["jax"]["final"], parity["port"]["final"]
    for k in SAME:
        assert pf[k] == jf[k], k
    assert pf["pair_alignments"] > 0 and pf["pairs_seeded_device"] > 0
    # differ by design: the JAX package pads a pair group's N to a power
    # of two (_z_bucket) and the port does not, so dp_cells_padded and
    # dp_occupancy differ.  distinct_slab_shapes counts the slab programs
    # dispatched: compiled there, CUDA graphs here (pipeline/graphs.py)
    assert pf["dp_cells_padded"] <= jf["dp_cells_padded"]
    assert pf["distinct_slab_shapes"] >= 1
    assert pf["slabs"] == sum(pf["banded_dispatches"].values()) > 0
    assert pf["pair_fills"] + pf["seed_steps"] + pf["slabs"] == \
        pf["device_dispatches"]
    assert pf["failed_steps"] == 0


def test_cli_parity_snapshot_keys_superset(parity):
    jf, pf = parity["jax"]["final"], parity["port"]["final"]
    assert set(jf) <= set(pf)
    assert set(pf) - set(jf) == set(PORT_KEYS)


def _device_spans(path):
    return collections.Counter(
        (r["name"], r["args"]["group"]) for r in _read_jsonl(path)
        if r.get("ev") == "span" and r["cat"] == "device"
        and r["name"] != "warmup")


def test_cli_parity_device_span_multiset(parity):
    """The same device spans under the same groups, materialize waits
    included; the JAX package's AOT warmup spans have no counterpart."""
    want = _device_spans(parity["jax"]["trace"])
    got = _device_spans(parity["port"]["trace"])
    assert got == want
    names = {n for n, _ in got}
    assert {"pair_fill", "seed_device", "refine_packed",
            "materialize"} <= names


def test_traced_run_group_table_matches_spans(parity):
    """The per-group sums of the port's trace spans equal the group table
    of its final metrics event."""
    recs = _read_jsonl(parity["port"]["trace"])
    dev = [r for r in recs if r["ev"] == "span" and r["cat"] == "device"
           and "compile" in r]
    sums = {}
    for r in dev:
        st = sums.setdefault(r["args"]["group"],
                             {"compiles": 0, "compile_s": 0.0,
                              "execute_s": 0.0, "dispatches": 0,
                              "dp_cells": 0})
        if r.get("warmup"):
            # the warmup plane's span books its shape's compile and no
            # dispatch (trace.summarize's rule)
            st["compiles"] += r["compile"]
            st["compile_s"] += r["dur"] if r["compile"] else 0.0
            continue
        st["dispatches"] += 1
        st["dp_cells"] += r["args"].get("cells", 0)
        st["compiles" if r["compile"] else "execute_s"] += (
            1 if r["compile"] else r["dur"])
        if r["compile"]:
            st["compile_s"] += r["dur"]
    groups = parity["port"]["final"]["groups"]
    assert set(groups) == set(sums) == set(parity["jax"]["final"]["groups"])
    for key, st in sums.items():
        g = groups[key]
        for k in ("compiles", "dispatches", "dp_cells"):
            assert g[k] == st[k], (key, k)
        assert abs(g["compile_s"] - st["compile_s"]) < 0.01
        assert abs(g["execute_s"] - st["execute_s"]) < 0.01
    cats = {r["cat"] for r in recs if r["ev"] == "span"}
    assert {"ingest", "prep", "compute", "device", "write"} <= cats
    chrome = json.load(open(trace.chrome_path(parity["port"]["trace"])))
    assert any(e.get("cat") == "device" for e in chrome["traceEvents"])


def test_stats_subcommand_summary(parity, capsys):
    """`stats` through the port's CLI on the port's files; and both
    packages' stats_main print the same bytes on either package's
    files."""
    p = parity["port"]
    assert cli.main(["stats", p["trace"], p["metrics"]]) == 0
    out = capsys.readouterr().out
    for want in ("shape groups:", "packed:", "stage breakdown",
                 "slowest device dispatches:", "occupancy recap:",
                 "degraded: none"):
        assert want in out
    for run in parity.values():
        argv = [run["trace"], run["metrics"]]
        assert jtrace.stats_main(argv) == trace.stats_main(argv) == 0
        a, b = capsys.readouterr().out.split("== ccsx-tpu stats:")[1:]
        assert a == b
    assert cli.main(["stats", "/nonexistent/x.jsonl"]) == 1
    assert "Error: stats:" in capsys.readouterr().err
