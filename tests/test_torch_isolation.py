"""The port stands alone: no module of ccsx_tpu_torch, nor chip_smoke.py,
imports jax or anything of the JAX package (ccsx_tpu), and its entry
points refuse to fall back to the CPU when no card is present."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.utils.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "ccsx_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ccsx_tpu")

# a meta-path finder that makes the forbidden packages unimportable
_BLOCKER = """
import importlib.abc, sys
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in %r:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, _Block())
""" % (FORBIDDEN,)


def _modules():
    names = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_every_module_imports_without_jax_or_reference():
    mods = _modules()
    assert {"ccsx_tpu_torch.ops.banded_cuda", "ccsx_tpu_torch.ops.seed_device",
            "ccsx_tpu_torch.consensus.whole_read",
            "ccsx_tpu_torch.utils.trace", "ccsx_tpu_torch.utils.metrics",
            "ccsx_tpu_torch.utils.blackbox",
            "ccsx_tpu_torch.utils.run_metrics",
            "ccsx_tpu_torch.utils.faultinject",
            "ccsx_tpu_torch.utils.journal", "ccsx_tpu_torch.utils.drain",
            "ccsx_tpu_torch.utils.fingerprint", "ccsx_tpu_torch.native",
            "ccsx_tpu_torch.native.io",
            "ccsx_tpu_torch.pipeline.prep_pool",
            "ccsx_tpu_torch.pipeline.warmup",
            "ccsx_tpu_torch.pipeline.graphs",
            "ccsx_tpu_torch.io.bamindex", "ccsx_tpu_torch.utils.telemetry",
            "ccsx_tpu_torch.utils.report",
            "ccsx_tpu_torch.parallel.distributed",
            "ccsx_tpu_torch.utils.lease", "ccsx_tpu_torch.pipeline.gateway",
            "ccsx_tpu_torch.pipeline.serve",
            "ccsx_tpu_torch.pipeline.fleet",
            "ccsx_tpu_torch.pipeline.supervisor",
            "ccsx_tpu_torch.parallel.mesh",
            "ccsx_tpu_torch.native.align"} <= set(mods)
    code = _BLOCKER + "\n".join(
        f"import {m}" for m in mods) + "\nimport chip_smoke\n" + (
        "assert not any(k.split('.')[0] in %r for k in sys.modules)\n"
        "print('ok')\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_ast_scan_finds_no_forbidden_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [(f.name, n) for n in names
                     if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_stats_and_blackbox_run_without_torch_or_jax(tmp_path):
    """`python -m ccsx_tpu_torch.cli stats ...`, `... blackbox ...`,
    `... top ...` and `... report ...` run with torch, jax and the JAX
    package unimportable: they read a run's files (or its endpoints) on a
    host whose card is wedged."""
    from ccsx_tpu_torch.utils import blackbox, trace
    from ccsx_tpu_torch.utils.metrics import Metrics

    t = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(t)
    with tr.device_span("refine_packed", group="packed:q9", cells=9):
        pass
    tr.close()
    box = blackbox.BlackBox(blackbox.box_path(str(tmp_path), 7))
    box.record({"ev": "begin", "tid": "T", "name": "refine_packed"})
    box.close()
    m = str(tmp_path / "m.jsonl")
    metrics = Metrics(stream=open(m, "w"))
    metrics.holes_in = metrics.holes_out = 5
    metrics.report()
    html = str(tmp_path / "r.html")
    blocked = FORBIDDEN + ("torch",)
    blocker = _BLOCKER.replace(repr(FORBIDDEN), repr(blocked))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for argv, want in ((["stats", t], "packed:q9"),
                       (["blackbox", str(tmp_path)], "in-flight at death"),
                       (["top", "--once", "--no-color", m], "out 5"),
                       (["report", t, m, "-o", html], "")):
        code = (blocker + "import runpy\nsys.argv = %r\n" % (
            ["ccsx_tpu_torch.cli"] + argv,)
            + "try:\n    runpy.run_module('ccsx_tpu_torch.cli', "
            "run_name='__main__')\nfinally:\n"
            "    assert not any(k.split('.')[0] in %r for k in sys.modules)"
            "\n" % (blocked,))
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        assert want in r.stdout
    page = open(html, encoding="utf-8").read()
    assert page.startswith("<!DOCTYPE html>") and "packed:q9" in page


def test_crash_safety_modules_import_without_torch():
    """faultinject, journal, drain and fingerprint import with torch, jax
    and the JAX package unimportable (torch only inside the device_oom
    action), as the torch-free subcommands need of what they import."""
    blocked = FORBIDDEN + ("torch",)
    blocker = _BLOCKER.replace(repr(FORBIDDEN), repr(blocked))
    code = blocker + (
        "from ccsx_tpu_torch.utils import drain, faultinject, fingerprint, "
        "journal\n"
        "from ccsx_tpu_torch import exitcodes\n"
        "faultinject.arm('compute@1')\n"
        "try:\n    faultinject.fire('compute')\n"
        "except RuntimeError as e:\n    print(e)\n"
        "assert not any(k.split('.')[0] in %r for k in sys.modules)\n"
        % (blocked,))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "injected compute fault" in r.stdout


def test_resolve_device_cuda_raises_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device("auto")
    assert resolve_device("cpu").type == "cpu"


def test_cli_refuses_to_run_on_cpu_without_asking(tmp_path, capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    fa = tmp_path / "in.fa"
    fa.write_text(">m/1/0_4\nACGT\n")
    out = tmp_path / "out.fa"
    assert cli.main(["-A", str(fa), str(out)]) != 0
    assert "--device cpu" in capsys.readouterr().err
    assert not out.exists()
    # asked for, the CPU runs either driver (this one-pass hole is filtered)
    assert cli.main(["-A", "--batch", "on", "--device", "cpu", str(fa),
                     str(out)]) == 0
    assert out.read_text() == ""


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def _fake_card(monkeypatch):
    """Make the driver believe a card is present (no tensor ever reaches
    it in these tests)."""
    from ccsx_tpu_torch.pipeline import run

    monkeypatch.setattr(run, "resolve_device",
                        lambda requested: __import__("torch").device("cuda"))
    return run


def test_cli_fails_when_the_kernels_cannot_build(monkeypatch, tmp_path, capsys):
    from ccsx_tpu_torch.ops import cuda_ext

    _fake_card(monkeypatch)
    monkeypatch.setattr(cuda_ext, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_ext, "_libs", {})

    def no_nvcc():
        raise cuda_ext.KernelError("nvcc not found")

    monkeypatch.setattr(cuda_ext, "_nvcc", no_nvcc)
    fa = tmp_path / "in.fa"
    fa.write_text(">m/1/0_4\nACGT\n")
    out = tmp_path / "out.fa"
    assert cli.main(["-A", str(fa), str(out)]) != 0
    assert "nvcc not found" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("threads", [1, 2])
def test_device_fault_ends_the_run_bad_hole_is_quarantined(
        threads, monkeypatch, tmp_path, capsys):
    """A kernel or card failure inside a hole is fatal (it would hit every
    later hole); a hole's own error is quarantined and the run goes on."""
    from ccsx_tpu_torch.ops import cuda_ext

    run = _fake_card(monkeypatch)
    monkeypatch.setattr(cuda_ext, "load_all", lambda: None)
    from ccsx_tpu_torch.utils import synth

    rng = np.random.default_rng(0)
    fa = tmp_path / "in.fa"
    fa.write_text(synth.make_fasta([
        synth.make_zmw(rng, 1000, 6, movie="m", hole=str(h)) for h in range(3)]))
    out = tmp_path / "out.fa"
    # the per-hole driver's rules (on the card --batch auto is the batched
    # driver, whose rules tests/test_torch_batch.py holds)
    argv = ["-A", "-m", "1000", "--batch", "off", "-j", str(threads),
            str(fa), str(out)]
    for exc in (cuda_ext.KernelError("banded global fill: CUDA launch failed"),
                RuntimeError("CUDA error: an illegal memory access")):
        def fault(*a, exc=exc):
            raise exc
        monkeypatch.setattr(run, "ccs_hole", fault)
        assert cli.main(argv) != 0
        assert "device failure" in capsys.readouterr().err

    def bad_hole(*a):
        raise ValueError("bad hole")

    monkeypatch.setattr(run, "ccs_hole", bad_hole)
    assert cli.main(argv + ["-v"]) == 0
    err = capsys.readouterr().err
    assert "failed: bad hole" in err
    # -v's last line is the final metrics snapshot
    snap = json.loads(err.strip().splitlines()[-1].split(" ", 1)[1])
    assert snap["holes_failed"] == 3 and snap["holes_out"] == 0


# ---- the copied host planes against the JAX package's modules -------------


def _top_level(path, drop=None):
    """{key: AST dump} of a module's top-level statements, docstrings
    dropped and the port's package prefix mapped to the JAX package's:
    each import name, assignment target, function, and each class with its
    methods and class attributes under 'Class.name'.  ``drop`` maps a
    function name to a symbol whose statements are removed from its body."""
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

    def named(node, prefix=""):
        if isinstance(node, ast.Import):
            return {f"import {a.name}": "" for a in node.names}
        if isinstance(node, ast.ImportFrom):
            return {f"from {node.module} import {a.name}": ""
                    for a in node.names}
        if isinstance(node, ast.FunctionDef):
            if drop and node.name in drop:
                node.body = [s for s in node.body
                             if drop[node.name] not in ast.dump(s)]
            return {prefix + node.name: ast.dump(node)}
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            return {prefix + ast.unparse(t): ast.dump(node)
                    for t in targets}
        if isinstance(node, ast.ClassDef):
            out = {}
            for item in node.body:
                out.update(named(item, f"{node.name}."))
            node.body = [ast.Pass()]
            out[node.name] = ast.dump(node)
            return out
        return {f"{prefix}stmt {ast.dump(node)}": ast.dump(node)}

    out = {}
    for node in tree.body:
        out.update(named(node))
    return out


# module -> (definitions that differ, port-only keys, JAX-only keys, and
# the symbol whose statements the port drops from a JAX function)
COPIES = {
    # the build: two g++ calls on the port's own copies into build/ (the
    # baseline's scalar object, then the library of the three sources),
    # not make into the package; _bind also types the baseline fill's
    # entries, which the JAX package's callers type themselves
    "native/__init__.py": (
        {"_note_failure", "_build", "lib", "_bind"},
        {"import hashlib", "import time", "SOURCE", "AIDS", "BUILD_DIR",
         "CXX_FLAGS", "LIBS", "SCALAR_FLAGS", "_unlink",
         "load_state", "_log_path", "_host_key", "target"},
        {"_SO", "_LOG"}, None),
    "native/io.py": (set(), set(), set(), None),
    "native/align.py": (set(), set(), set(), None),
    # the mesh over logical devices (torch devices, one stream each on the
    # card) instead of jax.sharding: its builders and the sharded round
    # differ; shard_map_compat (JAX's API split) and shard_batch
    # (device_put with NamedShardings) have no counterpart; the entries,
    # the stream scopes and sends, the placed outputs and the per-block
    # round are the port's
    "parallel/mesh.py": (
        {"build_slab_mesh", "build_mesh", "make_sharded_round"},
        {"import contextlib", "import dataclasses", "import torch",
         "from typing import Callable", "from typing import List",
         "from typing import Sequence",
         "from ccsx_tpu.consensus.star import global_fill",
         "from ccsx_tpu.ops import cuda_ext", "from ccsx_tpu.ops import msa",
         "Entry", "Entry.device", "Entry.index", "Entry.stream",
         "make_entries", "Mesh", "Mesh.shape", "Mesh.devices", "Mesh.flat",
         "Mesh.entries", "Mesh.axis_names", "scope", "send", "put",
         "Placed", "Placed.__init__", "Placed.shape", "Placed.synchronize",
         "Placed.read", "block_rows", "shard_round", "split_passes",
         "place_blocks"},
        {"import functools", "import jax", "import jax.numpy",
         "from jax.sharding import Mesh", "from jax.sharding import "
         "NamedSharding", "from jax.sharding import PartitionSpec",
         "from ccsx_tpu.ops import banded", "shard_map_compat",
         "shard_batch"}, None),
    # the fatal-error hand-off: a device fault met by the pump or a worker
    # is kept for the driver thread, never a quarantined hole; a stream
    # error is raised by emit_ok at a fixed point of the emission order
    # (the holes written before it do not depend on thread timing), not
    # by the first poll/get that finds nothing prepped
    "pipeline/prep_pool.py": (
        {"_PairGate.__init__", "_PairGate._pump", "PrepPool.__init__",
         "PrepPool._ingest_one", "PrepPool._prep", "PrepPool.poll",
         "PrepPool.get"},
        {"from ccsx_tpu.ops import cuda_ext", "PrepPool._keep_fatal",
         "PrepPool._raise_fatal_locked", "PrepPool.emit_ok"},
        {"PrepPool._raise_ingest_error"}, None),
    # one capture worker and no settle time by default (a capture holds
    # the interpreter lock and costs milliseconds, not an XLA compile's
    # tens of seconds); the failure note says capture; promote, the
    # dispatch path's wait for a predicted build
    "pipeline/warmup.py": (
        {"WarmupCompiler.__init__", "WarmupCompiler._run"},
        {"WarmupCompiler.promote"}, set(), None),
    # the hole index: the same sidecar name, version and bytes
    "io/bamindex.py": (set(), set(), set(), None),
    # the port's step counters are exported too (the schema guard holds
    # every snapshot key to a declared family)
    "utils/telemetry.py": ({"PROM_COUNTERS"}, set(), set(), None),
    "utils/report.py": (set(), set(), set(), None),
    # a rank runs through run.run_pipeline's setup, which owns the
    # Metrics, the device and the mesh precheck (before open_io opens the
    # shard); the control plane is a torch.distributed gloo group with a
    # bounded rendezvous, destroyed when the rank ends
    "parallel/distributed.py": (
        {"run_pipeline_sharded", "init_distributed"},
        {"RENDEZVOUS_TIMEOUT_S", "RendezvousError",
         "RendezvousError.stmt Pass()", "shutdown_distributed"},
        {"from ccsx_tpu.utils.metrics import Metrics"}, None),
    # the lease primitive and the spool protocol with its gateway: plain
    # copies
    "utils/lease.py": (set(), set(), set(), None),
    "pipeline/gateway.py": (set(), set(), set(), None),
    # a range runs through run.run_pipeline's setup (its open_io opens the
    # range's stream, journal and shard writer), whose mesh precheck comes
    # before open_io
    "pipeline/fleet.py": ({"_run_range"}, set(), set(), None),
    # the serving plane: run.run_pipeline (batched) is the job entry, with
    # RunMetrics; a device fault stops the server
    # (_device_stop, readiness' "device_fault", serve_main's loop and rc
    # 1, the card and kernels up before the port binds); job snapshots
    # carry the port's step counters and the job's own launches, eager
    # dispatches and replays (cuda_ext.scope around the job thread); the
    # server's snapshot carries the refine programs' cumulative counts
    "pipeline/serve.py": (
        {"Job.__init__", "Job.info", "ServeCore.__init__",
         "ServeCore._help_fanout",
         "ServeCore._job_main", "ServeCore._run_fanout",
         "ServeCore._run_job", "ServeCore.readiness",
         "_JobRuntime.__init__", "serve_main"},
        {"ServeCore._device_stop", "ServeMetrics", "ServeMetrics.snapshot",
         "from ccsx_tpu.utils.run_metrics import PORT_KEYS",
         "from ccsx_tpu.utils.run_metrics import RunMetrics"},
        set(), None),
    # the supervisor: an empty runner prelude (the children take their
    # device from their argv; nothing of JAX to pin), and shepherd_main's
    # --rank-stall-timeout help (sized above a CUDA child's start-up, and
    # the one answer to a kernel that never ends, which --dispatch-deadline
    # cannot end) and -h (the port's CLI prints its USAGE, rc 1: it has no
    # usage()).
    # The runner and the message prefix differ only in the package name
    # (test_supervisor_runner_names_the_ports_cli)
    "pipeline/supervisor.py": (
        {"default_prelude", "shepherd_main"}, set(), set(), None),
    # the resilience plane: the messages name the port's per-request
    # replay (the per-hole round on the same card) where the JAX package's
    # name its host path.  The code is the JAX package's; only its callers
    # differ (pipeline/batch.py): the port has no 'compile' class — a
    # kernel that does not build or launch ends the run
    # (cuda_ext.KernelError, rc 1) — so no compile strike ever comes
    "pipeline/resilience.py": (
        {"DeadlineExpired.__init__", "CircuitBreaker.strike"}, set(), set(),
        None),
    # the port's lint: its own baseline file (lint_baseline_torch.json)
    # over its own package (PACKAGE_DIR, equal once the package name is
    # normalized); span-force also accepts a CUDA synchronise; the int64
    # promotions include torch's .long(); schema-drift adds RunMetrics'
    # step counters (its PORT_KEYS) to the snapshot's keys.  The other
    # three checkers are copies
    "lint/__init__.py": (set(), set(), set(), None),
    "lint/core.py": ({"BASELINE_NAME"}, set(), set(), None),
    "lint/checks_spans.py": ({"MESSAGE", "_forces"}, set(), set(), None),
    "lint/checks_numeric.py": (
        {"MESSAGE", "MESSAGE_SHIFT", "_has_int64"}, set(), set(), None),
    "lint/checks_schema.py": (
        {"_snapshot_keys", "check_tree"},
        {"_snapshot_method", "_method_keys", "_run_metrics_keys"}, set(),
        None),
    "lint/checks_concurrency.py": (set(), set(), set(), None),
    "lint/checks_crashsafe.py": (set(), set(), set(), None),
}


@pytest.mark.parametrize("mod", list(COPIES))
def test_host_plane_copies_differ_only_where_listed(mod):
    """The copies of the JAX package's native loader, native reader and
    prep pool differ from it only in the listed definitions (beyond the
    package prefix and the docstrings), and each listed one does differ."""
    differ, port_only, jax_only, drop = COPIES[mod]
    port = _top_level(PKG / mod)
    ref = _top_level(ROOT / "ccsx_tpu" / mod, drop)
    assert set(port) - set(ref) == port_only
    assert set(ref) - set(port) == jax_only
    changed = {k for k in set(port) & set(ref) if port[k] != ref[k]}
    assert changed == differ
    if drop:
        raw = _top_level(ROOT / "ccsx_tpu" / mod)
        assert all(raw[k] != ref[k] for k in drop)


def test_supervisor_runner_names_the_ports_cli():
    """The children's runner is the JAX package's with the port's CLI in
    place of the JAX CLI, and nothing else."""
    from ccsx_tpu.pipeline import supervisor as jsupervisor

    from ccsx_tpu_torch.pipeline import supervisor

    assert supervisor._RUNNER == jsupervisor._RUNNER.replace(
        "from ccsx_tpu.cli", "from ccsx_tpu_torch.cli")
    assert "ccsx_tpu_torch.cli" in supervisor._RUNNER


@pytest.mark.parametrize("name", ["count_raw_holes", "slice_raw_holes"])
def test_run_hole_range_helpers_are_copies(name):
    """The fleet plane's raw-hole helpers in pipeline/run.py are the JAX
    package's, definition for definition."""
    port = _top_level(PKG / "pipeline" / "run.py")
    ref = _top_level(ROOT / "ccsx_tpu" / "pipeline" / "run.py")
    assert port[name] == ref[name]


def test_gateway_and_spool_modules_run_without_torch(tmp_path):
    """`python -m ccsx_tpu_torch.cli gateway` (its --help here), the spool
    protocol, the lease primitive and `top` over a spool directory load
    neither torch, jax nor the JAX package: the gateway keeps routing
    while every replica's card is wedged."""
    blocked = FORBIDDEN + ("torch",)
    blocker = _BLOCKER.replace(repr(FORBIDDEN), repr(blocked))
    spool = tmp_path / "spool"
    spool.mkdir()
    code = blocker + (
        "import contextlib, io, runpy\n"
        "from ccsx_tpu_torch.pipeline import gateway\n"
        "from ccsx_tpu_torch.utils import lease, telemetry\n"
        "jid = gateway.submit_job(%r, input_path='/x.fa')\n"
        "assert gateway.job_view(%r, jid)['state'] == 'queued'\n"
        "assert telemetry.expand_sources([%r])[0].endswith('<no-replicas>')\n"
        "sys.argv = ['ccsx_tpu_torch.cli', 'gateway', '--help']\n"
        "buf = io.StringIO()\n"
        "try:\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        runpy.run_module('ccsx_tpu_torch.cli', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code\n"
        "assert '--spool' in buf.getvalue()\n"
        "assert not any(k.split('.')[0] in %r for k in sys.modules)\n"
        "print('ok')\n" % (str(spool), str(spool), str(spool), blocked))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_native_source_is_byte_equal_to_the_jax_packages():
    assert (PKG / "native" / "io_native.cpp").read_bytes() == \
        (ROOT / "ccsx_tpu" / "native" / "io_native.cpp").read_bytes()


def test_native_loader_builds_into_build_atomically(tmp_path, monkeypatch):
    """The loader compiles the source under ccsx_tpu_torch/ into build/
    (never into a package directory, never ccsx_tpu/native/), through a
    temp file and os.replace, so builds racing each other (xdist workers)
    each land a whole library that loads."""
    import ctypes
    import shutil
    import threading

    from ccsx_tpu_torch import native

    assert pathlib.Path(native.SOURCE) == PKG / "native" / "io_native.cpp"
    target = pathlib.Path(native.target())
    assert target.parent == ROOT / "build" / "ccsx_tpu_torch_native"
    assert target.name.startswith("libccsx_io-")
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    out = native.target()
    assert pathlib.Path(out).parent == tmp_path / "b"
    ok = []
    threads = [threading.Thread(target=lambda: ok.append(native._build(out)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if ok != [True, True]:
        pytest.skip(f"the library cannot build here: {native.build_error()}")
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == \
        [pathlib.Path(out).name]
    native._bind(ctypes.CDLL(out))
    for pkg in (PKG / "native", ROOT / "ccsx_tpu" / "native"):
        assert not (pkg / "build.log").exists()
    assert not list((PKG / "native").glob("*.so"))


def test_native_build_failure_is_loud_and_the_python_readers_serve(
        tmp_path, monkeypatch, capsys):
    """A source that does not compile: one loud line on stderr, the
    compiler log under build/, native_build_error in every metrics event,
    and the Python readers serving the stream."""
    from ccsx_tpu_torch import native
    from ccsx_tpu_torch.config import CcsConfig
    from ccsx_tpu_torch.pipeline import run
    from ccsx_tpu_torch.utils.run_metrics import RunMetrics

    bad = tmp_path / "io_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "load_state", {})
    assert not native.available()
    err = capsys.readouterr().err
    assert err.count("[ccsx-tpu-torch] WARNING: native IO rebuild FAILED") \
        == 1
    assert native.build_error() and native.load_state["state"] == "failed"
    assert (tmp_path / "b" / "build.log").read_text()
    assert RunMetrics().snapshot()["native_build_error"] == \
        native.build_error()
    fa = tmp_path / "in.fa"
    fa.write_text("".join(f">m/{h}/{i}\n{'ACGT' * 50}\n"
                          for h in range(2) for i in range(6)))
    holes = list(run.open_zmw_stream(str(fa), CcsConfig(is_bam=False,
                                                        min_subread_len=1)))
    assert [z.hole for z in holes] == ["0", "1"]
