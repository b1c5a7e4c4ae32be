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
            "ccsx_tpu_torch.utils.fingerprint"} <= set(mods)
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
    """`python -m ccsx_tpu_torch.cli stats ...` and `... blackbox ...` run
    with torch, jax and the JAX package unimportable: they read a run's
    files on a host whose card is wedged."""
    from ccsx_tpu_torch.utils import blackbox, trace

    t = str(tmp_path / "t.jsonl")
    tr = trace.Tracer(t)
    with tr.device_span("refine_packed", group="packed:q9", cells=9):
        pass
    tr.close()
    box = blackbox.BlackBox(blackbox.box_path(str(tmp_path), 7))
    box.record({"ev": "begin", "tid": "T", "name": "refine_packed"})
    box.close()
    blocked = FORBIDDEN + ("torch",)
    blocker = _BLOCKER.replace(repr(FORBIDDEN), repr(blocked))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for argv, want in ((["stats", t], "packed:q9"),
                       (["blackbox", str(tmp_path)], "in-flight at death")):
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
