"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference takes nothing from the port.  Module names are compared by their
top-level name, whole: ``ccsx_tpu_torch`` is not ``ccsx_tpu``."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "ccsx_tpu"}


def modules():
    for d, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every module the file imports, statically or by
    a literal importlib.import_module / __import__ call."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", list(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in modules()
             if os.sep + "reference" + os.sep in p],
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_takes_nothing_from_the_port(path):
    names = imported(path)
    assert "ccsx_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_the_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import ccsx_tpu_torch.cli\nfrom ccsx_tpu.io import bam\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert imported(str(p)) == {"ccsx_tpu_torch", "ccsx_tpu", "importlib",
                                "jax"}
