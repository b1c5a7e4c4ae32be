"""The port's lint (ccsx_tpu_torch/lint/) against the JAX package's
(ccsx_tpu/lint/, tests/test_lint.py).

- the port's tree is clean against its own baseline
  (lint_baseline_torch.json), in a subprocess that imports neither torch
  nor jax; the baseline is valid and not stale;
- each checker flags its fixture in tests/lint_fixtures, and passes its
  minimal-fix sibling, through both packages' lints alike;
- the torch-spelled fixtures (tests/lint_fixtures_torch: ``Span.force`` or
  a CUDA synchronise in a device span, ``.long()`` and ``.to(torch.int64)``
  promotions, ``RunMetrics``' step counters) pass or flag through the
  port's lint as their names say, where the JAX package's lint, which
  knows only the JAX spellings, flags the fixed ones;
- ``lint --json`` gives the JAX CLI's rc and format on the same fixture
  tree (the same findings; only the messages name torch's idioms);
- the suppression machinery (pragma, baseline by line text, stale
  entries, a reason for every entry) in the port's copy.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from ccsx_tpu import cli as jcli
from ccsx_tpu.lint import checks_schema as jchecks_schema
from ccsx_tpu.lint import core as jcore

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.lint import checks_schema, core
from ccsx_tpu_torch.lint.core import Finding

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "lint_fixtures"
TORCH_FIXTURES = Path(__file__).parent / "lint_fixtures_torch"
LINTS = {"jax": (jcore, jchecks_schema), "port": (core, checks_schema)}


def _lint(mod, root, relfile, check):
    findings, _ = mod.lint_file(root / relfile, relfile)
    return [f for f in findings if f.check == check]


# ---- the port's tree is clean (and the linter loads no torch) --------------


def test_tree_clean_no_torch_or_jax_subprocess():
    code = (
        "import sys\n"
        "from ccsx_tpu_torch.lint.core import lint_main\n"
        "rc = lint_main([])\n"
        "assert 'torch' not in sys.modules, 'linter imported torch'\n"
        "assert 'jax' not in sys.modules, 'linter imported jax'\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (
        f"unsuppressed lint findings (or a torch/jax import) — fix them or "
        f"baseline with a justification:\n{proc.stdout}{proc.stderr}")
    assert "0 finding(s)" in proc.stdout


def test_committed_baseline_valid_and_not_stale():
    assert core.BASELINE_NAME == "lint_baseline_torch.json"
    assert core.BASELINE_NAME != jcore.BASELINE_NAME
    entries = core.load_baseline(ROOT / core.BASELINE_NAME)
    assert entries, "the port's baseline is missing or empty"
    assert all(e["file"].startswith("ccsx_tpu_torch/") for e in entries)
    res = core.run_lint(ROOT, baseline=entries)
    assert res.clean, [f.format() for f in res.findings]
    assert not res.stale_baseline, (
        f"baseline entries that no longer match anything — delete them: "
        f"{res.stale_baseline}")
    assert res.files_scanned == len(list(
        (ROOT / "ccsx_tpu_torch").rglob("*.py")))


def test_real_tree_schema_contract():
    """Every RunMetrics key (the JAX package's and the port's step
    counters) reaches /metrics, and every consumed key is emitted."""
    found = list(checks_schema.check_tree(ROOT / "ccsx_tpu_torch",
                                          "ccsx_tpu_torch/"))
    assert found == [], [f.format() for f in found]


# ---- the JAX fixture corpus through both lints ------------------------------

CORPUS = [
    ("ops/overflow_bad.py", "int32-overflow", 3),
    ("ops/overflow_ok.py", "int32-overflow", 0),
    ("crashsafe/lease.py", "bare-write", 2),
    ("crashsafe/spool_writer_bad.py", "bare-write", 1),
    ("crashsafe_ok/lease.py", "bare-write", 0),
    ("concurrency/metrics_bad.py", "metrics-lock", 2),
    ("concurrency/metrics_bad.py", "contextvar-restore", 1),
    ("concurrency/metrics_ok.py", "metrics-lock", 0),
    ("concurrency/metrics_ok.py", "contextvar-restore", 0),
    ("spans/span_bad.py", "span-force", 1),
    ("spans/span_ok.py", "span-force", 0),
]


@pytest.mark.parametrize("lint", list(LINTS))
@pytest.mark.parametrize("relfile,check,expected", CORPUS)
def test_fixture_corpus(lint, relfile, check, expected):
    findings = _lint(LINTS[lint][0], FIXTURES, relfile, check)
    assert len(findings) == expected, [f.format() for f in findings]


def test_both_lints_find_the_same_on_the_jax_fixtures():
    """Same checks, files, lines and columns; only the messages differ."""
    def key(res):
        return [(f.check, f.path, f.line, f.col, f.text)
                for f in res.findings]

    assert key(core.run_lint(FIXTURES)) == key(jcore.run_lint(FIXTURES))


@pytest.mark.parametrize("lint", list(LINTS))
def test_schema_fixture_both_directions(lint):
    mod = LINTS[lint][1]
    bad = list(mod.check_tree(FIXTURES / "schema_bad"))
    msgs = " | ".join(f.message for f in bad)
    assert len(bad) == 2, [f.format() for f in bad]
    assert "missing_key" in msgs and "orphan_key" in msgs
    assert mod.check_tree(FIXTURES / "schema_ok") == []


# ---- the torch-spelled fixtures ----------------------------------------------

# (fixture, check, the port's findings, the JAX package's findings)
TORCH_CORPUS = [
    ("spans/span_ok.py", "span-force", 0, 2),
    ("spans/span_bad.py", "span-force", 1, 1),
    ("ops/overflow_ok.py", "int32-overflow", 0, 2),
    ("ops/overflow_bad.py", "int32-overflow", 2, 2),
]


@pytest.mark.parametrize("relfile,check,port_n,jax_n", TORCH_CORPUS)
def test_torch_fixture_corpus(relfile, check, port_n, jax_n):
    port = _lint(core, TORCH_FIXTURES, relfile, check)
    assert len(port) == port_n, [f.format() for f in port]
    # the JAX package's lint knows only jax.block_until_ready and
    # astype(jnp.int64): the torch spellings of the fixes flag there
    assert len(_lint(jcore, TORCH_FIXTURES, relfile, check)) == jax_n


def test_torch_schema_fixture_reads_run_metrics():
    """The port's snapshot includes RunMetrics' PORT_KEYS: exported ones
    are fine, an unexported one flags at run_metrics.py; the JAX package's
    checker, which reads Metrics alone, calls the exported step counter a
    key no snapshot emits."""
    assert checks_schema.check_tree(TORCH_FIXTURES / "schema_ok") == []
    bad = list(checks_schema.check_tree(TORCH_FIXTURES / "schema_bad"))
    assert [(f.path, "orphan_step" in f.message) for f in bad] == [
        ("utils/run_metrics.py", True)]
    jbad = list(jchecks_schema.check_tree(TORCH_FIXTURES / "schema_bad"))
    assert len(jbad) == 1 and "'slabs'" in jbad[0].message


# ---- the CLI surface ---------------------------------------------------------


def test_cli_lint_json_equals_the_jax_clis(capsys):
    argv = ["lint", "--json", "--no-baseline", "--root", str(FIXTURES)]
    rc = cli.main(argv)
    port = json.loads(capsys.readouterr().out)
    jrc = jcli.main(argv)
    ref = json.loads(capsys.readouterr().out)
    assert rc == jrc == 1
    assert port.keys() == ref.keys()

    def strip(d):
        return {**d, "findings": [{k: v for k, v in f.items()
                                   if k != "message"}
                                  for f in d["findings"]]}

    assert strip(port) == strip(ref)
    assert port["counts"]["span-force"] == 1


def test_cli_lint_text_and_gauge(tmp_path, capsys):
    gauge = tmp_path / "lint_gauge.json"
    assert cli.main(["lint", "--gauge-file", str(gauge),
                     "--root", str(ROOT)]) == 0
    out = capsys.readouterr().out
    assert out.startswith("ccsx-lint: 0 finding(s)")
    assert json.loads(gauge.read_text()) == {"lint_findings": 0}
    assert "lint" in cli.USAGE


# ---- the suppression machinery ------------------------------------------------


def test_pragma_suppresses_only_named_check(tmp_path):
    src = (
        "import contextvars\n"
        "_v = contextvars.ContextVar('v')\n\n\n"
        "def set_only(x):\n"
        "    _v.set(x)  # lint: ok[contextvar-restore] fixture pragma\n\n\n"
        "def set_wrong_id(x):\n"
        "    _v.set(x)  # lint: ok[span-force] wrong id\n"
    )
    p = tmp_path / "mod.py"
    p.write_text(src)
    findings, pragma_n = core.lint_file(p, "mod.py")
    assert pragma_n == 1
    assert [f.line for f in findings
            if f.check == "contextvar-restore"] == [10]


def test_baseline_matches_by_line_text_and_reports_stale(tmp_path):
    f1 = Finding("metrics-lock", "a.py", 3, 0, "m", "metrics.x += 1")
    f2 = Finding("metrics-lock", "a.py", 9, 0, "m", "metrics.y += 1")
    entries = [
        {"check": "metrics-lock", "file": "a.py",
         "match": "metrics.x += 1", "reason": "single writer"},
        {"check": "metrics-lock", "file": "gone.py",
         "match": "metrics.z += 1", "reason": "stale"},
    ]
    kept, n, stale = core.apply_baseline([f1, f2], entries)
    assert kept == [f2] and n == 1
    assert [e["file"] for e in stale] == ["gone.py"]
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"entries": [
        {"check": "bare-write", "file": "x.py", "match": "open(p)",
         "reason": " "}]}))
    with pytest.raises(ValueError):
        core.load_baseline(p)
