"""The port's resume journal (ccsx_tpu_torch/utils/journal.py) and the
fingerprints it is keyed by (utils/fingerprint.py), against the JAX
package's.

The JAX package's cases of the same names (tests/test_faults.py: a v1
journal, a kill between the write and the journal, a kill inside the
journal's replace, a torn partial record, an output behind its journal, a
fingerprint mismatch; tests/test_resilience.py: the failure budget across
a resume), run on the port's CLI with ``--device cpu``; the hard kills run
in a process of their own.  Every resume must give the JAX package's bytes:
one module-scoped JAX CLI process on the CPU gives them, with a journal the
port must refuse (its code fingerprint hashes other sources) and recompute
from.  ``config_fingerprint`` is equal in both packages; the port's
``code_fingerprint`` also covers the CUDA sources.  Bytes and fingerprints:
exact equality.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ccsx_tpu.config import CcsConfig as JCcsConfig
from ccsx_tpu.utils import fingerprint as jfp

from ccsx_tpu_torch import cli, exitcodes
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.utils import faultinject, fingerprint, synth
from ccsx_tpu_torch.utils.journal import Journal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ccsx_tpu_torch")
PORT = ["-A", "-m", "1000", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.disarm()
    yield
    faultinject.disarm()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """3 holes of 500-bp templates; the JAX package's batched output and
    journal on them (a JAX CLI process on the CPU)."""
    d = tmp_path_factory.mktemp("journal")
    rng = np.random.default_rng(0)
    zs = [synth.make_zmw(rng, template_len=500, n_passes=5, movie="mv",
                         hole=str(100 + h)) for h in range(3)]
    fa = d / "in.fa"
    fa.write_text(synth.make_fasta(zs))
    out, jp = d / "jax.fa", d / "jax_journal.json"
    runner = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
              "from ccsx_tpu.cli import main; sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, JAX_PLATFORMS="cpu", CCSX_SKIP_PROBE="1",
               XLA_FLAGS="", PYTHONPATH=ROOT, CCSX_JOURNAL_FSYNC_S="0")
    r = subprocess.run([sys.executable, "-c", runner, "-A", "-m", "1000",
                        "--batch", "on", "--journal", str(jp), str(fa),
                        str(out)], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return {"fa": fa, "bytes": out.read_bytes(),
            "journal": json.loads(jp.read_text())}


def _records(b: bytes) -> list:
    return [">" + c for c in b.decode().split(">")[1:]]


def _run_port_subprocess(args, env_extra):
    """The port's CLI in a process of its own (the write/journal/rank_death
    faults os._exit)."""
    runner = ("import sys; from ccsx_tpu_torch.cli import main; "
              "sys.exit(main(sys.argv[1:]))")
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    return subprocess.run([sys.executable, "-c", runner, *args], env=env,
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


# ---- the journal ------------------------------------------------------------


def test_journal_v1_still_accepted(tmp_path):
    jp = tmp_path / "j.json"
    jp.write_text(json.dumps({"input_id": "in.fa", "holes_done": 5}))
    j = Journal.load_or_create(str(jp), input_id="in.fa",
                               fingerprint="abc-def")
    assert j.holes_done == 5 and j.out_bytes is None
    out = tmp_path / "o.fa"
    out.write_text("anything\n")
    j.verify_output(str(out))  # no offsets recorded: must be a no-op
    assert j.holes_done == 5
    assert out.read_text() == "anything\n"


@pytest.mark.parametrize("point,done,torn", [
    # the torn-tail kill: record 2 hit the disk, the journal never saw it
    ("write", 1, True),
    # a kill between the fsynced tmp journal and the atomic replace: the
    # OLD journal stays intact
    ("journal", 1, True),
    # a hard kill after hole 2 retired: journal and file agree
    ("rank_death", 2, False),
])
def test_kill_then_resume(point, done, torn, ref, tmp_path):
    """A hard kill (rc 57) at a retirement point of the batched driver;
    the resume (same command, no faults) truncates any torn tail,
    recomputes the interrupted hole and ends with the JAX package's bytes
    — no duplicated, no dropped hole."""
    out, jp = tmp_path / "o.fa", tmp_path / "j.json"
    args = PORT + ["--batch", "on", "--journal", str(jp), str(ref["fa"]),
                   str(out)]
    # CCSX_JOURNAL_FSYNC_S=0: every advance hits the disk, so the killed
    # journal's cursor is deterministic
    r = _run_port_subprocess(args, {"CCSX_FAULTS": f"{point}@2",
                                    "CCSX_JOURNAL_FSYNC_S": "0"})
    assert r.returncode == exitcodes.RC_INJECTED_KILL == 57, r.stderr
    j = json.loads(jp.read_text())
    assert j["version"] == 2 and j["holes_done"] == done
    assert (os.path.getsize(out) > j["out_bytes"]) == torn
    assert len(_records(out.read_bytes())) == 2
    assert cli.main(args) == 0  # resume, no faults
    assert out.read_bytes() == ref["bytes"]
    assert json.loads(jp.read_text())["holes_done"] == 3


def test_torn_partial_record_tail_truncated(ref, tmp_path, capsys):
    recs = _records(ref["bytes"])
    out = tmp_path / "o.fa"
    out.write_text(recs[0] + recs[1][: len(recs[1]) // 2])  # torn rec 2
    jp = tmp_path / "j.json"
    jp.write_text(json.dumps({"version": 2, "input_id": str(ref["fa"]),
                              "holes_done": 1,
                              "out_bytes": len(recs[0])}))
    assert cli.main(PORT + ["--batch", "on", "--journal", str(jp),
                            str(ref["fa"]), str(out)]) == 0
    assert "truncating torn tail" in capsys.readouterr().err
    assert out.read_bytes() == ref["bytes"]


def test_output_behind_journal_refuses_resume(ref, tmp_path, capsys):
    recs = _records(ref["bytes"])
    out = tmp_path / "o.fa"
    out.write_text(recs[0])
    jp = tmp_path / "j.json"
    jp.write_text(json.dumps({"version": 2, "input_id": str(ref["fa"]),
                              "holes_done": 2,
                              "out_bytes": len(recs[0]) + len(recs[1])}))
    assert cli.main(PORT + ["--batch", "on", "--journal", str(jp),
                            str(ref["fa"]), str(out)]) == 0
    assert "refusing to resume" in capsys.readouterr().err
    assert out.read_bytes() == ref["bytes"]


def test_fingerprint_mismatch_refuses_resume(ref, tmp_path, capsys):
    recs = _records(ref["bytes"])
    out = tmp_path / "o.fa"
    out.write_text(recs[0])
    jp = tmp_path / "j.json"
    jp.write_text(json.dumps({"version": 2, "input_id": str(ref["fa"]),
                              "holes_done": 1, "out_bytes": len(recs[0]),
                              "fingerprint": "stale-code-stale-cfg"}))
    assert cli.main(PORT + ["--batch", "on", "--journal", str(jp),
                            str(ref["fa"]), str(out)]) == 0
    assert "fingerprint mismatch" in capsys.readouterr().err
    assert out.read_bytes() == ref["bytes"]
    assert json.loads(jp.read_text())["fingerprint"] != \
        "stale-code-stale-cfg"


def test_the_jax_packages_journal_is_refused(ref, tmp_path, capsys):
    """A journal the JAX package cut on the same input and config: its
    config half matches, its code half does not, so the port recomputes
    from scratch, to the JAX package's bytes."""
    recs = _records(ref["bytes"])
    out = tmp_path / "o.fa"
    out.write_text(recs[0])
    jp = tmp_path / "j.json"
    jp.write_text(json.dumps(ref["journal"]))
    port_fp = fingerprint.run_fingerprint(
        cli.config_from_args(cli.build_parser().parse_args(
            PORT + [str(ref["fa"]), str(out)])))
    j_code, j_cfg = ref["journal"]["fingerprint"].split("-")
    assert port_fp.split("-")[1] == j_cfg
    assert port_fp.split("-")[0] != j_code
    assert cli.main(PORT + ["--batch", "on", "--journal", str(jp),
                            str(ref["fa"]), str(out)]) == 0
    assert "fingerprint mismatch" in capsys.readouterr().err
    assert out.read_bytes() == ref["bytes"]
    j = json.loads(jp.read_text())
    assert j["fingerprint"] == port_fp and j["holes_done"] == 3
    assert j["out_bytes"] == ref["journal"]["out_bytes"]


def test_failure_budget_survives_journal_resume(ref, tmp_path, monkeypatch):
    """Journaled failures are restored on resume: the resume cannot grant
    a fresh --max-failed-holes budget."""
    out, jp = tmp_path / "o.fa", tmp_path / "j.json"
    args = PORT + ["--batch", "on", "--journal", str(jp),
                   "--max-failed-holes", "2", str(ref["fa"]), str(out)]
    monkeypatch.setenv("CCSX_JOURNAL_FSYNC_S", "0")
    faultinject.arm("compute@1+")
    assert cli.main(args) == exitcodes.RC_FAILED_HOLES  # holes 1-2 fail,
    faultinject.disarm()                                 # 3 is over
    assert json.loads(jp.read_text())["holes_failed"] == 2
    faultinject.arm("compute@1+")
    assert cli.main(args) == exitcodes.RC_FAILED_HOLES
    faultinject.disarm()


def test_enospc_in_journal_settle_warns_not_raises(tmp_path, capsys):
    jp = tmp_path / "j.json"
    j = Journal(path=str(jp), input_id="x", fsync_interval_s=3600.0)
    j.advance()          # first advance writes (cold rate limiter)
    j.advance()          # second is rate-limited: pending in memory
    assert j._pending

    def boom():
        raise OSError(28, "No space left on device")

    j._write_disk = boom
    j.close()            # must not raise
    assert "final settle failed" in capsys.readouterr().err


# ---- the fingerprints -------------------------------------------------------


def test_non_semantic_fields_equal_the_jax_package():
    assert fingerprint._NON_SEMANTIC == jfp._NON_SEMANTIC
    assert fingerprint._SRC_DIRS == jfp._SRC_DIRS
    assert {f.name for f in dataclasses.fields(CcsConfig)} == \
        {f.name for f in dataclasses.fields(JCcsConfig)}


@pytest.mark.parametrize("fields", [
    {}, {"min_subread_len": 1000, "is_bam": False},
    {"exclude_holes": frozenset({"7", "3"}), "split_subread": False},
    {"refine_iters": 3, "max_passes": 16, "emit_quality": True},
    {"max_record_bytes": 1 << 20, "window_growth": "grow"},
    # non-semantic fields only: the default's fingerprint
    {"salvage": True, "banded_impl": "rotband", "threads": 4,
     "max_failed_holes": 2.0, "prefilter": False},
])
def test_config_fingerprint_equals_the_jax_package(fields):
    port = fingerprint.config_fingerprint(CcsConfig(**fields))
    assert port == jfp.config_fingerprint(JCcsConfig(**fields))
    if set(fields) <= fingerprint._NON_SEMANTIC:
        assert port == fingerprint.config_fingerprint(CcsConfig())


def test_salvage_knob_is_resume_compatible():
    base = CcsConfig()
    assert fingerprint.run_fingerprint(base) == fingerprint.run_fingerprint(
        dataclasses.replace(base, salvage=True))
    assert fingerprint.run_fingerprint(base) != fingerprint.run_fingerprint(
        dataclasses.replace(base, max_record_bytes=1 << 20))


def _fingerprint_of_tree(pkg_dir, tag):
    """code_fingerprint of a package tree, from its own copy of
    utils/fingerprint.py (the hash reads the tree the module sits in)."""
    spec = importlib.util.spec_from_file_location(
        f"_fp_{tag}", os.path.join(pkg_dir, "utils", "fingerprint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.code_fingerprint()


def test_code_fingerprint_covers_the_cuda_sources(tmp_path):
    """One changed byte of a kernel's source changes the fingerprint (a
    journal cut by another kernel is refused), as does one of a module;
    an unchanged copy of the tree hashes as the tree does."""
    tree = tmp_path / "ccsx_tpu_torch"
    for d in ("consensus", "ops", "pipeline", "csrc", "utils"):
        shutil.copytree(os.path.join(PKG, d), tree / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(PKG, "config.py"), tree / "config.py")
    base = _fingerprint_of_tree(str(tree), "base")
    assert base == fingerprint.code_fingerprint()
    cu = tree / "csrc" / "banded_fill.cu"
    src = cu.read_bytes()
    cu.write_bytes(src[:-1] + bytes([src[-1] ^ 1]))
    assert _fingerprint_of_tree(str(tree), "cu") != base
    cu.write_bytes(src)
    assert _fingerprint_of_tree(str(tree), "back") == base
    (tree / "ops" / "encode.py").write_text(
        (tree / "ops" / "encode.py").read_text() + "\n")
    assert _fingerprint_of_tree(str(tree), "py") != base
