"""The port's graceful drain (ccsx_tpu_torch/utils/drain.py), its ingest
guard with salvage (pipeline/run.guarded_stream, ``--salvage``,
``--max-record-bytes``), its disk-full path and its ``--bam`` writer, against
the JAX package's.

The JAX package's cases of the same names (tests/test_salvage.py: the
record-size bound without salvage, salvage over a clean and a corrupt
input, corrupt holes spending the failure budget, SIGTERM drain and
resume in both drivers, the drain guard's signals, ENOSPC and resume, a
failed journal settle), run on the port's CLI with ``--device cpu``.  One
module-scoped JAX CLI process on the CPU gives the reference: its bytes
and final counters under ``--salvage`` on the clean input, on injected
corruption, on a FASTA with a bad hole name, on a BAM with a damaged BGZF
block and on a gzipped FASTQ cut short, which the port must give too; and
its ``--bam`` output.  Bytes and counters: exact equality.
"""

import gzip
import hashlib
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from ccsx_tpu import cli as jcli

from ccsx_tpu_torch import cli, exitcodes, native
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.io import bam as bam_mod
from ccsx_tpu_torch.ops import encode as enc
from ccsx_tpu_torch.utils import faultinject, synth
from ccsx_tpu_torch.utils.drain import DrainGuard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ["-m", "1000", "--device", "cpu"]
# counters both packages keep alike under --salvage
SAME = ("holes_in", "holes_out", "holes_failed", "holes_filtered",
        "holes_corrupt", "corrupt_reasons", "degraded")

# runs the JAX CLI once per argv list (JSON in argv[1]) in one process,
# disarmed before each; prints the rcs
JAX_RUNNER = """
import json, sys
import jax
jax.config.update('jax_platforms', 'cpu')
from ccsx_tpu.cli import main
from ccsx_tpu.utils import faultinject
rcs = []
for argv in json.loads(sys.argv[1]):
    faultinject.disarm()
    rcs.append(main(argv))
print(json.dumps(rcs))
"""


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.disarm()
    yield
    faultinject.disarm()


def _final(path):
    events = [json.loads(line) for line in open(path) if line.strip()]
    assert events[-1]["event"] == "final"
    return events[-1]


def _by_hole(b: bytes) -> dict:
    return {c.split("\n", 1)[0]: c for c in b.decode().split(">")[1:]}


# the salvage cases: name -> (input key, extra flags); each runs through
# both CLIs under --salvage --metrics
CASES = {
    "clean": ("fa", []),
    "injected": ("fa", ["--inject-faults", "input_corrupt@2"]),
    "bad_name": ("bad", []),
    "bam_block": ("bam", []),
    # every byte zlib inflates before the cut reaches the parser
    "gzip_cut": ("gz", []),
}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """3 holes of 500-bp templates as FASTA, the same FASTA with hole
    101's name broken, a BAM of the same holes in small BGZF blocks with one
    block's deflate stream damaged, and the holes with a fourth as a FASTQ
    gzipped whole and cut to its first 2,231 of 3,347 bytes; the JAX
    package's output (fail-fast, each CASES run under --salvage --metrics,
    and --bam) from one JAX CLI process."""
    d = tmp_path_factory.mktemp("salvage")
    rng = np.random.default_rng(0)
    zs = [synth.make_zmw(rng, template_len=500, n_passes=5, movie="mv",
                         hole=str(100 + h)) for h in range(4)]
    paths = {"fa": d / "in.fa", "bad": d / "bad.fa", "bam": d / "in.bam",
             "gz": d / "cut.fq.gz"}
    fq = "".join(f"@{n}\n{enc.decode(p)}\n+\n{'I' * len(p)}\n"
                 for z in zs for n, p in zip(z.names, z.passes)).encode()
    blob = gzip.compress(fq)
    assert len(blob) == 3347
    paths["gz"].write_bytes(blob[:2231])
    zs = zs[:3]
    paths["fa"].write_text(synth.make_fasta(zs))
    data = paths["fa"].read_bytes()
    i = data.find(b">mv/101/")
    paths["bad"].write_bytes(data[:i] + data[i:].replace(b"/", b"x", 2))
    recs = [(name, enc.decode(p).encode(), None)
            for z in zs for name, p in zip(z.names, z.passes)]
    # ~2 kB blocks, so one damaged block costs one or two holes
    payload = bam_mod.BGZF_BLOCK_PAYLOAD
    bam_mod.BGZF_BLOCK_PAYLOAD = 2048
    try:
        bam_mod.write_bam(str(paths["bam"]), recs, bgzf=True)
    finally:
        bam_mod.BGZF_BLOCK_PAYLOAD = payload
    raw = bytearray(paths["bam"].read_bytes())
    starts, off = [], 0
    while off < len(raw):
        starts.append(off)
        off += int.from_bytes(raw[off + 16:off + 18], "little") + 1
    assert len(starts) >= 6
    raw[starts[3] + 30] ^= 0xFF      # inside block 3's deflate data
    paths["bam"].write_bytes(bytes(raw))
    argvs = [["-A", "-m", "1000", "--batch", "on", str(paths["fa"]),
              str(d / "jax_ref.fa")],
             ["-m", "1000", "--batch", "on", str(paths["bam"]),
              str(d / "jax_bam_failfast.fa")],
             ["-A", "-m", "1000", "--batch", "on", "--metrics",
              str(d / "jax_gz_failfast.jsonl"), str(paths["gz"]),
              str(d / "jax_gz_failfast.fa")],
             ["-A", "-m", "1000", "--batch", "on", "--bam",
              str(paths["fa"]), str(d / "jax.bam")]]
    for name, (key, flags) in CASES.items():
        argvs.append((["-A"] if key != "bam" else []) + [
            "-m", "1000", "--batch", "on", "--salvage", *flags,
            "--metrics", str(d / f"jax_{name}.jsonl"), str(paths[key]),
            str(d / f"jax_{name}.fa")])
    env = dict(os.environ, JAX_PLATFORMS="cpu", CCSX_SKIP_PROBE="1",
               XLA_FLAGS="", PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", JAX_RUNNER, json.dumps(argvs)],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    rcs = json.loads(r.stdout.strip().splitlines()[-1])
    assert rcs[0] == rcs[3] == 0 and rcs[4:] == [0] * len(CASES)
    return {"dir": d, "paths": paths, "bytes": (d / "jax_ref.fa").read_bytes(),
            "bam_failfast_rc": rcs[1], "gz_failfast_rc": rcs[2]}


# ---- the record-size bound --------------------------------------------------


def test_max_record_bytes_applies_without_salvage(tmp_path):
    seq = b"ACGT" * 4000   # 16 kB record > the 8 kB bound
    recs = [(f"mv/1/{i}_{i + 80}", seq, b"I" * len(seq)) for i in range(6)]
    p = tmp_path / "t.bam"
    bam_mod.write_bam(str(p), recs, bgzf=True)
    cfg = CcsConfig(min_subread_len=1, is_bam=True, max_record_bytes=8192)
    with pytest.raises(bam_mod.BamError) as ei:
        list(bam_mod.read_bam_records(
            str(p), max_record_bytes=cfg.max_record_bytes))
    assert ei.value.reason == "bam_record_oversize"


def test_max_record_bytes_bound_refused_like_the_jax_cli(tmp_path, capsys):
    args = ["--max-record-bytes", "100", "x.bam", str(tmp_path / "y.fa")]
    assert cli.main(args) == 1
    port_err = capsys.readouterr().err
    assert jcli.main(args) == 1
    assert port_err == capsys.readouterr().err
    assert "--max-record-bytes must be >= 4096" in port_err


# ---- salvage through the CLI ------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_salvage_equals_the_jax_package(name, ref, tmp_path):
    """--salvage on a clean input is byte-identical to fail-fast; on
    injected corruption, a bad hole name or a damaged BGZF block it drops
    the damaged holes only, marked degraded — with the JAX package's
    bytes and counters in every case."""
    key, flags = CASES[name]
    if key == "gz" and not native.available():
        pytest.skip("the native reader (the JAX CLI's) is unavailable: "
                    f"{native.build_error()}")
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    argv = (["-A"] if key != "bam" else []) + PORT + [
        "--batch", "on", "--salvage", *flags, "--metrics", str(m),
        str(ref["paths"][key]), str(out)]
    assert cli.main(argv) == exitcodes.RC_OK
    d = ref["dir"]
    assert out.read_bytes() == (d / f"jax_{name}.fa").read_bytes()
    port, jax = _final(m), _final(d / f"jax_{name}.jsonl")
    # corrupt_reasons and degraded are in an event only once set
    assert {k: port.get(k) for k in SAME} == {k: jax.get(k) for k in SAME}
    want = {"clean": {}, "injected": {"injected": 1},
            "bad_name": {"zmw_bad_name": 1}}
    if name in want:
        assert port.get("corrupt_reasons", {}) == want[name]
        r, s = _by_hole(ref["bytes"]), _by_hole(out.read_bytes())
        lost = set(r) - set(s)
        assert lost == (set() if name == "clean" else {"mv/101/ccs"})
        assert all(s[k] == r[k] for k in s)
    else:
        assert port["holes_corrupt"] >= 1 and port["degraded"]
        assert 0 < port["holes_out"] < 3
    if key == "gz":
        # zlib inflates 12,610 bytes before the cut: holes 100 and 101 are
        # whole, 102 is the partial tail both readers drop
        b = out.read_bytes()
        assert list(_by_hole(b)) == ["mv/100/ccs", "mv/101/ccs"]
        assert hashlib.md5(b).hexdigest().startswith("2feaead356")
        assert port["holes_in"] == 2
        assert port["corrupt_reasons"] == {"gzip_truncated": 1}


def test_corrupt_input_fails_fast_without_salvage(ref, tmp_path, capsys):
    """Without --salvage each damaged input ends the run at rc 1 through
    the invalid-input path, no traceback — as the JAX package's does on
    the damaged BAM."""
    for key, flags in (("fa", ["--inject-faults", "input_corrupt@2"]),
                       ("bad", []), ("bam", [])):
        faultinject.disarm()
        argv = (["-A"] if key != "bam" else []) + PORT + [
            "--batch", "on", *flags, str(ref["paths"][key]),
            str(tmp_path / f"{key}.fa")]
        assert cli.main(argv) == exitcodes.RC_FATAL, key
        err = capsys.readouterr().err
        assert "Traceback" not in err
        assert "invalid input stream" in err
    assert ref["bam_failfast_rc"] == exitcodes.RC_FATAL


def test_truncated_gzip_fails_fast_after_the_jax_clis_holes(ref, tmp_path,
                                                           capsys):
    """Without --salvage the cut gzip FASTQ ends the run at rc 1 with no
    output, after admitting as many holes as the JAX CLI (2: the native
    reader hands out every byte zlib inflates before the cut)."""
    if not native.available():
        pytest.skip(f"native library unavailable: {native.build_error()}")
    out, m = tmp_path / "o.fa", tmp_path / "m.jsonl"
    rc = cli.main(["-A"] + PORT + ["--batch", "on", "--metrics", str(m),
                                   str(ref["paths"]["gz"]), str(out)])
    assert rc == ref["gz_failfast_rc"] == exitcodes.RC_FATAL
    assert "invalid input stream" in capsys.readouterr().err
    assert out.read_bytes() == b""
    jax = _final(ref["dir"] / "jax_gz_failfast.jsonl")
    assert _final(m)["holes_in"] == jax["holes_in"] == 2


def test_stream_error_past_the_first_window_writes_fixed_holes(
        ref, tmp_path, capsys):
    """With the prep pool, a stream error lets the driver write exactly the
    holes more than the first window before it, whatever the threads'
    timing: --inflight 1 and an ingest fault at the third hole write hole
    100 and nothing after it, in every run, under a switch interval short
    enough to shuffle the pool's four threads and the driver."""
    want = _by_hole(ref["bytes"])["mv/100/ccs"].encode()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for k in range(3):
            faultinject.disarm()
            out, m = tmp_path / f"o{k}.fa", tmp_path / f"m{k}.jsonl"
            rc = cli.main(["-A"] + PORT + [
                "--batch", "on", "--prep-threads", "4", "--inflight", "1",
                "--inject-faults", "ingest@3", "--metrics", str(m),
                str(ref["paths"]["fa"]), str(out)])
            assert rc == exitcodes.RC_FATAL
            assert "invalid input stream" in capsys.readouterr().err
            assert out.read_bytes() == b">" + want
            assert _final(m)["holes_in"] == 2
    finally:
        sys.setswitchinterval(interval)


def test_corrupt_holes_spend_failure_budget(ref, tmp_path):
    rc = cli.main(["-A"] + PORT + [
        "--batch", "on", "--salvage", "--max-failed-holes", "0",
        "--inject-faults", "input_corrupt@2", str(ref["paths"]["fa"]),
        str(tmp_path / "o.fa")])
    assert rc == exitcodes.RC_FAILED_HOLES


# ---- graceful drain ---------------------------------------------------------


@pytest.mark.parametrize("batch_arg,spec,extra", [
    # a pinned window of one hole and inline prep: admission genuinely
    # stops early (the prep pool would have ingested every hole ahead)
    ("on", "sigterm@1", ["--inflight", "1", "--prep-threads", "0"]),
    ("off", "sigterm@2", []),
])
def test_sigterm_drain_then_resume_byte_identical(batch_arg, spec, extra,
                                                  ref, tmp_path,
                                                  monkeypatch, capsys):
    """SIGTERM at a retirement point: rc 75, a consistent and partial
    journal, and a resume with the same command to the JAX package's
    bytes."""
    out, jp = tmp_path / "o.fa", tmp_path / "j.json"
    monkeypatch.setenv("CCSX_JOURNAL_FSYNC_S", "0")
    args = ["-A"] + PORT + ["--batch", batch_arg, *extra, "--journal",
                            str(jp), str(ref["paths"]["fa"]), str(out)]
    faultinject.arm(spec)
    rc = cli.main(args)
    faultinject.disarm()
    assert rc == exitcodes.RC_INTERRUPTED == 75
    assert "drained cleanly" in capsys.readouterr().err
    j = json.loads(jp.read_text())
    assert 0 < j["holes_done"] < 3, "the drain should leave work behind"
    assert cli.main(args) == 0
    assert out.read_bytes() == ref["bytes"]


def test_drain_guard_sigint_and_restore():
    before = signal.getsignal(signal.SIGINT)
    g = DrainGuard.install()
    try:
        signal.raise_signal(signal.SIGINT)   # handler, no KeyboardInterrupt
        assert g.requested
    finally:
        g.restore()
    assert signal.getsignal(signal.SIGINT) is before


def test_drain_guard_second_signal_restores():
    before = signal.getsignal(signal.SIGTERM)
    g = DrainGuard.install()
    try:
        signal.raise_signal(signal.SIGTERM)
        assert g.requested
        signal.raise_signal(signal.SIGTERM)  # restores previous handlers
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        g.restore()


def test_drain_guard_noop_off_main_thread():
    res = {}

    def t():
        res["g"] = DrainGuard.install()

    th = threading.Thread(target=t)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    assert res["g"].requested is False
    res["g"].restore()   # no-op, must not raise


# ---- disk full --------------------------------------------------------------


@pytest.mark.parametrize("batch_arg", ["on", "off"])
def test_enospc_clean_rc1_then_resume(batch_arg, ref, tmp_path, monkeypatch,
                                      capsys):
    """ENOSPC at the writer: clean rc 1 (no traceback), the journal never
    claims the unwritten record, and the resume gives the JAX package's
    bytes."""
    out, jp = tmp_path / "o.fa", tmp_path / "j.json"
    monkeypatch.setenv("CCSX_JOURNAL_FSYNC_S", "0")
    args = ["-A"] + PORT + ["--batch", batch_arg, "--journal", str(jp),
                            str(ref["paths"]["fa"]), str(out)]
    faultinject.arm("disk_full@2")
    rc = cli.main(args)
    faultinject.disarm()
    err = capsys.readouterr().err
    assert rc == exitcodes.RC_FATAL
    assert "No space left on device" in err
    assert "Traceback" not in err
    j = json.loads(jp.read_text())
    assert j["holes_done"] == 1
    # the journaled offset points at durable bytes only
    assert j["out_bytes"] == out.stat().st_size
    assert cli.main(args) == 0
    assert out.read_bytes() == ref["bytes"]


# ---- --bam ------------------------------------------------------------------


def test_bam_output_equals_the_jax_cli(ref, tmp_path):
    """--bam: the JAX CLI's bytes; read back, the records are the FASTA
    run's names and sequences, each with an rq in (0.8, 1]."""
    out = tmp_path / "o.bam"
    assert cli.main(["-A"] + PORT + ["--batch", "on", "--bam",
                                     str(ref["paths"]["fa"]), str(out)]) == 0
    assert out.read_bytes() == (ref["dir"] / "jax.bam").read_bytes()
    recs = list(bam_mod.read_bam_records(str(out), with_aux=True))
    want = {k: "".join(v.split("\n")[1:]).encode()
            for k, v in _by_hole(ref["bytes"]).items()}
    assert {r.name: r.seq for r, _ in recs} == want
    assert all(0.8 < aux["rq"][1] <= 1.0 for _, aux in recs)


@pytest.mark.parametrize("case", ["fastq", "journal", "stdout"])
def test_bam_refusals_match_the_jax_cli(case, ref, tmp_path, capsys):
    """--bam with --fastq, with --journal, and to stdout: rc 1 and the
    JAX CLI's message."""
    extra = {"fastq": ["--fastq"], "journal": ["--journal",
                                              str(tmp_path / "j.json")],
             "stdout": []}[case]
    out = "-" if case == "stdout" else str(tmp_path / "o.bam")
    args = ["-A", "-m", "1000", "--batch", "on", "--device", "cpu", "--bam",
            *extra, str(ref["paths"]["fa"]), out]
    rcs, lines = [], []
    for main in (cli.main, jcli.main):
        rcs.append(main(args))
        lines.append([ln for ln in capsys.readouterr().err.splitlines()
                      if "--bam" in ln])
    assert rcs == [1, 1]
    assert lines[0] == lines[1] and len(lines[0]) == 1
