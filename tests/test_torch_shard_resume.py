"""Range-mode sharded runs of the port and a killed rank's resume, against
the JAX CLI's bytes (the round-robin mode and the units are in
tests/test_torch_distributed.py).

On the same six ~600 bp holes as a BAM: ``--make-index`` through the
port's CLI, then two ranks, each reading only its contiguous raw-hole
range, merge to the port's unsharded bytes and the JAX CLI's, under
``--prep-threads 0`` and the default pool; the unsharded run takes its
progress total from the index.  Then rank 1, under ``--journal``, is
killed by ``rank_death`` at its second retirement (in a process of its
own: the fault exits it), the merge refuses the dead shard, and the same
command resumes it to the same merged bytes.
"""

import json
import os
import subprocess
import sys

import pytest

from ccsx_tpu import cli as jcli

from ccsx_tpu_torch import cli, exitcodes
from ccsx_tpu_torch.io import bamindex
from ccsx_tpu_torch.parallel import distributed as dist
from ccsx_tpu_torch.utils import faultinject

from test_torch_distributed import few_threads, make_corpus, run_ranks  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ["-m", "500", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.disarm()
    yield
    faultinject.disarm()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The indexed BAM, the JAX CLI's output and the port's unsharded
    output (both batched), and the port's unsharded final event."""
    d = tmp_path_factory.mktemp("range")
    _, bm = make_corpus(d)
    ref = d / "ref.fa"
    assert jcli.main(["-m", "500", "--batch", "on", "--device", "cpu",
                      "--no-warmup", str(bm), str(ref)]) == 0
    assert cli.main(["--make-index", str(bm), "ignored"]) == 0
    assert bamindex.load_index(str(bm))["n_holes"] == 6
    one, m = d / "one.fa", d / "one.jsonl"
    assert cli.main(PORT + ["--batch", "on", "--metrics", str(m), str(bm),
                            str(one)]) == 0
    final = json.loads(m.read_text().splitlines()[-1])
    return {"bam": bm, "bytes": ref.read_bytes(),
            "one": one.read_bytes(), "final": final}


def test_unsharded_run_takes_its_total_from_the_index(corpus):
    assert corpus["one"] == corpus["bytes"]
    assert corpus["bytes"].count(b"/ccs\n") == 6
    f = corpus["final"]
    assert f["progress"]["total"] == 6 and f["progress"]["pct"] == 100.0


@pytest.mark.parametrize("prep", ["0", "auto"])
def test_range_ranks_merge_to_the_unsharded_bytes(corpus, tmp_path, prep):
    out = tmp_path / "o.fa"
    size = os.path.getsize(corpus["bam"])
    argv = PORT + (["--prep-threads", prep] if prep != "auto" else []) + [
        str(corpus["bam"])]
    finals = run_ranks(argv, out, merge=False)
    assert [open(dist.shard_path(str(out), r) + ".idx").readline()
            for r in range(2)] == ["#mode=range\n"] * 2
    assert cli.main(["--merge-shards", "2", "ignored", str(out)]) == 0
    assert out.read_bytes() == corpus["one"] == corpus["bytes"]
    for f in finals:
        # this rank's raw range is its progress total; it inflates at
        # most the file (one BGZF block here: both ranks read it)
        assert f["progress"]["total"] == 3 and f["holes_out"] == 3
        assert 0 < f["ingest_bytes"] <= size
        assert f["device_dispatches"] > 0


def test_killed_rank_resumes_to_the_same_merge(corpus, tmp_path, capsys):
    out, jp = tmp_path / "o.fa", str(tmp_path / "j.json")
    base = PORT + ["--journal", jp, "--hosts", "2"]
    assert cli.main(base + ["--host-id", "0", str(corpus["bam"]),
                            str(out)]) == 0
    args = base + ["--host-id", "1", str(corpus["bam"]), str(out)]
    runner = ("import sys; from ccsx_tpu_torch.cli import main; "
              "sys.exit(main(sys.argv[1:]))")
    # CCSX_JOURNAL_FSYNC_S=0: every advance reaches the disk, so the
    # killed journal's cursor is deterministic
    env = dict(os.environ, PYTHONPATH=ROOT, CCSX_FAULTS="rank_death@2",
               CCSX_JOURNAL_FSYNC_S="0", OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", runner, *args], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == exitcodes.RC_INJECTED_KILL == 57, r.stderr
    assert not os.path.exists(dist.done_path(str(out), 1))
    assert json.load(open(jp + ".shard1"))["holes_done"] == 2
    assert cli.main(["--merge-shards", "2", "ignored", str(out)]) == 1
    assert "shard1 (died after 2 durable records)" in \
        capsys.readouterr().err
    assert cli.main(args) == 0          # the same command, no fault
    assert json.load(open(jp + ".shard1"))["holes_done"] == 3
    assert cli.main(["--merge-shards", "2", "ignored", str(out)]) == 0
    assert out.read_bytes() == corpus["bytes"]
