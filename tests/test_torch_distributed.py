"""Sharded runs of the port (ccsx_tpu_torch/parallel/distributed.py,
--hosts/--host-id/--merge-shards/--merge-unmarked) against the JAX
package's.

Units: ``shard_stream`` partitions as the JAX one does; ``ShardWriter``
plus ``merge_shards`` on the same records give the JAX merge's bytes, in
round-robin and range mode, FASTA and FASTQ; the merge refuses a shard set
with a dead rank or mixed modes with the JAX message (rc 1 through either
CLI, no traceback), and ``--merge-unmarked`` lets a wholly unmarked set
through.  The CLI refusals (``--hosts`` without ``--host-id``, ``--bam``
or ``--batch off`` with ``--hosts``) exit rc 1 with the JAX CLI's message.

End to end, on one module-scoped corpus of six ~600 bp holes: two ranks
run one after the other in this process (a rank's share is a pure
function of its rank, so this is what concurrent ranks compute) and merge
to the port's unsharded bytes and the JAX CLI's, in round-robin mode
(FASTQ input) under ``--prep-threads 0`` and the default pool.  The range
mode (BAM input after ``--make-index``) and a rank killed mid-run are in
tests/test_torch_shard_resume.py.
"""

import json
import os

import numpy as np
import pytest

from ccsx_tpu import cli as jcli
from ccsx_tpu.parallel import distributed as jdist

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.parallel import distributed as dist
from ccsx_tpu_torch.utils import faultinject, synth

PORT = ["-A", "-m", "500", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.disarm()
    yield
    faultinject.disarm()


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CLI runs: the test workers
    share the host's cores, and these small runs gain nothing from more."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_corpus(d, seed=11, n_holes=6, tlen=600):
    """(FASTQ path, BAM path) of the same six holes."""
    from ccsx_tpu_torch.io import bam
    from ccsx_tpu_torch.ops import encode as enc

    rng = np.random.default_rng(seed)
    zs = [synth.make_zmw(rng, tlen, 5 + (h % 3), movie="mv", hole=str(h))
          for h in range(n_holes)]
    recs = [(name, enc.decode(p)) for z in zs
            for name, p in zip(z.names, z.passes)]
    fq = d / "in.fq"
    fq.write_text("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                          for n, s in recs))
    bm = d / "in.bam"
    bam.write_bam(str(bm), [(n, s.encode(), None) for n, s in recs])
    return fq, bm


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The inputs and the JAX CLI's batched output for them."""
    d = tmp_path_factory.mktemp("shards")
    fq, bm = make_corpus(d)
    ref = d / "ref.fa"
    assert jcli.main(["-A", "-m", "500", "--batch", "on", "--device", "cpu",
                      str(fq), str(ref)]) == 0
    assert ref.read_bytes().count(b"/ccs\n") == 6
    return {"fq": fq, "bam": bm, "bytes": ref.read_bytes()}


def run_ranks(argv, out, n=2, merge=True):
    """Each rank of an n-rank run, then (with ``merge``) the merge; the
    ranks' final metrics events."""
    finals = []
    for r in range(n):
        m = f"{out}.m{r}.jsonl"
        assert cli.main(argv[:-1] + ["--hosts", str(n), "--host-id", str(r),
                                     "--metrics", m, argv[-1], str(out)]) \
            == 0
        finals.append(json.loads(open(m).read().splitlines()[-1]))
        assert finals[-1]["event"] == "final"
    if merge:
        assert cli.main(["--merge-shards", str(n), "ignored",
                         str(out)]) == 0
    return finals


# ---- units -----------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shard_stream_partitions_as_jax(n):
    items = list(range(10))
    shards = [list(dist.shard_stream(iter(items), r, n)) for r in range(n)]
    assert shards == [list(jdist.shard_stream(iter(items), r, n))
                      for r in range(n)]
    assert sorted(sum(shards, [])) == items


def _records(rng, k, fastq):
    out = []
    for i in range(k):
        seq = bytes(rng.choice(list(b"ACGT"), int(rng.integers(1, 40))))
        qual = bytes(rng.integers(33, 74, len(seq)).tolist()) if fastq \
            else None
        out.append((f"mv/{i}/ccs", seq, qual))
    return out


def _write_shards(mod, out, recs, n, starts):
    """Round-robin (starts None) or range mode: record k of the stream
    goes to its rank with that rank's local index."""
    for r in range(n):
        w = mod.ShardWriter(str(out), r, n, append=False,
                            start_ordinal=None if starts is None
                            else starts[r])
        if starts is None:
            mine = [(k // n, rec) for k, rec in enumerate(recs)
                    if k % n == r]
        else:
            hi = starts[r + 1] if r + 1 < n else len(recs)
            mine = list(enumerate(recs[starts[r]:hi]))
        for local, (name, seq, qual) in mine:
            w.put_at(local, name, seq, qual)
        w.close()
        mod._write_done_marker(str(out), r, n, len(mine))


@pytest.mark.parametrize("mode", ["rr", "range"])
@pytest.mark.parametrize("fastq", [False, True])
def test_shard_writer_and_merge_give_the_jax_bytes(tmp_path, mode, fastq):
    recs = _records(np.random.default_rng(3), 11, fastq)
    starts = None if mode == "rr" else [0, 4, 7]
    files = {}
    for name, mod in (("port", dist), ("jax", jdist)):
        out = tmp_path / name / "o.fa"
        out.parent.mkdir()
        _write_shards(mod, out, recs, 3, starts)
        files[name] = {p.name: p.read_bytes()
                       for p in sorted(out.parent.iterdir())}
        assert mod.merge_shards(str(out), 3) == 11
        files[name]["merged"] = out.read_bytes()
        assert sorted(p.name for p in out.parent.iterdir()) == ["o.fa"]
    assert files["port"] == files["jax"]
    want = "".join(f">{n}\n{s.decode()}\n" if q is None else
                   f"@{n}\n{s.decode()}\n+\n{q.decode()}\n"
                   for n, s, q in recs)
    assert files["port"]["merged"].decode() == want


def _refusal(capsys, argv):
    """The port's and the JAX CLI's rc and stderr on one argv."""
    rc = cli.main(argv)
    err = capsys.readouterr().err
    jrc = jcli.main(argv)
    return rc, err, jrc, capsys.readouterr().err


@pytest.mark.parametrize("case", ["dead", "mixed", "unmarked", "hosts"])
def test_merge_refusals_match_the_jax_cli(tmp_path, capsys, case):
    """A rank without its marker, a mixed-mode set, a wholly unmarked set
    and a marker from another host count: rc 1 and the JAX message from
    both CLIs, nothing merged; --merge-unmarked merges the unmarked set."""
    out = tmp_path / "o.fa"
    recs = _records(np.random.default_rng(4), 6, False)
    _write_shards(dist, out, recs, 2, [0, 3] if case != "mixed" else None)
    if case == "dead":
        os.unlink(dist.done_path(str(out), 1))
    elif case == "mixed":
        w = dist.ShardWriter(str(out), 1, 2, append=False, start_ordinal=3)
        w.put_at(0, "mv/9/ccs", b"ACGT")
        w.close()
    elif case == "unmarked":
        for r in range(2):
            os.unlink(dist.done_path(str(out), r))
    argv = ["--merge-shards", "3" if case == "hosts" else "2", "ignored",
            str(out)]
    rc, err, jrc, jerr = _refusal(capsys, argv)
    assert rc == jrc == 1 and err == jerr
    assert err.startswith("Error: ") and "Traceback" not in err
    assert not out.exists()
    if case == "unmarked":
        assert "--merge-unmarked" in err
        assert cli.main(argv + ["--merge-unmarked"]) == 0
        assert "merging anyway" in capsys.readouterr().err
        assert out.read_text().count(">") == 6


@pytest.mark.parametrize("extra", [
    ["--hosts", "2"],
    ["--hosts", "2", "--host-id", "0", "--bam"],
    ["--hosts", "2", "--host-id", "1", "--batch", "off"],
])
def test_sharded_cli_refusals_match_the_jax_cli(tmp_path, capsys, extra):
    fa = tmp_path / "in.fa"
    fa.write_text(">m/1/0_4\nACGT\n")
    out = tmp_path / "o.fa"
    rc, err, jrc, jerr = _refusal(capsys, ["-A", *extra, str(fa), str(out)])
    assert rc == jrc == 1 and err == jerr and err.startswith("Error: ")
    assert not list(tmp_path.glob("o.fa*"))


# ---- two ranks through the CLI -----------------------------------------------


@pytest.fixture(scope="module")
def unsharded(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("one") / "o.fa"
    assert cli.main(PORT + ["--batch", "on", str(corpus["fq"]),
                            str(out)]) == 0
    return out.read_bytes()


def test_unsharded_port_run_gives_the_jax_bytes(corpus, unsharded):
    assert unsharded == corpus["bytes"]


@pytest.mark.parametrize("prep", ["0", "auto"])
def test_round_robin_ranks_merge_to_the_unsharded_bytes(
        corpus, unsharded, tmp_path, prep):
    """FASTQ input (round-robin): rank r owns holes r, r + 2, r + 4; the
    merge is the port's unsharded output and the JAX CLI's, with the prep
    pool and without."""
    out = tmp_path / "o.fa"
    argv = PORT + (["--prep-threads", prep] if prep != "auto" else []) + [
        str(corpus["fq"])]
    finals = run_ranks(argv, out)
    assert out.read_bytes() == unsharded == corpus["bytes"]
    size = os.path.getsize(corpus["fq"])
    for f in finals:
        # full-parse round-robin: every rank ingests the whole file, and
        # no index gives a progress total
        assert f["holes_out"] == 3 and f["holes_in"] == 3
        assert f["ingest_bytes"] == size
        assert f["progress"]["total"] is None
        assert f["device_dispatches"] > 0
