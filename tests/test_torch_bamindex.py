"""The port's BGZF hole index (ccsx_tpu_torch/io/bamindex.py) against the
JAX package's.

On a BAM of 15 holes in three BGZF blocks, both packages write the same
``.ccsx_idx`` bytes and each loads the other's; every cell of every
``split_ranges`` table reads the same records, and inflates the same
compressed bytes, through either package.  Also the port twins of
tests/test_bamindex.py: a stale index is refused, ``--make-index``
refuses FASTA input (and on a BAM writes the JAX CLI's index), and a
range read of a corrupt or truncated file raises ``BamError``.
"""

import os

import numpy as np
import pytest

from ccsx_tpu import cli as jcli
from ccsx_tpu.io import bam as jbam
from ccsx_tpu.io import bamindex as jbamindex

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.io import bam, bamindex
from ccsx_tpu_torch.ops import encode as enc
from ccsx_tpu_torch.utils import synth


def _write_bam(path, rng, n_holes=8, tlen=500, n_passes=5):
    zs = [synth.make_zmw(rng, tlen, n_passes, movie="mv", hole=str(h),
                         sub_rate=0.02, ins_rate=0.04, del_rate=0.04)
          for h in range(n_holes)]
    recs = [(name, enc.decode(p).encode(), None)
            for z in zs for name, p in zip(z.names, z.passes)]
    bam.write_bam(str(path), recs)
    return [r[0] for r in recs]


@pytest.fixture(scope="module")
def big_bam(tmp_path_factory):
    """~150 KB of raw BAM, three BGZF blocks: a range read can touch a
    proper subset of the file."""
    p = tmp_path_factory.mktemp("bamindex") / "in.bam"
    names = _write_bam(p, np.random.default_rng(5), n_holes=15, tlen=2000)
    return p, names


def test_index_bytes_equal_and_each_package_loads_the_others(big_bam):
    p, names = big_bam
    side = str(p) + bamindex.INDEX_SUFFIX
    assert bamindex.INDEX_SUFFIX == jbamindex.INDEX_SUFFIX == ".ccsx_idx"
    assert bamindex.INDEX_VERSION == jbamindex.INDEX_VERSION
    jidx = jbamindex.build_index(str(p), every=3)
    jbytes = open(side, "rb").read()
    assert bamindex.load_index(str(p)) == jidx
    idx = bamindex.build_index(str(p), every=3)
    assert open(side, "rb").read() == jbytes
    assert idx == jidx and jbamindex.load_index(str(p)) == idx
    assert idx["n_holes"] == 15 and idx["n_records"] == len(names)
    assert len(idx["entries"]) == 5


@pytest.mark.parametrize("m", [1, 2, 3, 4, 15, 20])
def test_every_split_range_reads_the_jax_records(big_bam, m):
    """Each cell of the m-range table: the same records (name, bases,
    qualities) and the same compressed byte count from both packages;
    the cells in order are the sequential reader's stream."""
    p, names = big_bam
    idx = bamindex.build_index(str(p), every=3)
    size = os.path.getsize(p)
    cells = bamindex.split_ranges(idx["n_holes"], m)
    assert cells == jbamindex.split_ranges(idx["n_holes"], m)
    got = []
    for lo, hi in cells:
        assert (lo, hi) == jbamindex.hole_range(
            idx["n_holes"], cells.index((lo, hi)), m)
        nb, jnb = [], []
        recs = [(r.name, r.seq, r.qual) for r in bamindex.read_hole_range(
            str(p), idx, lo, hi, counter=nb.append)]
        jrecs = [(r.name, r.seq, r.qual) for r in jbamindex.read_hole_range(
            str(p), idx, lo, hi, counter=jnb.append)]
        assert recs == jrecs and nb == jnb
        if m >= 3 and hi > lo:
            assert 0 < nb[0] < 0.9 * size
        got += [r[0] for r in recs]
    assert got == names


def test_stale_index_is_refused(tmp_path):
    rng = np.random.default_rng(6)
    p = tmp_path / "in.bam"
    _write_bam(p, rng, n_holes=3)
    bamindex.build_index(str(p))
    assert bamindex.load_index(str(p)) is not None
    # a rewritten input: the fingerprint (size + mtime) invalidates it
    _write_bam(p, rng, n_holes=4)
    os.utime(p, ns=(1, 1))
    assert bamindex.load_index(str(p)) is None
    assert jbamindex.load_index(str(p)) is None


def test_make_index_refuses_fasta_as_the_jax_cli_does(tmp_path, capsys):
    fa = tmp_path / "in.fa"
    fa.write_text(">x\nACGT\n")
    assert cli.main(["--make-index", "-A", str(fa), "ignored"]) == 1
    err = capsys.readouterr().err
    assert jcli.main(["--make-index", "-A", str(fa), "ignored"]) == 1
    assert err == capsys.readouterr().err
    assert "requires BAM input" in err
    assert not os.path.exists(str(fa) + bamindex.INDEX_SUFFIX)


def test_make_index_writes_the_jax_clis_index(tmp_path, capsys):
    p = tmp_path / "in.bam"
    _write_bam(p, np.random.default_rng(8), n_holes=4)
    side = str(p) + bamindex.INDEX_SUFFIX
    assert jcli.main(["--make-index", str(p), "ignored"]) == 0
    want = open(side, "rb").read()
    os.unlink(side)
    assert cli.main(["--make-index", str(p), "ignored"]) == 0
    assert open(side, "rb").read() == want
    assert "[ccsx-tpu-torch] indexed 4 holes" in capsys.readouterr().err
    assert bamindex.load_index(str(p))["n_holes"] == 4


def _corrupt(p, how):
    idx = bamindex.build_index(str(p), every=2)
    data = bytearray(p.read_bytes())
    if how == "flip":
        data[len(data) // 2] ^= 0xFF        # a payload byte mid-file
        p.write_bytes(bytes(data))
        idx["mtime_ns"] = os.stat(p).st_mtime_ns
    else:
        p.write_bytes(bytes(data[: len(data) - len(data) // 3]))
        idx["size"] = os.path.getsize(p)
    return idx


@pytest.mark.parametrize("how", ["flip", "truncate"])
def test_range_read_of_a_damaged_file_raises_as_in_jax(tmp_path, how):
    """A bit-flipped block (CRC) or a file cut mid-block raises BamError
    under a range read, with the JAX package's message, never yields
    silently wrong records."""
    p = tmp_path / "in.bam"
    _write_bam(p, np.random.default_rng(9), n_holes=6, tlen=1500)
    idx = _corrupt(p, how)
    with pytest.raises(bam.BamError) as e:
        for _ in bamindex.read_hole_range(str(p), idx, 0, idx["n_holes"]):
            pass
    with pytest.raises(jbam.BamError) as je:
        for _ in jbamindex.read_hole_range(str(p), idx, 0, idx["n_holes"]):
            pass
    assert str(e.value) == str(je.value)
