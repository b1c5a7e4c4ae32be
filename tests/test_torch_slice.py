"""Parity of the port's per-hole slice with the JAX package, end to end.

One star-MSA round field by field, the CLI's output bytes on a small synth
corpus (FASTA and --fastq), the scale-corpus generator's BAM bytes, and (slow
tier) the 64-hole scale corpus through the port's CPU path against the
pinned md5 of the JAX package's output.
"""

import hashlib
import os

import numpy as np
import pytest

from ccsx_tpu import cli as jcli
from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.consensus import star as jstar
from ccsx_tpu.ops import encode as jenc
from ccsx_tpu.utils import synth as jsynth

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.consensus import star
from ccsx_tpu_torch.utils import synth

SCALE64_MD5 = "0c83700d0fb67e3c89169f99574a9a2d"
SCALE64_BYTES = 188359


def test_round_matches_reference():
    rng = np.random.default_rng(2)
    t = rng.integers(0, 4, 700).astype(np.uint8)
    passes = [t] + [jsynth.mutate(rng, t, 0.02, 0.05, 0.05) for _ in range(5)]
    jsm = jstar.StarMsa(JaxParams())
    qs, qlens, row_mask = jsm.pack(passes, (4, 8, 16, 32), 32)
    want = jsm.round(qs, qlens, row_mask, passes[1])
    sm = star.StarMsa(AlignParams(), device="cpu")
    got = sm.round(qs, qlens, row_mask, passes[1])
    assert got.tlen == want.tlen
    for name in ("cons", "ins_base", "ins_votes", "ncov", "nwin", "match",
                 "aligned", "ins_cnt", "lead_ins"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for spec in (False, True):
        np.testing.assert_array_equal(got.materialize(speculative=spec),
                                      want.materialize(speculative=spec))
    np.testing.assert_array_equal(
        np.concatenate(got.materialize_with_qual()),
        np.concatenate(want.materialize_with_qual()))


@pytest.fixture(scope="module")
def small_fasta(tmp_path_factory):
    """4 holes, 1 kb templates, one adapter read-through hole."""
    rng = np.random.default_rng(17)
    zs = []
    for h in range(4):
        z = jsynth.make_zmw(rng, template_len=1000, n_passes=6 + (h % 3),
                            movie="mv", hole=str(h), sub_rate=0.02,
                            ins_rate=0.05, del_rate=0.05)
        if h == 1:
            z.passes.insert(3, jsynth.read_through(rng, z.template))
            z.strands.insert(3, 0)
        zs.append(z)
    path = tmp_path_factory.mktemp("slice") / "in.fa"
    path.write_text(jsynth.make_fasta(zs))
    return str(path)


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_cli_matches_reference_bytes(fmt, small_fasta, tmp_path):
    extra = ["--fastq"] if fmt == "fastq" else []
    ref, out = str(tmp_path / "ref"), str(tmp_path / "out")
    assert jcli.main(["-A", "-m", "1000", "--batch", "off", "--device",
                      "cpu", *extra, small_fasta, ref]) == 0
    assert cli.main(["-A", "-m", "1000", "--device", "cpu", *extra,
                     small_fasta, out]) == 0
    want = open(ref, "rb").read()
    assert want.count(b"/ccs\n") == 4
    assert open(out, "rb").read() == want


def test_make_big_bam_matches_benchmark_bytes(tmp_path):
    from benchmarks.e2e_scale import make_big_bam

    a, b = str(tmp_path / "ref.bam"), str(tmp_path / "port.bam")
    zr = make_big_bam(a, 8, np.random.default_rng(42))
    zp = synth.make_big_bam(b, 8, np.random.default_rng(42))
    assert open(a, "rb").read() == open(b, "rb").read()
    for x, y in zip(zr, zp):
        np.testing.assert_array_equal(x.template, y.template)
    assert jenc.decode(zr[0].template) == synth.enc.decode(zp[0].template)


@pytest.mark.slow
def test_scale64_cpu_path_matches_pinned_md5(tmp_path):
    """The 64-hole scale corpus through the port's plain CPU path gives
    the JAX package's pinned bytes (its --batch off run gives them too)."""
    bam = str(tmp_path / "in64.bam")
    out = str(tmp_path / "out.fa")
    synth.make_big_bam(bam, 64, np.random.default_rng(42))
    assert cli.main(["--device", "cpu", "-j", "4", bam, out]) == 0
    data = open(out, "rb").read()
    assert len(data) == SCALE64_BYTES
    assert hashlib.md5(data).hexdigest() == SCALE64_MD5
    os.remove(out)
