"""Why chip_smoke.py's HiFi-size phase floors its pass counts at 10.

The log-normal draw of ``sample_pass_counts`` from seed 15000 (8 holes,
15 kb templates, ERR error rates) gives three 7-pass holes.  Hole 3 among
them reaches only ~0.989 identity against its template, below the smoke
run's 0.99 gate, and the JAX package's per-hole driver gives the very same
bytes for it: the shortfall is the depth of the hole, not the port.  This
test pins both facts on the CPU.
"""

import numpy as np

from ccsx_tpu import cli as jcli

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.io import fastx
from ccsx_tpu_torch.ops import encode as enc
from ccsx_tpu_torch.ops import oracle, seed
from ccsx_tpu_torch.utils import synth


def _identity(cons, template):
    fwd = seed.seed_diagonal(cons, template)
    rev = seed.seed_diagonal(enc.revcomp_codes(cons), template)
    if (rev.votes if rev else 0) > (fwd.votes if fwd else 0):
        cons = enc.revcomp_codes(cons)
    return oracle.align(cons, template, mode="global").identity


def test_shallow_hifi_hole_matches_reference_below_gate(tmp_path):
    rng = np.random.default_rng(15000)
    counts = synth.sample_pass_counts(rng, 8)
    assert counts.tolist() == [13, 7, 8, 7, 11, 9, 7, 10]
    zs = [synth.make_zmw(rng, 15000, int(c), movie="hifi", hole=str(h),
                         **synth.ERR) for h, c in enumerate(counts)]
    z = zs[3]
    src = tmp_path / "in.fa"
    src.write_text(synth.make_fasta([z]))
    ref, out = str(tmp_path / "ref.fa"), str(tmp_path / "out.fa")
    assert jcli.main(["-A", "--batch", "off", "--device", "cpu", str(src),
                      ref]) == 0
    assert cli.main(["-A", "--device", "cpu", str(src), out]) == 0
    want = open(ref, "rb").read()
    assert open(out, "rb").read() == want
    (rec,) = list(fastx.read_fastx(out))
    ident = _identity(enc.encode(rec.seq), z.template)
    assert 0.985 < ident < 0.99
