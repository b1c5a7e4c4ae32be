"""The port CLI's output bytes under the knobs that change them
(--refine-iters, --max-passes, --window-growth) and under -P (whole-read
consensus) and -X (hole exclusion), against the JAX CLI with the same
flags, on a 3-hole corpus of 600 bp templates.  The tolerance is exact
equality of the FASTA bytes.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)

from ccsx_tpu import cli as jcli
from ccsx_tpu.utils import synth as jsynth

from ccsx_tpu_torch import cli

ERR = dict(sub_rate=0.02, ins_rate=0.05, del_rate=0.05)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Holes of 5, 7 and 11 passes (600 bp templates) and the JAX CLI's
    default --batch on output for them."""
    rng = np.random.default_rng(19)
    zs = [jsynth.make_zmw(rng, template_len=600, n_passes=n, movie="mv",
                          hole=str(h), **ERR)
          for h, n in enumerate((5, 7, 11))]
    d = tmp_path_factory.mktemp("knobs")
    fa = d / "in.fa"
    fa.write_text(jsynth.make_fasta(zs))
    out = d / "default.fa"
    assert _jax(str(fa), out) == 0
    return str(fa), out.read_bytes()


def _jax(fa, out, *flags):
    return jcli.main(["-A", "-m", "1000", "--batch", "on", "--device", "cpu",
                      *flags, fa, str(out)])


# whether the flag changes the default bytes here: --window-growth and -P
# do not (a 600 bp hole is one window, which never reaches max_window, and
# whole-read consensus of one window gives the same bytes); -X keeps holes
# 0 and 2
@pytest.mark.parametrize("flags,changes", [
    (["--refine-iters", "0"], True), (["--refine-iters", "3"], True),
    (["--max-passes", "6"], True), (["--window-growth", "grow"], False),
    (["-P"], False), (["-X", "1"], True)])
def test_cli_knob_bytes_match_reference(flags, changes, corpus, tmp_path):
    fa, default = corpus
    ref = tmp_path / "ref.fa"
    assert _jax(fa, ref, *flags) == 0
    want = ref.read_bytes()
    assert want.count(b">mv/") == (2 if flags[0] == "-X" else 3)
    assert (want != default) == changes
    out = tmp_path / "o.fa"
    assert cli.main(["-A", "-m", "1000", "--device", "cpu", "--batch", "on",
                     *flags, fa, str(out)]) == 0
    assert out.read_bytes() == want


# breakpoints made impossible (every row and column of a 2-column window
# must agree) and the largest window equal to the first, so the first
# window of a 1.4 kb hole has no breakpoint and cannot grow under "flush":
# there the flush rule forces one, under "grow" the window grows past the
# cap; no CLI flag reaches these fields, so both CLIs' configs are taken
# from their own parsers and changed alike
STRICT = dict(bp_window=2, bp_rowrate=100, bp_colrate=100,
              bp_colrate_lowpass=100, window_init=768, window_add=768,
              window_minlen=384, max_window=768)


def test_window_growth_grow_at_the_largest_window_matches_reference(tmp_path):
    import dataclasses

    from ccsx_tpu.pipeline.batch import run_pipeline_batched
    from ccsx_tpu_torch.pipeline.run import run_pipeline

    rng = np.random.default_rng(1)
    zs = [jsynth.make_zmw(rng, template_len=1400, n_passes=5, movie="mv",
                          hole="0", sub_rate=0.04, ins_rate=0.08,
                          del_rate=0.08)]
    fa = tmp_path / "in.fa"
    fa.write_text(jsynth.make_fasta(zs))
    got = {}
    for growth in ("flush", "grow"):
        argv = ["-A", "-m", "1000", "--device", "cpu", "--window-growth",
                growth, str(fa), "x"]
        jcfg = dataclasses.replace(jcli.config_from_args(
            jcli.build_parser().parse_args(argv)), **STRICT)
        pcfg = dataclasses.replace(cli.config_from_args(
            cli.build_parser().parse_args(argv)), **STRICT)
        ref, out = tmp_path / f"ref_{growth}.fa", tmp_path / f"{growth}.fa"
        assert run_pipeline_batched(str(fa), str(ref), jcfg) == 0
        assert run_pipeline(str(fa), str(out), pcfg, batch="on") == 0
        got[growth] = ref.read_bytes()
        assert got[growth].count(b">mv/") == 1
        assert out.read_bytes() == got[growth]
    # the two rules give different consensus here: the grow branch ran
    assert got["flush"] != got["grow"]
