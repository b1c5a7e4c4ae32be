"""Parity of the port's pre-alignment plane with the JAX package.

The device screen (sketch.screen_step) and the device seeder
(seed_device.seed_step) against the JAX package's steps on the same padded
group, and against the host twins (screen_host, seed_diagonal), on the
corpora of tests/test_sketch.py (random, repeat-heavy, N-laden, unrelated,
wrong-strand) and on pairs aimed at each way the two could part: an even
count of hits in the best window whose middle pair sums to a negative odd
number, tied window maxima, a k-mer repeated more than MAX_HITS times, and
no hit at all.  Then the port's PairExecutor against the JAX package's on
the same pairs (results and counters), and the CLI's bytes with device
seeding on a small corpus.  Every output is an integer or a byte: the
tolerance is exact equality.
"""

import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (tests/conftest.py pins it to the CPU)

from ccsx_tpu import cli as jcli
from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.consensus import prepare as jprep
from ccsx_tpu.ops import seed_device as jseed_device
from ccsx_tpu.ops import sketch as jsketch
from ccsx_tpu.pipeline import batch as jbatch
from ccsx_tpu.utils import synth as jsynth
from ccsx_tpu.utils.metrics import Metrics

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.consensus import prepare
from ccsx_tpu_torch.consensus.star import bucket_len, pad_to
from ccsx_tpu_torch.ops import encode as enc
from ccsx_tpu_torch.ops import seed, seed_device, sketch
from ccsx_tpu_torch.pipeline import batch
from ccsx_tpu_torch.utils.run_metrics import RunMetrics

ERR = dict(sub_rate=0.02, ins_rate=0.05, del_rate=0.05)


def _adversarial_pair(rng, kind, lo=2048, hi=4000):
    """tests/test_sketch.py's fuzz corpus: 0 related, 1 repeat-heavy, 2
    N-laden, 3 unrelated, 4 wrong-strand related."""
    L = int(rng.integers(lo, hi))
    t = rng.integers(0, 4, L).astype(np.uint8)
    if kind == 1:
        unit = rng.integers(0, 4, int(rng.integers(7, 61))).astype(np.uint8)
        t = np.tile(unit, L // len(unit) + 1)[:L].copy()
    if kind == 2:
        t[rng.random(L) < 0.05] = 4
    if kind == 3:
        q = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
    elif kind == 4:
        q = enc.revcomp_codes(jsynth.mutate(rng, t, **ERR))
    else:
        q = jsynth.mutate(rng, t, **ERR)
    if kind == 2:
        q = q.copy()
        q[rng.random(len(q)) < 0.05] = 4
    return q, t


def _trap_pairs():
    """One pair per trap, by name."""
    rng = np.random.default_rng(8)
    t = rng.integers(0, 4, 3000).astype(np.uint8)
    L = 300
    # 288 hits on diagonal -100 and 288 on -101: the median is the mean of
    # -101 and -100, -100.5, which int(np.median) truncates to -100 (the
    # lower middle value, torch.median's answer, is -101)
    even = np.concatenate([t[100:100 + L], t[101 + L:101 + 2 * L]])
    # 288 hits on diagonal 0 and 288 on -1200, far apart: two equal maxima
    # of the paired bins, the first wins
    tied = np.concatenate([t[:L], t[1500:1500 + L]])
    # a 20-base unit six times in the template: its k-mers hit six times,
    # capped at MAX_HITS in sorted (position) order
    unit = rng.integers(0, 4, 20).astype(np.uint8)
    rep_t = t.copy()
    for k in range(6):
        rep_t[200 + 400 * k:220 + 400 * k] = unit
    rep_q = jsynth.mutate(rng, rep_t, 0.01, 0.0, 0.0)
    return {
        "even_negative": (even, t),
        "tied_maxima": (tied, t),
        "repeat_over_cap": (rep_q, rep_t),
        "no_hit_n_query": (np.full(900, 4, np.uint8), t),
        "no_hit_short_template": (t[:900], t[:10]),
    }


def _group(pairs):
    """The padded wire layout of one PairExecutor group."""
    qmax = max(bucket_len(len(q), 512) for q, _ in pairs)
    tmax = max(bucket_len(len(t), 512) for _, t in pairs)
    big = np.full((len(pairs), qmax + tmax), 5, np.uint8)
    small = np.zeros((len(pairs), 2), np.int32)
    for z, (q, t) in enumerate(pairs):
        big[z, :qmax] = pad_to(q, qmax)
        big[z, qmax:] = pad_to(t, tmax)
        small[z] = len(q), len(t)
    return qmax, tmax, big, small


def _corpus(name):
    if name == "traps":
        return list(_trap_pairs().values())
    rng = np.random.default_rng({"fuzz": 0, "fuzz_short": 1}[name])
    lo, hi = (2048, 4000) if name == "fuzz" else (600, 1500)
    return [_adversarial_pair(rng, k % 5, lo, hi) for k in range(15)]


@pytest.mark.parametrize("name", ["fuzz", "fuzz_short", "traps"])
def test_screen_and_seed_steps_match_reference_and_host(name):
    pairs = _corpus(name)
    qmax, tmax, big, small = _group(pairs)
    want_s = np.asarray(jsketch.screen_step(qmax, tmax)(big, small))
    want_d = np.asarray(jseed_device.seed_step(qmax, tmax)(big, small))
    b, s = torch.from_numpy(big), torch.from_numpy(small)
    got_s = sketch.screen_step(qmax, tmax)(b, s)
    got_d = seed_device.seed_step(qmax, tmax)(b, s)
    assert got_s.dtype == got_d.dtype == torch.int32
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    for z, (q, t) in enumerate(pairs):
        assert tuple(int(v) for v in got_s[z]) == sketch.screen_host(q, t)
        hit = seed.seed_diagonal(q, t)
        got = seed_device.hit_from_row(got_d[z].numpy())
        assert (hit is None) == (got is None), z
        if hit is not None:
            assert (got.diag, got.votes) == (hit.diag, hit.votes)
            np.testing.assert_array_equal(got.line, hit.line)
    found = got_d[:, 0].numpy()
    assert found.any() and not found.all()


def test_traps_take_the_path_they_aim_at():
    """Each trap pair does exercise its trap: the mean of the even pair's
    middle values is negative and not whole, the tied pair has two equal
    maxima, the repeat is capped, and the no-hit pairs have total 0."""
    traps = _trap_pairs()
    q, t = traps["even_negative"]
    hit = seed.seed_diagonal(q, t)
    assert hit.diag == -100 and hit.votes == 576
    assert int(torch.tensor([-101] * 288 + [-100] * 288).median()) == -101
    q, t = traps["tied_maxima"]
    total, votes, win_lo = sketch.screen_host(q, t)
    assert votes == 288 and win_lo < -1100
    q, t = traps["repeat_over_cap"]
    tks, _ = seed.sorted_kmer_index(t)
    assert np.unique(tks, return_counts=True)[1].max() > sketch.MAX_HITS
    for name in ("no_hit_n_query", "no_hit_short_template"):
        assert sketch.screen_host(*traps[name]) == (0, 0, 0)


def _executor_pairs(n=5):
    """strand_match candidates of 0.7-0.95 kb (related, repeat-heavy,
    N-laden, unrelated, wrong-strand), and the two arms of a PairBatch
    over a 2.3 kb template: a forward and a wrong-strand pass."""
    rng = np.random.default_rng(41)
    pairs = [_adversarial_pair(rng, k % 5, 700, 950) for k in range(n)]
    tpl = rng.integers(0, 4, 2300).astype(np.uint8)
    fwd = jsynth.mutate(rng, tpl, **ERR)
    return pairs, (fwd, tpl), (enc.revcomp_codes(fwd), tpl)


@pytest.mark.parametrize("min_t", [1024, 0])
def test_pair_executor_matches_reference(min_t):
    """seed_device_min_t 1024 seeds the templates of 1024 bases and more
    on the device and the rest on the host; 0 seeds all on the host and so
    sends the pairs of at least screen_min_device (2048) bases through the
    device screen.  Results and counters equal the JAX package's."""
    pairs, arm_f, arm_r = _executor_pairs()
    m = Metrics()
    jex = jbatch.PairExecutor(JaxParams(), metrics=m, seed_device_min_t=min_t)
    jex.screen_min_device = 2048
    want = jex.run([jprep.PairRequest(q, t, 75) for q, t in pairs]
                   + [jprep.PairBatch([jprep.PairRequest(*arm_f, 75),
                                       jprep.PairRequest(*arm_r, 75)])])
    pm = RunMetrics()
    ex = batch.PairExecutor(AlignParams(), device="cpu", metrics=pm,
                            seed_device_min_t=min_t)
    ex.screen_min_device = 2048
    got = ex.run([prepare.PairRequest(q, t, 75) for q, t in pairs]
                 + [prepare.PairBatch([prepare.PairRequest(*arm_f, 75),
                                       prepare.PairRequest(*arm_r, 75)])])
    flat_w = want[:-1] + want[-1]
    flat_g = got[:-1] + got[-1]
    for (ok_w, w), (ok_g, g) in zip(flat_w, flat_g):
        assert ok_g == ok_w
        assert (g.score, g.qb, g.qe, g.tb, g.te, g.aln, g.mat) == \
            (w.score, w.qb, w.qe, w.tb, w.te, w.aln, w.mat)
    for k in ("pairs_seeded_device", "pairs_seeded_host", "pairs_screened",
              "pairs_prefiltered", "pair_alignments", "device_dispatches",
              "dp_cells_real"):
        assert getattr(pm, k) == getattr(m, k), k
    if min_t:
        assert pm.seed_steps > 0 and pm.screen_steps == 0
        assert pm.pairs_seeded_host > 0
    else:
        assert pm.screen_steps > 0 and pm.seed_steps == 0
        assert pm.pairs_prefiltered > 0


def test_failed_seed_and_screen_waves_take_the_host_rung():
    """A seed or screen step that fails on its data replays each pair on
    its host rung (seed_diagonal, screen_host): same results, counted as
    failed steps and host replays."""
    pairs, arm_f, arm_r = _executor_pairs(n=0)
    reqs = [prepare.PairRequest(q, t, 75) for q, t in pairs + [arm_f, arm_r]]
    clean = batch.PairExecutor(AlignParams(), device="cpu",
                               seed_device_min_t=1024)
    clean.screen_min_device = 2048
    want = clean.run(reqs)

    def broken(*a, **k):
        def step(big, small):
            raise IndexError("a group's own data is at fault")
        return step

    for min_t, mod, name in ((1024, seed_device, "seed_step"),
                             (0, sketch, "screen_step")):
        m = RunMetrics()
        ex = batch.PairExecutor(AlignParams(), device="cpu", metrics=m,
                                seed_device_min_t=min_t)
        ex.screen_min_device = 2048
        real = getattr(mod, name)
        setattr(mod, name, broken)
        try:
            got = ex.run(reqs)
        finally:
            setattr(mod, name, real)
        assert m.failed_steps > 0 and m.host_fallbacks > 0
        for (ok_w, w), (ok_g, g) in zip(want, got):
            assert ok_g == ok_w
            if ok_w:
                assert g == w


@pytest.fixture(scope="module")
def long_corpus(tmp_path_factory):
    """A hole of a 1.1 kb template with a read-through pass (so the walk
    verifies passes by alignment) and the JAX package's output with device
    seeding from 1024 bases."""
    rng = np.random.default_rng(29)
    zs = []
    for h in range(1):
        z = jsynth.make_zmw(rng, template_len=1100, n_passes=4, movie="mv",
                            hole=str(h), **ERR)
        z.passes.insert(2, jsynth.read_through(rng, z.template, **ERR))
        z.strands.insert(2, 0)
        zs.append(z)
    d = tmp_path_factory.mktemp("sketch")
    fa = d / "in.fa"
    fa.write_text(jsynth.make_fasta(zs))
    out = d / "ref.fa"
    assert jcli.main(["-A", "-m", "1000", "--batch", "on", "--device", "cpu",
                      "--seed-device-min-t", "1024", str(fa), str(out)]) == 0
    assert out.read_bytes().count(b"/ccs\n") == 1
    return str(fa), out.read_bytes()


def test_cli_device_seeding_matches_reference(long_corpus, tmp_path, capsys):
    fa, ref = long_corpus
    out = tmp_path / "out.fa"
    assert cli.main(["-A", "-m", "1000", "--device", "cpu", "--batch", "on",
                     "--seed-device-min-t", "1024", "-v", fa,
                     str(out)]) == 0
    assert out.read_bytes() == ref
    last = capsys.readouterr().err.strip().splitlines()[-1]
    prefix, snap = last.split(" ", 1)
    assert prefix == "[ccsx-tpu-torch]"
    assert json.loads(snap)["pairs_seeded_device"] > 0
