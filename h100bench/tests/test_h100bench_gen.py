"""The corpus generator: the mixes' laws, determinism, wrap-around."""

import json
import os

import numpy as np
import pytest

from h100bench.gen import corpus, holes
from h100bench.harness.window import Window

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ERRORS = {"sub_rate": 0.02, "ins_rate": 0.05, "del_rate": 0.05}
SEED = 3_000_000_019


def mix(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["ins15k", "fl16s"])
def test_laws_hold_on_a_block(name):
    m = mix(name)
    n = holes.BLOCK
    hs = [holes.make_hole(SEED, i, m, ERRORS) for i in range(n)]
    tl = np.array([len(h.template) for h in hs])
    full = np.array([h.kinds.count(holes.FULL) for h in hs])
    t, p = m["template"], m["full_passes"]
    assert tl.min() >= t["lo"] and tl.max() <= t["hi"]
    assert full.min() >= p["lo"] and full.max() <= p["hi"]
    # a block holds the laws' quantiles: its median is the law's
    for law, x in ((t, tl), (p, full)):
        mid = law.get("median", (law["lo"] + law["hi"]) / 2)
        assert abs(np.median(x) - mid) <= 0.03 * mid + 1
    for h in hs:
        assert h.kinds[0] == h.kinds[-1] == holes.PARTIAL \
            or h.kinds[len(h.kinds) // 2] == holes.READ_THROUGH
        assert (holes.READ_THROUGH in h.kinds) == (h.index % 5 == 0)
        gaps = h.kinds.count(holes.FULL) - 1
        prob = m["interrupt"].get("prob", 0.0)
        assert h.kinds.count(holes.INTERRUPTED) == round(prob * gaps)
        lens = [len(x) for x, k in zip(h.passes, h.kinds)
                if k == holes.FULL]
        # ~12% error, indel-balanced: a traversal stays near the template
        assert all(abs(L - len(h.template)) < 0.05 * len(h.template)
                   for L in lens)


def test_the_hifi_length_law_keeps_its_tail():
    # no quantile of a block is clipped, and the tail passes the program's
    # seed_device_min_t (16,384), as a size-selected WGS library's does
    m = mix("ins15k")
    t = m["template"]
    tl = [holes.quantile(t, (k + 0.5) / holes.BLOCK)
          for k in range(holes.BLOCK)]
    assert t["lo"] < min(tl) and max(tl) < t["hi"]
    assert 2 <= sum(x > 16384 for x in tl) <= 5
    assert abs(np.mean(tl) - 13500) < 100


def test_blocks_hold_the_same_sizes_for_every_seed():
    m = mix("ins15k")
    a = sorted(holes.quantile(m["template"], holes.stratum(1, i, 0))
               for i in range(holes.BLOCK))
    b = sorted(holes.quantile(m["template"], holes.stratum(2, i, 0))
               for i in range(holes.BLOCK))
    assert a == b
    assert [holes.stratum(1, i, 0) for i in range(8)] != \
        [holes.stratum(2, i, 0) for i in range(8)]


def _small():
    m = mix("ins15k")
    m["template"] = {"law": "uniform", "lo": 600, "hi": 900}
    return m


def test_same_seed_same_bam_bytes(tmp_path):
    m = _small()
    a = corpus.build(str(tmp_path / "a"), SEED, 24, m, ERRORS, "mv",
                     workers=1)
    b = corpus.build(str(tmp_path / "b"), SEED, 24, m, ERRORS, "mv",
                     workers=3)
    c = corpus.build(str(tmp_path / "c"), SEED + 1, 24, m, ERRORS, "mv",
                     workers=1)
    with open(a[0], "rb") as f:
        ab = f.read()
    with open(b[0], "rb") as f:
        assert f.read() == ab
    with open(c[0], "rb") as f:
        assert f.read() != ab
    again = corpus.build(str(tmp_path / "a"), SEED, 24, m, ERRORS, "mv")
    assert again[3] is True
    np.testing.assert_array_equal(again[1].pass_lens, a[1].pass_lens)


def test_bam_reads_back_through_the_port(tmp_path):
    from ccsx_tpu_torch.config import CcsConfig
    from ccsx_tpu_torch.ops import encode
    from ccsx_tpu_torch.pipeline import run

    m = _small()
    bam, man, _, _ = corpus.build(str(tmp_path), SEED, 12, m, ERRORS, "mv",
                                  workers=1)
    zs = list(run.open_zmw_stream(bam, CcsConfig(min_subread_len=1000),
                                  None))
    assert [z.hole for z in zs] == [str(i) for i in range(12)]
    for z in zs:
        h = holes.make_hole(SEED, int(z.hole), m, ERRORS)
        assert list(z.lens) == [len(p) for p in h.passes]
        np.testing.assert_array_equal(encode.encode(z.seqs),
                                      np.concatenate(h.passes))
        assert int(man.hole_bases[int(z.hole)]) == h.bases


class _Z:
    def __init__(self, hole):
        self.hole = hole


def _replace(z, hole):
    return _Z(hole)


def test_wrap_around_gives_fresh_hole_names(monkeypatch):
    import dataclasses

    monkeypatch.setattr(dataclasses, "replace", _replace)
    clock = iter(range(100))
    w = Window(50, 3, reopen=lambda: iter([_Z("0"), _Z("1"), _Z("2")]),
               clock=lambda: next(clock))
    got = [z.hole for z in w.stream(iter([_Z("0"), _Z("1"), _Z("2")]))]
    assert w.laps >= 2
    assert len(got) == len(set(got))
    assert got[:7] == ["0", "1", "2", "3", "4", "5", "6"]
    assert [i for _, i in w.admitted][:7] == [0, 1, 2, 0, 1, 2, 0]
