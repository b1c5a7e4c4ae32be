"""The comparison that decides ``correct`` fails what it must: the control
(the reference with one refinement round fewer, in the program's place),
and the faults a cell on one card can have, each planted under the timed
path of a host run."""

import types

import numpy as np
import pytest

from h100bench import control
from h100bench.gen import corpus
from h100bench.harness import check
from h100bench.tests import _tiny

MIX = {"template": {"law": "uniform", "lo": 700, "hi": 900},
       "full_passes": {"law": "uniform", "lo": 3, "hi": 8},
       "partial_ends": True, "read_through_every": 3,
       "interrupt": {"prob": 0.3, "lo": 0.12, "hi": 0.4, "min_len": 100}}


def test_the_control_fails_the_comparison(tmp_path):
    # the control's records, judged by the comparison that decides a
    # run's ``correct``
    mix = dict(MIX, pool_holes=6, sample_holes=3)
    config = dict(_tiny.CONFIG, flags=["-m", "1000"])
    _, man, _, _ = corpus.build(str(tmp_path), 99, 6, mix, config["errors"],
                                config["movie"], workers=1)
    cell = types.SimpleNamespace(name="tiny", mix=mix, config=config)
    r = control.control_run(cell, 99, 6, man, device="cpu")
    assert r["checked"] >= 3
    assert r["correct"] is False
    assert (r["checks"]["mismatched_records"]["value"]
            > check.LIMITS["mismatched_records"])


def test_a_configuration_sets_only_the_algorithms_flags():
    assert check.params({"flags": ["-m", "1000"]}, "cpu").min_len == 1000
    with pytest.raises(ValueError):
        check.params({"flags": ["--prep-threads", "2"]}, "cpu")


def _unchanged_state(monkeypatch):
    """A refine step that hands back the draft it was given."""
    from ccsx_tpu_torch.consensus import star, windowed

    real = windowed.refine_rounds_gen

    def unchanged(qs, qlens, row_mask, draft, iters):
        res = yield from real(qs, qlens, row_mask, draft, iters)
        rr = res.rr
        n = min(len(draft), len(rr.cons))
        rr.cons = rr.cons.copy()
        rr.cons[:n] = draft[:n]
        rr.ins_votes = np.zeros_like(rr.ins_votes)
        return star.RefineResult(rr=rr)

    monkeypatch.setattr(windowed, "refine_rounds_gen", unchanged)


def _half_left_out(monkeypatch):
    """Every other hole's record never written."""
    from ccsx_tpu_torch.pipeline import run

    real = run.open_writer

    class Half:
        def __init__(self, w):
            self.w, self.n = w, 0

        def put(self, *a, **k):
            self.n += 1
            if self.n % 2 == 0:
                self.w.put(*a, **k)

        def __getattr__(self, name):
            return getattr(self.w, name)

    monkeypatch.setattr(run, "open_writer",
                        lambda *a, **k: Half(real(*a, **k)))


def _answer_altered(monkeypatch):
    """A consensus changed in one base where it is made into a record."""
    from ccsx_tpu_torch.ops import encode

    real = encode.to_record

    def altered(result):
        rec = real(result)
        if rec is None or not rec[0]:
            return rec
        first = b"C" if rec[0][:1] != b"C" else b"G"
        return (first + rec[0][1:],) + tuple(rec[1:])

    monkeypatch.setattr(encode, "to_record", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_left_out,
                                   _answer_altered],
                         ids=["state_unchanged", "half_left_out",
                              "answer_altered"])
def test_a_planted_fault_comes_out_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    r = _tiny.run(tmp_path, seconds=0.0)
    assert r["attempted"] >= 1
    assert r["correct"] is False
    assert r["checks"]["mismatched_records"]["value"] > 0
