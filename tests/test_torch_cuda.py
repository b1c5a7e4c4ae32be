"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card every test here skips.  On a host
with one (and without JAX, which these tests do not need):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every output is an integer or a byte: the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.consensus import star
from ccsx_tpu_torch.ops import banded, banded_cuda, cuda_ext, seed, traceback
from ccsx_tpu_torch.utils import synth

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _passes(rng, n, tlen, qmax):
    t = rng.integers(0, 4, tlen).astype(np.uint8)
    qs = np.full((n, qmax), 5, np.uint8)
    qlens = np.zeros(n, np.int32)
    for k in range(n - 1):                   # the last row stays a padding row
        q = synth.mutate(rng, t, 0.02, 0.08, 0.05)[:qmax]
        qs[k, :len(q)] = q
        qlens[k] = len(q)
    return t, qs, qlens


def test_global_fill_and_walk_match_plain(cuda):
    rng = np.random.default_rng(1)
    t, qs, qlens = _passes(rng, 9, 600, 768)
    tmax = 768
    args = [torch.from_numpy(qs), torch.from_numpy(qlens),
            torch.from_numpy(np.pad(t, (0, tmax - len(t)), constant_values=5)
                             )[None].expand(len(qs), tmax),
            torch.full((len(qs),), len(t), dtype=torch.int32)]
    before = cuda_ext.LAUNCHES["banded_global"]
    rk, mk, ok = banded_cuda.batched_align_global_moves(
        *[a.to(cuda) for a in args])
    assert cuda_ext.LAUNCHES["banded_global"] == before + 1
    rp, mp, op = banded.banded_global_moves(*args)
    assert torch.equal(rk.cpu(), rp.score)
    assert torch.equal(ok.cpu(), op)
    for i, ql in enumerate(qlens):
        assert torch.equal(mk[i, :ql].cpu(), mp[i, :ql]), i
    wk = traceback.project(mk, ok, args[0].to(cuda), args[1].to(cuda),
                           args[3].to(cuda), tmax, 4)
    wp = traceback.project_plain(mp, op, *args[:2], args[3], tmax, 4)
    for a, b in zip(wk, wp):
        assert torch.equal(a.cpu(), b)


def test_local_fill_matches_plain(cuda):
    rng = np.random.default_rng(2)
    t = rng.integers(0, 4, 900).astype(np.uint8)
    pairs = [synth.mutate(rng, t, 0.02, 0.05, 0.05),
             np.concatenate([rng.integers(0, 4, 400).astype(np.uint8), t[:500]]),
             rng.integers(0, 4, 700).astype(np.uint8)]
    qmax = max(len(p) for p in pairs)
    qs = torch.from_numpy(np.stack([np.pad(p, (0, qmax - len(p)),
                                           constant_values=5) for p in pairs]))
    qlens = torch.tensor([len(p) for p in pairs], dtype=torch.int32)
    ts = torch.from_numpy(t)[None].repeat(len(pairs), 1)
    tlens = torch.full((len(pairs),), len(t), dtype=torch.int32)
    hits = [seed.seed_diagonal(p, t) for p in pairs]
    lines = torch.from_numpy(np.stack([
        h.line if h is not None else np.array([0, 0, len(p), len(t)], np.int32)
        for h, p in zip(hits, pairs)]))
    for ln in (None, lines):
        got = banded_cuda.batched_align_local(
            qs.to(cuda), qlens.to(cuda), ts.to(cuda), tlens.to(cuda),
            None if ln is None else ln.to(cuda))
        want = banded.banded_local(qs, qlens, ts, tlens, ln)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_round_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    t = rng.integers(0, 4, 800).astype(np.uint8)
    passes = [synth.mutate(rng, t, 0.02, 0.05, 0.05) for _ in range(6)]
    cpu = star.StarMsa(AlignParams(), device="cpu")
    qs, qlens, mask = cpu.pack(passes, (4, 8, 16, 32), 32)
    want = cpu.round(qs, qlens, mask, passes[0])
    got = star.StarMsa(AlignParams(), device=cuda).round(qs, qlens, mask,
                                                         passes[0])
    for name in ("cons", "ins_base", "ins_votes", "ncov", "nwin", "match",
                 "aligned", "ins_cnt", "lead_ins"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
