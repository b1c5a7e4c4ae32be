"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card every test here skips.  On a host
with one (and without JAX, which these tests do not need):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every output is an integer or a byte: the tolerance is exact equality.
"""

import threading

import numpy as np
import pytest
import torch

from ccsx_tpu_torch.config import AlignParams, CcsConfig
from ccsx_tpu_torch.consensus import star
from ccsx_tpu_torch.ops import (banded, banded_cuda, banded_rotband, cuda_ext,
                                seed, seed_device, sketch, traceback)
from ccsx_tpu_torch.ops import encode as enc
from ccsx_tpu_torch.pipeline import batch
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


def _slab_inputs(rng, R, qmax, tmax, holes):
    """R rows over ``holes`` templates (one template per row, as the packed
    round gathers them), the last row a padding row."""
    tpls = [rng.integers(0, 4, int(rng.integers(tmax - 400, tmax - 200))
                         ).astype(np.uint8) for _ in range(holes)]
    qs = np.full((R, qmax), 5, np.uint8)
    ts = np.full((R, tmax), 5, np.uint8)
    qlens = np.zeros(R, np.int32)
    tlens = np.zeros(R, np.int32)
    for r in range(R - 1):
        t = tpls[r % holes]
        q = synth.mutate(rng, t, 0.02, 0.05, 0.05)[:qmax]
        qs[r, :len(q)] = q
        qlens[r] = len(q)
        ts[r, :len(t)] = t
        tlens[r] = len(t)
    return [torch.from_numpy(x) for x in (qs, qlens, ts, tlens)]


def test_rotband_fill_matches_plain_and_band_local_kernel(cuda):
    rng = np.random.default_rng(4)
    args = _slab_inputs(rng, 12, 768, 1024, 3)
    dev_args = [a.to(cuda) for a in args]
    before = cuda_ext.LAUNCHES["banded_rotband"]
    got = banded_rotband.batched_align_global_moves(*dev_args)
    assert cuda_ext.LAUNCHES["banded_rotband"] == before + 1
    plain = banded_rotband.rotband_global_moves(*args)
    local = banded_cuda.batched_align_global_moves(*dev_args)
    for g, p, b in zip(got, plain, local):
        assert torch.equal(g.cpu(), p)
        assert torch.equal(g, b)


def _rot_equal(cuda, qs, qlens, ts, tlens):
    """The rotating-band kernel on the card against its plain version on
    the host and the band-local kernel on the card: scores, offsets and
    every move byte (rows beyond qlen are zero in all three); one counted
    launch."""
    host = [torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x for x in (qs, qlens, ts, tlens)]
    dev = [x.to(cuda) for x in host]
    if host[2].stride(0) == 0:               # keep a broadcast template so
        dev[2] = host[2][:1].to(cuda).expand(host[2].shape)
    before = cuda_ext.LAUNCHES["banded_rotband"]
    got = banded_rotband.batched_align_global_moves(*dev)
    assert cuda_ext.LAUNCHES["banded_rotband"] == before + 1
    plain = banded_rotband.rotband_global_moves(*host)
    local = banded_cuda.batched_align_global_moves(*dev)
    for name, g, p, b in zip(("score", "moves", "offsets"), got, plain,
                             local):
        assert torch.equal(g.cpu(), p), name
        assert torch.equal(g, b), name


@pytest.mark.parametrize("corpus", ["ties", "rotband"])
def test_rotband_fill_corpora_match_plain_and_band_local_kernel(corpus, cuda):
    """The tie cases (homopolymers, repeats, qlen 0, 1 and == qmax, tlen <
    128, a band clipped at tcap) and ``synth.rotband_cases`` (band offsets
    through every (OFF % 4, d) pair, the ring wrapped up to three times,
    bands clipped at tcap for about 190 rows)."""
    if corpus == "ties":
        cases = synth.fill_tie_cases(np.random.default_rng(31))[:4]
    else:
        cases = synth.rotband_cases(np.random.default_rng(5))
    _rot_equal(cuda, *cases)


def test_rotband_fill_long_window_many_problems_broadcast(cuda):
    """A final-flush-sized window (more than 4096 query rows, the template
    a row of an odd-width buffer), R = 200 problems in one launch (more
    blocks than the card's 132 SMs), and one template broadcast over the
    batch (stride 0, as the per-hole round passes it)."""
    rng = np.random.default_rng(12)
    t = rng.integers(0, 4, 4500).astype(np.uint8)
    q = synth.mutate(rng, t, 0.02, 0.05, 0.05)
    qmax, tmax = len(q) + 3, 4733
    qs = torch.full((2, qmax), 5, dtype=torch.uint8)
    ts = torch.full((2, tmax), 5, dtype=torch.uint8)
    qs[0, :len(q)] = torch.from_numpy(q)
    qs[1, :300] = torch.from_numpy(q[1000:1300])
    ts[:, :len(t)] = torch.from_numpy(t)
    _rot_equal(cuda, qs, torch.tensor([len(q), 300], dtype=torch.int32), ts,
               torch.full((2,), len(t), dtype=torch.int32))
    _rot_equal(cuda, *_slab_inputs(rng, 200, 512, 768, 7))
    t, qs, qlens = _passes(rng, 9, 600, 768)
    tb = torch.from_numpy(np.pad(t, (0, 768 - len(t)), constant_values=5))
    _rot_equal(cuda, torch.from_numpy(qs), torch.from_numpy(qlens),
               tb[None].expand(len(qs), 768),
               torch.full((len(qs),), len(t), dtype=torch.int32))


def test_packed_refine_step_on_card_matches_cpu(cuda):
    """One packed refine step (fill -> walk -> segment vote -> on-device
    materialize, iters 2) on the card against the same step on the CPU,
    under both global-fill arms."""
    rng = np.random.default_rng(6)
    cfg = CcsConfig(is_bam=False)
    sm = star.StarMsa(cfg.align, device="cpu")
    reqs = []
    for n in (5, 9, 6):
        tpl = rng.integers(0, 4, 700).astype(np.uint8)
        ps = [synth.mutate(rng, tpl, 0.02, 0.05, 0.05) for _ in range(n)]
        qs, qlens, mask = sm.pack(ps, cfg.pass_buckets, cfg.max_passes)
        reqs.append(star.RefineRequest(qs, qlens, mask, ps[0], 2))
    qmax = reqs[0].qs.shape[1]
    tmax = batch._fused_tmax(max(len(r.draft) for r in reqs), 512)
    ex = batch.BatchExecutor(cfg, device="cpu")
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            ex._stack_slab(reqs, range(len(reqs)), qmax, tmax)]
    H = args[4].shape[0]
    for impl in ("", "rotband"):
        core = batch._refine_core_packed(AlignParams(), 4, tmax, 2, H,
                                         ex._bp_consts(), impl)
        want = core(*args)
        got = core(*[a.to(cuda) for a in args])
        for w, g in zip(want, got):
            assert torch.equal(g.cpu(), w), impl


def test_bucketed_refine_step_on_card_matches_cpu(cuda):
    """One bucketed (Z, P) refine step (pad passes, an empty hole, iters 2)
    on the card against the same step on the CPU, under both global-fill
    arms, through the one-buffer transfer protocol."""
    rng = np.random.default_rng(9)
    P, qmax, tmax = 8, 1024, 1536
    Z = 3
    qs = np.full((Z, P, qmax), 5, np.uint8)
    qlens = np.zeros((Z, P), np.int32)
    ts = np.full((Z, tmax), 5, np.uint8)
    tlens = np.ones(Z, np.int32)
    for z, n in enumerate((5, 8, 0)):
        tpl = rng.integers(0, 4, 800).astype(np.uint8)
        ps = [synth.mutate(rng, tpl, 0.02, 0.05, 0.05) for _ in range(n)]
        for k, p in enumerate(ps):
            qs[z, k, :len(p)] = p
            qlens[z, k] = len(p)
        if ps:
            ts[z, :len(ps[0])] = ps[0]
            tlens[z] = len(ps[0])
    buf = batch._pack_args((qs, qlens, ts, tlens, qlens > 0))
    for impl in ("", "rotband"):
        step = batch._refine_step(AlignParams(), 4, tmax, 2,
                                  (10, 5, 80, 80, 60), (P, qmax), impl)
        assert torch.equal(step(buf.to(cuda)).cpu(), step(buf)), impl


@pytest.mark.parametrize("group", ["long", "mixed"])
def test_seed_and_screen_steps_on_card_match_cpu(group, cuda):
    """The device screen and seeder on the card against the same tensor
    ops on the CPU: a group of 50 kb strand-walk pairs (forward, wrong
    strand, unrelated), and a mixed group with N bases, a repeat-heavy
    template and a query with no 13-mer."""
    rng = np.random.default_rng(13)
    L = 50000 if group == "long" else 3000
    t = rng.integers(0, 4, L).astype(np.uint8)
    fwd = synth.mutate(rng, t, 0.01, 0.02, 0.02)
    pairs = [(fwd, t), (enc.revcomp_codes(fwd), t),
             (rng.integers(0, 4, L).astype(np.uint8), t)]
    if group == "mixed":
        rep = np.tile(rng.integers(0, 4, 23).astype(np.uint8), L // 23 + 1)[:L]
        nq = fwd.copy()
        nq[rng.random(len(nq)) < 0.05] = 4
        pairs += [(synth.mutate(rng, rep, 0.02, 0.05, 0.05), rep), (nq, t),
                  (np.full(700, 4, np.uint8), t)]
    qmax = star.bucket_len(max(len(q) for q, _ in pairs), 512)
    tmax = star.bucket_len(max(len(tt) for _, tt in pairs), 512)
    big = np.full((len(pairs), qmax + tmax), 5, np.uint8)
    small = np.zeros((len(pairs), 2), np.int32)
    for z, (q, tt) in enumerate(pairs):
        big[z, :len(q)] = q
        big[z, qmax:qmax + len(tt)] = tt
        small[z] = len(q), len(tt)
    b, s = torch.from_numpy(big), torch.from_numpy(small)
    for mod, name in ((sketch, "screen_step"), (seed_device, "seed_step")):
        step = getattr(mod, name)(qmax, tmax)
        assert torch.equal(step(b.to(cuda), s.to(cuda)).cpu(), step(b, s)), \
            name
    hit = seed_device.hit_from_row(
        seed_device.seed_step(qmax, tmax)(b.to(cuda), s.to(cuda))[0].cpu())
    want = seed.seed_diagonal(fwd, t)
    assert (hit.diag, hit.votes) == (want.diag, want.votes)


@pytest.mark.parametrize("n", [1, 3])
def test_pair_fill_group_on_card_matches_cpu(n, cuda):
    """The strand walk's batched local fill on the card, a one-pair group
    (whose column slices keep the wire buffer's strides) included."""
    rng = np.random.default_rng(7)
    t = rng.integers(0, 4, 900).astype(np.uint8)
    big = np.full((n, 1024 + 1024), 5, np.uint8)
    small = np.zeros((n, 6), np.int32)
    for z in range(n):
        q = synth.mutate(rng, t, 0.02, 0.05, 0.05)
        big[z, :len(q)] = q
        big[z, 1024:1024 + len(t)] = t
        small[z] = [len(q), len(t), 0, 0, len(q), len(t)]
    before = cuda_ext.LAUNCHES["banded_local"]
    got = batch._pair_fill_packed(AlignParams(), 1024, 1024, cuda)(big, small)
    assert cuda_ext.LAUNCHES["banded_local"] == before + 1
    want = batch._pair_fill_packed(AlignParams(), 1024, 1024, "cpu")(
        big, small)
    assert torch.equal(got.cpu(), want)


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


def _global_equal(got, want):
    (ks, km, ko), (pr, pm, po) = got, want
    assert torch.equal(ks.cpu(), pr.score)
    assert torch.equal(ko.cpu(), po)
    assert torch.equal(km.cpu(), pm)     # rows beyond qlen are zero in both


def test_fills_on_tie_cases_match_plain(cuda):
    """Homopolymers, all-equal and all-mismatch pairs, repeats, qlen 0, 1
    and == qmax, tlen < 128, a band clipped at tcap, seeded lines with
    li0 > 1 and a falling one, and pairs where each level of the F scan's
    tie rule decides the local statistics (synth.fill_tie_cases); the local
    fill with packed and with unpacked statistics."""
    qs, qlens, ts, tlens, lines = (torch.from_numpy(x) for x in
                                   synth.fill_tie_cases(
                                       np.random.default_rng(31)))
    dev = [x.to(cuda) for x in (qs, qlens, ts, tlens, lines)]
    _global_equal(banded_cuda.batched_align_global_moves(*dev[:4]),
                  banded.banded_global_moves(qs, qlens, ts, tlens))
    # a template row padded to 32,768 bytes takes the local fill's body
    # with unpacked statistics (qmax + tmax + 128 >= 32768)
    wide = torch.full((len(ts), 32768), 5, dtype=torch.uint8)
    wide[:, :ts.shape[1]] = ts
    for t_in in (ts, wide):
        for ln in (None, lines):
            got = banded_cuda.batched_align_local(
                dev[0], dev[1], t_in.to(cuda), dev[3],
                None if ln is None else ln.to(cuda))
            want = banded.banded_local(qs, qlens, t_in, tlens, ln)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("warps", [1, 2, 4])
def test_fills_part_filled_blocks_match_plain(warps, cuda):
    """One problem, and warps + 1 problems (a part-filled last block), at
    each number of problems per block."""
    qs, qlens, ts, tlens, lines = (torch.from_numpy(x) for x in
                                   synth.fill_tie_cases(
                                       np.random.default_rng(8)))
    for n in (1, warps + 1):
        sel = [x[-n:].contiguous() for x in (qs, qlens, ts, tlens, lines)]
        dev = [x.to(cuda) for x in sel]
        score, moves, offs = banded_cuda.launch_variant(*dev[:4], warps)
        _global_equal((score, moves, offs),
                      banded.banded_global_moves(*sel[:4]))
        want = torch.stack(list(banded.banded_local(*sel)))
        got = banded_cuda.launch_variant(*dev[:4], warps, dev[4])
        assert torch.equal(got.cpu(), want), n


def test_fills_long_window_match_plain(cuda):
    """A final-flush-sized window: more than 4096 query rows (past the
    Pallas kernel's cap), the template a row of an odd-width buffer so
    its rows are not word-aligned."""
    rng = np.random.default_rng(9)
    t = rng.integers(0, 4, 4500).astype(np.uint8)
    q = synth.mutate(rng, t, 0.02, 0.05, 0.05)
    qmax, tmax = len(q) + 3, 4733
    qs = torch.full((2, qmax), 5, dtype=torch.uint8)
    ts = torch.full((2, tmax), 5, dtype=torch.uint8)
    qs[0, :len(q)] = torch.from_numpy(q)
    qs[1, :300] = torch.from_numpy(q[1000:1300])
    ts[:, :len(t)] = torch.from_numpy(t)
    qlens = torch.tensor([len(q), 300], dtype=torch.int32)
    tlens = torch.full((2,), len(t), dtype=torch.int32)
    dev = [x.to(cuda) for x in (qs, qlens, ts, tlens)]
    _global_equal(banded_cuda.batched_align_global_moves(*dev),
                  banded.banded_global_moves(qs, qlens, ts, tlens))
    lines = torch.tensor([[0, 0, len(q), len(t)], [1, 1000, 300, 1300]],
                         dtype=torch.int32)
    got = banded_cuda.batched_align_local(*dev, lines.to(cuda))
    want = banded.banded_local(qs, qlens, ts, tlens, lines)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _walk_equal(cuda, moves, offs, qs, qlens, tlens, tmax, max_ins):
    """The walk kernel on the card against project_plain on the host: exact
    equality of all four outputs; one counted launch."""
    host = [torch.from_numpy(np.ascontiguousarray(x)) if isinstance(
        x, np.ndarray) else x.cpu() for x in (moves, offs, qs, qlens, tlens)]
    before = cuda_ext.LAUNCHES["traceback_walk"]
    got = traceback.project(*[x.to(cuda) for x in host], tmax, max_ins)
    assert cuda_ext.LAUNCHES["traceback_walk"] == before + 1
    want = traceback.project_plain(*host, tmax, max_ins)
    for name, g, w in zip(("aligned", "ins_cnt", "ins_b", "lead_ins"), got,
                          want):
        assert torch.equal(g.cpu(), w), name


@pytest.mark.parametrize("max_ins", [1, 4, 16])
def test_walk_random_bytes_match_plain(max_ins, cuda):
    """Move bytes no fill produces (choice 3, random E/F and high bits),
    offsets that are non-monotone or put the lanes out of [0, 127], lengths
    0, at the padded widths, negative and beyond them; through the bulk
    copy (qmax 256) and the plain loads (qmax 203)."""
    for seed, qmax, tmax in ((5, 256, 320), (6, 203, 251)):
        cases = synth.walk_cases(np.random.default_rng(seed), qmax, tmax)
        _walk_equal(cuda, *cases, tmax, max_ins)


def test_walk_edge_batch_matches_plain(cuda):
    """The fill's moves of the tie cases (qlen 0, 1 and == qmax, tlen < 128,
    a clipped band) and of a >4096-row window at an odd qmax."""
    qs, qlens, ts, tlens, _ = (torch.from_numpy(x) for x in
                               synth.fill_tie_cases(np.random.default_rng(31)))
    _, mv, of = banded.banded_global_moves(qs, qlens, ts, tlens)
    _walk_equal(cuda, mv, of, qs, qlens, tlens, ts.shape[1], 4)
    rng = np.random.default_rng(9)
    t = rng.integers(0, 4, 4500).astype(np.uint8)
    q = synth.mutate(rng, t, 0.02, 0.05, 0.05)
    qmax, tmax = len(q) + 3, 4733
    qs = torch.full((2, qmax), 5, dtype=torch.uint8)
    ts = torch.full((2, tmax), 5, dtype=torch.uint8)
    qs[0, :len(q)] = torch.from_numpy(q)
    qs[1, :300] = torch.from_numpy(q[1000:1300])
    ts[:, :len(t)] = torch.from_numpy(t)
    qlens = torch.tensor([len(q), 300], dtype=torch.int32)
    tlens = torch.full((2,), len(t), dtype=torch.int32)
    _, mv, of = banded_cuda.batched_align_global_moves(
        *[x.to(cuda) for x in (qs, qlens, ts, tlens)])
    _walk_equal(cuda, mv, of, qs, qlens, tlens, tmax, 4)


def test_walk_more_passes_than_sms(cuda):
    """R = 200 passes in one launch (more blocks than the card's 132 SMs):
    the fill's moves of noisy passes, and random bytes."""
    rng = np.random.default_rng(10)
    t, qs, qlens = _passes(rng, 200, 450, 512)
    tmax = 640
    ts = torch.from_numpy(np.pad(t, (0, tmax - len(t)), constant_values=5)
                          )[None].expand(200, tmax).contiguous()
    tlens = torch.full((200,), len(t), dtype=torch.int32)
    _, mv, of = banded_cuda.batched_align_global_moves(
        torch.from_numpy(qs).to(cuda), torch.from_numpy(qlens).to(cuda),
        ts.to(cuda), tlens.to(cuda))
    _walk_equal(cuda, mv, of, qs, qlens, tlens, tmax, 4)
    cases = synth.walk_cases(rng, 512, tmax, n=200)
    _walk_equal(cuda, *cases, tmax, 4)


@pytest.mark.parametrize("ring", [(32, 2, 96), (32, 8, 128), (64, 4, 96),
                                  (64, 8, 96)])
def test_walk_ring_choices_match_plain(ring, cuda):
    """Each ring the launch may choose (rows per stage, stages, threads)
    on the random-bytes corpus; 64 rows on 8 stages needs more than 48 KB
    of shared memory."""
    cases = synth.walk_cases(np.random.default_rng(11), 256, 320)
    host = [torch.from_numpy(x) for x in cases]
    got = traceback.launch_variant(*[x.to(cuda) for x in host], 320, 4, *ring)
    want = traceback.project_plain(*host, 320, 4)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), ring


# ---- the refine programs: CUDA graphs (pipeline/graphs.py) -----------------

def _refine_slabs(rng, cfg, n_slabs=2, tmax=1536):
    """``n_slabs`` packed slabs of one shape (three holes of ~700 bp, qmax
    1024)."""
    sm = star.StarMsa(cfg.align, device="cpu")
    ex = batch.BatchExecutor(cfg, device="cpu")
    slabs = []
    for _ in range(n_slabs):
        reqs = []
        for n in (5, 9, 6):
            tpl = rng.integers(0, 4, 700).astype(np.uint8)
            ps = [synth.mutate(rng, tpl, 0.02, 0.05, 0.05) for _ in range(n)]
            qs, qlens, mask = sm.pack(ps, cfg.pass_buckets, cfg.max_passes)
            reqs.append(star.RefineRequest(qs, qlens, mask, ps[0], 2))
        slabs.append(ex._stack_slab(reqs, range(len(reqs)), 1024, tmax))
    return ex, slabs


@pytest.mark.parametrize("impl", ["", "rotband"])
def test_packed_program_replays_match_the_eager_step(impl, cuda):
    """Two same-shape slabs through one captured program, both dispatched
    before either is read: each equals the eager early-exit step on the
    CPU; a replay adds (iters + 1) global-fill and walk launches, and the
    build adds none."""
    from ccsx_tpu_torch.pipeline import graphs

    cfg = CcsConfig(is_bam=False, banded_impl=impl)
    _, slabs = _refine_slabs(np.random.default_rng(12), cfg)
    ex = batch.BatchExecutor(cfg, device="cuda")
    R, H = slabs[0][0].shape[0], slabs[0][4].shape[0]
    fill = "banded_rotband" if impl else "banded_global"
    cuda_ext.reset_counts()
    prog = ex._packed_program(1024, 1536, 2, R, H)
    assert prog.graph is not None and sum(cuda_ext.LAUNCHES.values()) == 0
    assert prog.launches == {fill: 3, "traceback_walk": 3}
    outs = [prog.run(*batch._pack_slab_args(a, pin=True)) for a in slabs]
    assert cuda_ext.LAUNCHES[fill] == cuda_ext.LAUNCHES["traceback_walk"] == 6
    for out, args in zip(outs, slabs):
        step = batch._refine_step_packed(AlignParams(), 4, 1536, 2, H,
                                         ex._bp_consts(), (R, 1024), impl)
        want = step(*batch._pack_slab_args(args))
        assert torch.equal(out.cpu(), want), impl
    assert graphs.stats()[prog.key]["replays"] >= 2


def test_bucketed_program_replay_matches_the_eager_step(cuda):
    cfg = CcsConfig(is_bam=False)
    rng = np.random.default_rng(13)
    P, qmax, tmax, Z = 8, 1024, 1536, 3
    qs = np.full((Z, P, qmax), 5, np.uint8)
    qlens = np.zeros((Z, P), np.int32)
    ts = np.full((Z, tmax), 5, np.uint8)
    tlens = np.ones(Z, np.int32)
    for z, n in enumerate((5, 8, 0)):
        tpl = rng.integers(0, 4, 800).astype(np.uint8)
        ps = [synth.mutate(rng, tpl, 0.02, 0.05, 0.05) for _ in range(n)]
        for k, p in enumerate(ps):
            qs[z, k, :len(p)] = p
            qlens[z, k] = len(p)
        if ps:
            ts[z, :len(ps[0])] = ps[0]
            tlens[z] = len(ps[0])
    buf = batch._pack_args((qs, qlens, ts, tlens, qlens > 0))
    prog = batch.BatchExecutor(cfg, device="cuda")._bucketed_program(
        P, qmax, tmax, 2, Z)
    assert prog.graph is not None
    step = batch._refine_step(AlignParams(), 4, tmax, 2, (10, 5, 80, 80, 60),
                              (P, qmax))
    assert torch.equal(prog.run(buf.pin_memory()).cpu(), step(buf))


def test_capture_on_a_thread_while_another_launches(cuda):
    """A program captured on a second thread while this thread launches
    torch ops and the local fill and reads results back (the warmup thread
    against the driver and the prep pool's pump): the capture succeeds and
    its replay equals the eager step (a tmax no other test builds, so the
    capture happens here)."""
    cfg = CcsConfig(is_bam=False, slab_rows=64)
    rng = np.random.default_rng(14)
    _, slabs = _refine_slabs(rng, cfg, 1, tmax=2048)
    R, H = slabs[0][0].shape[0], slabs[0][4].shape[0]
    ex = batch.BatchExecutor(cfg, device="cuda")
    t, qs, qlens = _passes(rng, 16, 600, 1024)
    q, ql = torch.from_numpy(qs).to(cuda), torch.from_numpy(qlens).to(cuda)
    tt = torch.from_numpy(np.pad(t, (0, 1024 - len(t)),
                                 constant_values=5))[None].expand(16, 1024)
    tt = tt.contiguous().to(cuda)
    tl = torch.full((16,), len(t), dtype=torch.int32, device=cuda)
    box = {}

    def build():
        try:
            box["prog"] = ex._packed_program(1024, 2048, 2, R, H)
        except BaseException as e:        # re-raised below
            box["err"] = e

    th = threading.Thread(target=build)
    th.start()
    while th.is_alive():
        r = banded_cuda.batched_align_local(q, ql, tt, tl)
        (q.float().cumsum(1).sum() + r.score.sum()).cpu()
    th.join()
    if "err" in box:
        raise box["err"]
    out = box["prog"].run(*batch._pack_slab_args(slabs[0], pin=True))
    step = batch._refine_step_packed(AlignParams(), 4, 2048, 2, H,
                                     ex._bp_consts(), (R, 1024))
    assert torch.equal(out.cpu(), step(*batch._pack_slab_args(slabs[0])))


def test_no_replay_comes_between_another_replay_and_its_clone(cuda):
    """Two programs captured one after the other into a fresh shared pool
    (the second's static output may lie where the first keeps
    intermediates).  A warm replay of the first, started on another thread
    (the warmup thread) while the second's replay is launched and its
    output not yet cloned, waits for that clone; the second's output
    equals the eager step's."""
    from ccsx_tpu_torch.pipeline import graphs

    graphs.clear()
    cfg = CcsConfig(is_bam=False)
    rng = np.random.default_rng(16)
    (_, first), (_, second) = (_refine_slabs(rng, cfg, 1, tmax=t)
                               for t in (3072, 1536))
    ex = batch.BatchExecutor(cfg, device="cuda")
    R, H = second[0][0].shape[0], second[0][4].shape[0]
    a = ex._packed_program(1024, 3072, 2, first[0][0].shape[0],
                           first[0][4].shape[0])
    b = ex._packed_program(1024, 1536, 2, R, H)
    graph, box = b.graph, {}

    class Between:
        """b's graph: after its replay is launched, a's warm replay starts
        on another thread and is given half a second to finish."""

        def replay(self):
            graph.replay()
            th = box["thread"] = threading.Thread(target=a.warm)
            th.start()
            th.join(timeout=0.5)
            box["waited"] = th.is_alive()

    b.graph = Between()
    try:
        out = b.run(*batch._pack_slab_args(second[0], pin=True))
    finally:
        b.graph = graph
        box["thread"].join()
    step = batch._refine_step_packed(AlignParams(), 4, 1536, 2, H,
                                     ex._bp_consts(), (R, 1024))
    same = torch.equal(out.cpu(), step(*batch._pack_slab_args(second[0])))
    # (a's replay waited for b's clone, b's output is the eager step's)
    assert (box["waited"], same) == (True, True)


def test_clear_waits_for_another_threads_replay_and_its_clone(cuda):
    """graphs.clear from another thread (a sibling served job's OOM resplit)
    while a program's replay is launched and its output not yet cloned:
    the clear waits for that clone, the output equals the eager step's, and
    then every program is gone."""
    from ccsx_tpu_torch.pipeline import graphs

    graphs.clear()
    cfg = CcsConfig(is_bam=False)
    _, slabs = _refine_slabs(np.random.default_rng(17), cfg, 1, tmax=1536)
    ex = batch.BatchExecutor(cfg, device="cuda")
    R, H = slabs[0][0].shape[0], slabs[0][4].shape[0]
    b = ex._packed_program(1024, 1536, 2, R, H)
    graph, box = b.graph, {}

    class Between:
        """b's graph: after its replay is launched, another thread clears
        the programs and is given half a second to finish."""

        def replay(self):
            graph.replay()
            th = box["thread"] = threading.Thread(target=graphs.clear)
            th.start()
            th.join(timeout=0.5)
            box["waited"] = th.is_alive()

    b.graph = Between()
    try:
        out = b.run(*batch._pack_slab_args(slabs[0], pin=True))
    finally:
        b.graph = graph
        box["thread"].join()
    step = batch._refine_step_packed(AlignParams(), 4, 1536, 2, H,
                                     ex._bp_consts(), (R, 1024))
    same = torch.equal(out.cpu(), step(*batch._pack_slab_args(slabs[0])))
    assert (box["waited"], same, len(graphs._programs)) == (True, True, 0)


def test_dispatch_runs_eagerly_then_replays_a_graph(cuda, monkeypatch):
    """graphs.dispatch with CAPTURE_AT 2 on three same-shape slabs: the
    first runs the step eagerly, the second captures the graph from the
    same step without a priming run and replays it, the third replays it;
    each equals the eager step on the CPU.  Launches: iters + 1 global
    fills and walks for the eager run and for each replay.  The program
    captured into the card's one shared pool."""
    from ccsx_tpu_torch.pipeline import graphs

    monkeypatch.setattr(graphs, "CAPTURE_AT", 2)
    cfg = CcsConfig(is_bam=False)
    _, slabs = _refine_slabs(np.random.default_rng(15), cfg, 3, tmax=2560)
    ex = batch.BatchExecutor(cfg, device="cuda")
    R, H = slabs[0][0].shape[0], slabs[0][4].shape[0]
    spec = ex._packed_spec(1024, 2560, 2, R, H)
    graphs.reset_stats()
    cuda_ext.reset_counts()
    outs = [graphs.dispatch(*spec, cuda, *batch._pack_slab_args(a, pin=True))
            for a in slabs]
    st = graphs.stats()[spec[0]]
    assert (st["eager"], st["builds"], st["graph"], st["replays"]) == \
        (1, 1, True, 2)
    assert st["prime_launches"] == {}
    assert st["eager_launches"] == st["launches"] == {
        "banded_global": 3, "traceback_walk": 3}
    assert cuda_ext.LAUNCHES["banded_global"] == 9
    assert cuda_ext.LAUNCHES["traceback_walk"] == 9
    prog = graphs._programs[spec[0]]
    # the pool of card 0's lane 0 (the executor without a mesh)
    assert tuple(prog.graph.pool()) == tuple(graphs._pools[(0, 0)])
    for out, args in zip(outs, slabs):
        step = batch._refine_step_packed(AlignParams(), 4, 2560, 2, H,
                                         ex._bp_consts(), (R, 1024))
        assert torch.equal(out.cpu(), step(*batch._pack_slab_args(args)))


def test_oom_inside_a_capture_resplits_with_the_same_bytes(
        cuda, tmp_path, monkeypatch, capsys):
    """An out-of-memory error raised inside a CUDA graph capture reaches
    the resplit ladder as itself: the programs are dropped, the slab's
    halves are captured afresh, and the run gives the CPU run's bytes (rc
    0, no per-request replay, no abort)."""
    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.pipeline import graphs

    rng = np.random.default_rng(21)
    zs = [synth.make_zmw(rng, template_len=700, n_passes=5 + h % 3,
                         movie="mv", hole=str(h)) for h in range(6)]
    fa = tmp_path / "in.fa"
    fa.write_text(synth.make_fasta(zs))
    flags = ["-A", "-m", "500", "--batch", "on", "--prep-threads", "0"]
    ref = tmp_path / "ref.fa"
    assert cli.main([*flags, "--device", "cpu", str(fa), str(ref)]) == 0
    real, real_clear = batch._refine_step_packed, graphs.clear
    fired, clears = [], []

    def oom_in_capture(*a, **k):
        step = real(*a, **k)

        def wrapped(big, small):
            if torch.cuda.is_current_stream_capturing() and not fired:
                fired.append(1)
                raise torch.cuda.OutOfMemoryError("injected in a capture")
            return step(big, small)
        return wrapped

    def clear():
        clears.append(1)
        real_clear()

    real_clear()
    monkeypatch.setattr(graphs, "CAPTURE_AT", 1)   # capture at dispatch 1
    monkeypatch.setattr(graphs, "clear", clear)
    monkeypatch.setattr(batch, "_refine_step_packed", oom_in_capture)
    graphs.reset_stats()
    out = tmp_path / "o.fa"
    assert cli.main([*flags, "--device", "cuda", str(fa), str(out)]) == 0
    err = capsys.readouterr().err
    assert fired and clears
    assert "resplitting" in err
    assert "replaying" not in err and "device failure" not in err
    assert out.read_bytes() == ref.read_bytes()
    assert any(v["graph"] and v["replays"] for v in graphs.stats().values())


# ---- logical devices on the card (parallel/mesh.py) -------------------------

def _window_requests(rng, cfg, kind, specs=((3, 500), (5, 500), (9, 500),
                                            (11, 500), (6, 700))):
    sm = star.StarMsa(cfg.align, device="cpu")
    out = []
    for n, tlen in specs:
        tpl = rng.integers(0, 4, tlen).astype(np.uint8)
        ps = [synth.mutate(rng, tpl, 0.03, 0.03, 0.03) for _ in range(n)]
        qs, qlens, mask = sm.pack(ps, cfg.pass_buckets, cfg.max_passes)
        out.append(kind(qs, qlens, mask, ps[0], 2))
    return out


def _same_refine(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.draft, w.draft)
        assert (g.rr.tlen, g.rr.bp) == (w.rr.tlen, w.rr.bp)
        for name in ("cons", "ins_base", "ins_votes", "ncov", "nwin",
                     "advance"):
            np.testing.assert_array_equal(getattr(g.rr, name),
                                          getattr(w.rr, name), err_msg=name)


@pytest.mark.parametrize("impl", ["", "rotband"])
def test_two_logical_devices_fused_match_one_device(impl, cuda):
    """``[cuda:0] * 2``: a wave's two slabs on two streams of the card, each
    with its own refine programs and pool, twice over (eager, then a
    capture and replays), give one device's results; each logical device
    launches the kernels of its own slabs."""
    cfg = CcsConfig(is_bam=False, slab_rows=16, banded_impl=impl)
    reqs = _window_requests(np.random.default_rng(21), cfg,
                            star.RefineRequest)
    cuda0 = torch.device("cuda", 0)
    want = batch.BatchExecutor(cfg, device="cuda", devices=[cuda0]).run(
        list(reqs))
    fill = "banded_rotband" if impl else "banded_global"
    for _ in range(3):
        cuda_ext.reset_counts()
        got = batch.BatchExecutor(cfg, device="cuda",
                                  devices=[cuda0] * 2).run(list(reqs))
        _same_refine(got, want)
        lanes = cuda_ext.LANE_LAUNCHES
        assert sorted(lanes) == [0, 1]
        assert sum(v[fill] for v in lanes.values()) == \
            cuda_ext.LAUNCHES[fill] > 0
        assert all(v[fill] == v["traceback_walk"] > 0
                   for v in lanes.values())


def test_two_logical_devices_fused_warmup_match_one_device(cuda):
    """``[cuda:0] * 2`` under --warmup: the warmup thread builds and warms
    each shape's program on both logical devices, each on its own stream
    and pool, while the driver waits for it; no wave runs eagerly and the
    results are one device's."""
    from ccsx_tpu_torch.pipeline import graphs
    from ccsx_tpu_torch.pipeline.warmup import WarmupCompiler

    cfg = CcsConfig(is_bam=False, slab_rows=16)
    reqs = _window_requests(np.random.default_rng(23), cfg,
                            star.RefineRequest)
    cuda0 = torch.device("cuda", 0)
    want = batch.BatchExecutor(cfg, device="cuda", devices=[cuda0]).run(
        list(reqs))
    graphs.clear()
    graphs.reset_stats()
    wc = WarmupCompiler()
    try:
        ex = batch.BatchExecutor(cfg, device="cuda", warmup=wc,
                                 devices=[cuda0] * 2)
        for i, req in enumerate(reqs):
            ex.warm_refine(req, hole_id=i)
        got = ex.run(list(reqs))
    finally:
        wc.close()
    _same_refine(got, want)
    progs = {k: v for k, v in graphs.stats().items()
             if k[0] == "refine_packed"}
    assert {k[-1] for k in progs} == {1, 2}
    assert all(v["graph"] and not v["eager"] and v["warm_replays"]
               for v in progs.values())
    assert sum(v["replays"] for v in progs.values()) > 0


def test_eight_logical_devices_mesh_match_one_device(cuda):
    """--mesh 4,2 over ``[cuda:0] * 8``: bare rounds and refine requests
    equal the single-device bucketed executor's; every entry launches the
    fill and the walk once a round of its data shard."""
    cfg = CcsConfig(is_bam=False, mesh_shape=(4, 2))
    one = CcsConfig(is_bam=False, pass_packing=False)
    rng = np.random.default_rng(22)
    cuda0 = torch.device("cuda", 0)
    refs = _window_requests(rng, cfg, star.RefineRequest)
    want = batch.BatchExecutor(one, device="cuda", devices=[cuda0]).run(
        list(refs))
    cuda_ext.reset_counts()
    ex = batch.BatchExecutor(cfg, device="cuda", devices=[cuda0] * 8)
    assert ex._mesh is not None and not ex.packing
    _same_refine(ex.run(list(refs)), want)
    per = [v["banded_global"] for _, v in sorted(
        cuda_ext.LANE_LAUNCHES.items())]
    assert len(per) == 8 and len(set(per)) == 1 and per[0] > 0
    rounds = _window_requests(rng, cfg, lambda q, ql, m, d, _:
                              star.RoundRequest(q, ql, m, d))
    want = batch.BatchExecutor(one, device="cuda", devices=[cuda0]).run(
        list(rounds))
    got = ex.run(list(rounds))
    for g, w in zip(got, want):
        assert (g.tlen, g.bp) == (w.tlen, w.bp)
        for name in ("cons", "ins_base", "ins_votes", "ncov", "nwin",
                     "advance"):
            np.testing.assert_array_equal(getattr(g, name),
                                          getattr(w, name), err_msg=name)
