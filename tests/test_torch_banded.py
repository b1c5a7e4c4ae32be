"""Parity: the port's plain banded fills against the JAX package.

Inputs come from numpy seeds and go through both packages; every output
is an integer or a byte, so the tolerance is exact equality.  The global
fill is held against the lax.scan spec (ops/banded.make_batched) and the
Pallas kernel itself (interpret mode on the CPU); moves of rows beyond a
problem's qlen are unspecified and not compared, offsets are compared in
full.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.ops import banded as jbanded
from ccsx_tpu.ops import banded_pallas
from ccsx_tpu.ops import encode as jenc
from ccsx_tpu.ops import oracle as joracle
from ccsx_tpu.ops import seed as jseed
from ccsx_tpu.utils import synth

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.ops import banded, banded_cuda, oracle

PAD = 5


def _random_case(rng, Qmax, Tmax, tmin=40, tspan=160):
    tl = int(rng.integers(tmin, tmin + tspan))
    tpl = rng.integers(0, 4, tl).astype(np.uint8)
    q = synth.mutate(rng, tpl, 0.03, 0.05, 0.05)[:Qmax]
    qs = np.full(Qmax, PAD, np.uint8)
    qs[: len(q)] = q
    ts = np.full(Tmax, PAD, np.uint8)
    ts[:tl] = tpl
    return qs, len(q), ts, tl


def _batch(cases):
    qs = np.stack([c[0] for c in cases])
    qlens = np.array([c[1] for c in cases], np.int32)
    ts = np.stack([c[2] for c in cases])
    tlens = np.array([c[3] for c in cases], np.int32)
    return qs, qlens, ts, tlens


def _edge_batch(rng, Qmax=128, Tmax=256):
    """qlen 0 (a padding row), a tiny query, qlen == qmax, and a pair whose
    band cannot reach column tlen (score NEG)."""
    tl = 100
    tpl = rng.integers(0, 4, tl).astype(np.uint8)
    cases = []
    empty = np.full(Qmax, PAD, np.uint8)
    cases.append((empty, 0, np.pad(tpl, (0, Tmax - tl), constant_values=PAD), tl))
    tiny = empty.copy()
    tiny[:5] = tpl[:5]
    cases.append((tiny, 5, cases[0][2], tl))
    full = synth.mutate(rng, tpl, 0.02, 0.3, 0.02)
    full = np.concatenate([full, rng.integers(0, 4, Qmax).astype(np.uint8)])
    cases.append((full[:Qmax].copy(), Qmax, cases[0][2], tl))
    far = empty.copy()
    far[:10] = rng.integers(0, 4, 10)
    ts_far = rng.integers(0, 4, Tmax).astype(np.uint8)
    cases.append((far, 10, ts_far, Tmax))
    return _batch(cases)


def _port_global(qs, qlens, ts, tlens):
    score, moves, offs = banded_cuda.batched_align_global_moves(
        torch.from_numpy(qs), torch.from_numpy(qlens), torch.from_numpy(ts),
        torch.from_numpy(tlens), AlignParams())
    return score.numpy(), moves.numpy(), offs.numpy()


def _assert_global_equal(ref, got, qlens):
    (s1, m1, o1), (s2, m2, o2) = ref, got
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(o1, o2)
    for i, ql in enumerate(qlens):
        np.testing.assert_array_equal(m1[i, :ql], m2[i, :ql],
                                      err_msg=f"moves mismatch, problem {i}")


@pytest.fixture(scope="module")
def scan_global():
    return jbanded.make_batched("global", JaxParams(), with_moves=True,
                                with_stats=False)


@pytest.mark.parametrize("corpus", ["random", "edges"])
def test_global_moves_match_scan_spec(corpus, scan_global):
    rng = np.random.default_rng(7 if corpus == "random" else 11)
    if corpus == "random":
        qs, qlens, ts, tlens = _batch(
            [_random_case(rng, 256, 256) for _ in range(5)])
    else:
        qs, qlens, ts, tlens = _edge_batch(rng)
    r, m, o = scan_global(qs, qlens, ts, tlens)
    ref = (np.asarray(r.score), np.asarray(m), np.asarray(o))
    got = _port_global(qs, qlens, ts, tlens)
    _assert_global_equal(ref, got, qlens)
    if corpus == "edges":
        assert got[0][3] == banded.NEG      # the unreachable band


def test_global_moves_match_pallas_kernel():
    """The Pallas kernel (interpret mode) as the third party."""
    rng = np.random.default_rng(19)
    cases = [_random_case(rng, 128, 256, tmin=40, tspan=80) for _ in range(3)]
    eq, eql, et, etl = _edge_batch(rng)
    qs, qlens, ts, tlens = _batch(cases)
    qs, qlens = np.concatenate([qs, eq]), np.concatenate([qlens, eql])
    ts, tlens = np.concatenate([ts, et]), np.concatenate([tlens, etl])
    r, m, o = banded_pallas.batched_align_global_moves(
        qs, qlens, ts, tlens, JaxParams(), interpret=True, with_stats=False)
    ref = (np.asarray(r.score), np.asarray(m), np.asarray(o))
    _assert_global_equal(ref, _port_global(qs, qlens, ts, tlens), qlens)


def test_global_broadcast_template_matches_full(scan_global):
    """A template broadcast over the batch (stride 0, as the round passes
    it) gives the same fill as the materialized rows."""
    rng = np.random.default_rng(5)
    qs, qlens, ts, tlens = _batch(
        [_random_case(rng, 128, 128, tmin=60, tspan=1) for _ in range(4)])
    ts[:] = ts[0]
    tlens[:] = tlens[0]
    t_b = torch.from_numpy(ts[0])[None].expand(4, 128)
    score, moves, offs = banded_cuda.batched_align_global_moves(
        torch.from_numpy(qs), torch.from_numpy(qlens), t_b,
        torch.from_numpy(tlens))
    _assert_global_equal(_port_global(qs, qlens, ts, tlens),
                         (score.numpy(), moves.numpy(), offs.numpy()),
                         qlens)


def _jax_local(q, ql, t, tl, line):
    return jbanded.banded_align(
        q, np.int32(ql), t, np.int32(tl), mode="local", params=JaxParams(),
        line=None if line is None else np.asarray(line, np.int32))


def _local_pairs(rng):
    """The local-mode corpora of the JAX package's tests: a shared core
    with junk ends, and strand_match pairs (fwd, RC, wrong strand)."""
    pairs = []
    core = rng.integers(0, 4, 60).astype(np.uint8)
    pairs.append((np.concatenate([rng.integers(0, 4, 25).astype(np.uint8), core]),
                  np.concatenate([core, rng.integers(0, 4, 20).astype(np.uint8)])))
    for _ in range(2):
        z = synth.make_zmw(rng, template_len=200, n_passes=2, first_strand=0)
        fwd, rev = z.passes[0], z.passes[1]
        for q in (fwd, jenc.revcomp_codes(rev), rev):
            pairs.append((q, z.template))
    # an off-diagonal pair: the query carries a 300-base prefix, so the
    # seeded line is what puts the band on the path
    t = rng.integers(0, 4, 250).astype(np.uint8)
    q = np.concatenate([rng.integers(0, 4, 300).astype(np.uint8),
                        synth.mutate(rng, t, 0.02, 0.03, 0.03)])
    pairs.append((q, t))
    return pairs


@pytest.mark.parametrize("with_line", [False, True])
def test_local_stats_match_reference(with_line):
    rng = np.random.default_rng(0)
    pairs = _local_pairs(rng)
    qmax, tmax = 768, 256
    qs = np.full((len(pairs), qmax), PAD, np.uint8)
    ts = np.full((len(pairs), tmax), PAD, np.uint8)
    qlens = np.array([len(q) for q, _ in pairs], np.int32)
    tlens = np.array([len(t) for _, t in pairs], np.int32)
    lines = []
    for k, (q, t) in enumerate(pairs):
        qs[k, :len(q)] = q
        ts[k, :len(t)] = t
        hit = jseed.seed_diagonal(q, t) if with_line else None
        lines.append(None if hit is None else hit.line)
    assert not with_line or lines[-1] is not None
    port_lines = torch.from_numpy(np.stack([
        ln if ln is not None else np.array([0, 0, ql, tl], np.int32)
        for ln, ql, tl in zip(lines, qlens, tlens)]))
    got = banded_cuda.batched_align_local(
        torch.from_numpy(qs), torch.from_numpy(qlens), torch.from_numpy(ts),
        torch.from_numpy(tlens), port_lines)
    for k in range(len(pairs)):
        want = _jax_local(qs[k], qlens[k], ts[k], tlens[k], lines[k])
        for field in banded.BandedResult._fields:
            assert int(getattr(got, field)[k]) == int(getattr(want, field)), \
                (k, field)


def test_line_interp_matches_reference_fuzz():
    """The int64 interpolation against the reference's limb arithmetic
    and Python big-int floor division (the JAX package's 3000-case fuzz,
    overflow region and negative rows included)."""
    rng = np.random.default_rng(11)
    denom = rng.integers(1, 300001, 3000)
    span = np.minimum((denom * rng.uniform(0, 8, 3000)).astype(np.int64), 2**21)
    ip = rng.integers(-300000, 300001, 3000)
    want = np.asarray(jbanded._line_interp(
        jnp.asarray(ip, jnp.int32), jnp.asarray(span, jnp.int32),
        jnp.asarray(denom, jnp.int32)))
    got = banded.line_interp(torch.from_numpy(ip), torch.from_numpy(span),
                             torch.from_numpy(denom)).numpy()
    np.testing.assert_array_equal(got, want)
    exact = [(int(a) * int(b)) // int(c) for a, b, c in zip(ip, span, denom)]
    np.testing.assert_array_equal(got, np.array(exact))


@pytest.mark.parametrize("mode", ["global", "qfree", "local"])
def test_oracle_copy_matches_reference(mode):
    """The port's oracle solves each DP row's horizontal gap as a prefix
    max instead of the reference's cell loop: same matrices, so the same
    result, traceback and CIGAR included."""
    rng = np.random.default_rng(29)
    for _ in range(6):
        t = rng.integers(0, 4, int(rng.integers(5, 90))).astype(np.uint8)
        q = synth.mutate(rng, t, 0.05, 0.08, 0.08)
        if rng.random() < 0.3:
            q = rng.integers(0, 5, len(q)).astype(np.uint8)   # N included
        want = joracle.align(q, t, mode=mode)
        got = oracle.align(q, t, mode=mode)
        # two packages, two AlnResult classes: compare the fields
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
