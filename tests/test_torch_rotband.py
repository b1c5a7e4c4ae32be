"""Parity: the port's rotating-band global fill (plain version) against the
JAX package's Pallas rotband kernel (interpret mode on the CPU), the scan
spec and the port's band-local plain fill.

Inputs come from numpy seeds and go through both packages; every output is
an integer or a byte, so the tolerance is exact equality.  Scores and
offsets are compared in full, moves on every live row (the Pallas kernel
leaves rows beyond a problem's qlen unspecified; the port zeroes them, and
against its own band-local fill the port's moves are compared in full).
"""

import numpy as np
import pytest
import torch

from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.ops import banded as jbanded
from ccsx_tpu.ops import banded_rotband as jrot
from ccsx_tpu.utils import synth

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.consensus import star
from ccsx_tpu_torch.ops import banded, banded_rotband, cuda_ext

PAD = 5


def _case(rng, Qmax, Tmax, tmin=40, tspan=60):
    tl = int(rng.integers(tmin, tmin + tspan))
    tpl = rng.integers(0, 4, tl).astype(np.uint8)
    q = synth.mutate(rng, tpl, 0.03, 0.05, 0.05)[:Qmax]
    qs = np.full(Qmax, PAD, np.uint8)
    qs[:len(q)] = q
    ts = np.full(Tmax, PAD, np.uint8)
    ts[:tl] = tpl
    return qs, len(q), ts, tl


def _edges(rng, Qmax, Tmax):
    """qlen 0, a tiny query, qlen == Qmax, and a random query against a
    random template of the full width."""
    tl = 100
    tpl = np.full(Tmax, PAD, np.uint8)
    tpl[:tl] = rng.integers(0, 4, tl)
    empty = np.full(Qmax, PAD, np.uint8)
    tiny = empty.copy()
    tiny[:5] = tpl[:5]
    full = synth.mutate(rng, tpl[:tl], 0.02, 0.3, 0.02)
    full = np.concatenate([full, rng.integers(0, 4, Qmax).astype(np.uint8)])
    far = empty.copy()
    far[:10] = rng.integers(0, 4, 10)
    return [(empty, 0, tpl, tl), (tiny, 5, tpl, tl),
            (full[:Qmax].copy(), Qmax, tpl, tl),
            (far, 10, rng.integers(0, 4, Tmax).astype(np.uint8), Tmax)]


def _stack(cases):
    return (np.stack([c[0] for c in cases]),
            np.array([c[1] for c in cases], np.int32),
            np.stack([c[2] for c in cases]),
            np.array([c[3] for c in cases], np.int32))


def _port(qs, qlens, ts, tlens):
    s, m, o = banded_rotband.batched_align_global_moves(
        *(torch.from_numpy(x) for x in (qs, qlens, ts, tlens)),
        AlignParams())
    return s.numpy(), m.numpy(), o.numpy()


def _assert_equal(ref, got, qlens, full_moves=False):
    (s1, m1, o1), (s2, m2, o2) = ref, got
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(o1, o2)
    if full_moves:
        np.testing.assert_array_equal(m1, m2)
    for i, ql in enumerate(qlens):
        np.testing.assert_array_equal(m1[i, :ql], m2[i, :ql],
                                      err_msg=f"moves, problem {i}")


@pytest.fixture(scope="module")
def batch():
    """N = 10 problems (not a multiple of the Pallas G-block of 8) with
    their own templates, plus the edge cases: Qmax = Tmax = 128."""
    rng = np.random.default_rng(41)
    cases = [_case(rng, 128, 128) for _ in range(10)] + _edges(rng, 128, 128)
    return _stack(cases)


def test_rotband_plain_matches_pallas_rotband_interpret(batch):
    qs, qlens, ts, tlens = batch
    r, m, o = jrot.batched_align_global_moves(
        qs, qlens, ts, tlens, JaxParams(), interpret=True, with_stats=False)
    got = _port(qs, qlens, ts, tlens)
    _assert_equal((np.asarray(r.score), np.asarray(m), np.asarray(o)), got,
                  qlens)


def test_rotband_plain_matches_scan_spec(batch):
    qs, qlens, ts, tlens = batch
    scan = jbanded.make_batched("global", JaxParams(), with_moves=True,
                                with_stats=False)
    r, m, o = scan(qs, qlens, ts, tlens)
    _assert_equal((np.asarray(r.score), np.asarray(m), np.asarray(o)),
                  _port(qs, qlens, ts, tlens), qlens)


def test_rotband_plain_matches_band_local_plain(batch):
    """The port's two plain fills agree everywhere, the zeroed moves of
    rows beyond qlen included (the two kernels store them the same way)."""
    qs, qlens, ts, tlens = batch
    res, m, o = banded.banded_global_moves(
        *(torch.from_numpy(x) for x in (qs, qlens, ts, tlens)))
    _assert_equal((res.score.numpy(), m.numpy(), o.numpy()),
                  _port(qs, qlens, ts, tlens), qlens, full_moves=True)


def test_rotband_broadcast_template_and_wide_band_shift():
    """A template broadcast over the batch (stride 0, as the per-hole round
    passes it) and a long pair whose band offset moves through several
    full turns of the 128 lanes."""
    rng = np.random.default_rng(8)
    tpl = rng.integers(0, 4, 700).astype(np.uint8)
    qmax, tmax = 768, 768
    qs = np.full((3, qmax), PAD, np.uint8)
    qlens = np.zeros(3, np.int32)
    for k in range(3):
        q = synth.mutate(rng, tpl, 0.02, 0.05, 0.05)[:qmax]
        qs[k, :len(q)] = q
        qlens[k] = len(q)
    t = np.full(tmax, PAD, np.uint8)
    t[:700] = tpl
    tl = np.full(3, 700, np.int32)
    t_b = torch.from_numpy(t)[None].expand(3, tmax)
    got = banded_rotband.batched_align_global_moves(
        torch.from_numpy(qs), torch.from_numpy(qlens), t_b,
        torch.from_numpy(tl))
    res, m, o = banded.banded_global_moves(
        torch.from_numpy(qs), torch.from_numpy(qlens),
        torch.from_numpy(np.stack([t] * 3)), torch.from_numpy(tl))
    assert int(o.max()) > 3 * 128
    _assert_equal((res.score.numpy(), m.numpy(), o.numpy()),
                  tuple(x.numpy() for x in got), qlens, full_moves=True)


def test_wrapper_raises_off_the_card():
    """The wrapper takes the plain version only for CPU tensors: any other
    device is refused (here 'meta', which no kernel can take), and the
    refusal is a kernel error that ends a run."""
    x = torch.zeros((2, 128), dtype=torch.uint8, device="meta")
    n = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(cuda_ext.RefusedInputs, match="CUDA"):
        banded_rotband.batched_align_global_moves(x, n, x, n)


def test_global_fill_arms():
    """star.global_fill: every arm gives the same values; an unknown arm
    is refused."""
    rng = np.random.default_rng(3)
    qs, qlens, ts, tlens = (torch.from_numpy(x) for x in _stack(
        [_case(rng, 128, 128) for _ in range(4)]))
    outs = [star.global_fill(AlignParams(), impl)(qs, qlens, ts, tlens)
            for impl in ("", "scan", "pallas", "rotband")]
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        star.global_fill(AlignParams(), "warp")
