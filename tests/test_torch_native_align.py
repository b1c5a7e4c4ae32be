"""The port's native aids (ccsx_tpu_torch/native: align_native.cpp,
baseline_simd.cpp and native/align.py, copies of the JAX package's, built
by the port's own g++ step into build/) against the JAX package's.

The cases of tests/test_native_align.py: the port's
``align_scalar_native`` equals the JAX package's NumPy oracle
(``ccsx_tpu.ops.oracle.align``) and the JAX package's
``align_scalar_native`` exactly — score, spans, counts and cigar — in the
three modes; the size cap returns None; and the two builds of the baseline
fill (vectorized, and scalar with the vectorizers off) agree bit for bit.
"""

import ctypes

import numpy as np
import pytest

from ccsx_tpu import native as jnative
from ccsx_tpu.native.align import align_scalar_native as jalign
from ccsx_tpu.ops import oracle
from ccsx_tpu.utils import synth

from ccsx_tpu_torch import native
from ccsx_tpu_torch.native.align import align_scalar_native

pytestmark = pytest.mark.skipif(
    not (native.available() and jnative.available()),
    reason="native toolchain unavailable")


def _check(q, t, mode, **scores):
    want = oracle.align(q, t, mode=mode, **scores)
    twin = jalign(q, t, mode=mode, **scores)
    got = align_scalar_native(q, t, mode=mode, **scores)
    assert got is not None
    for ref in (want, twin):
        assert got.score == ref.score
        assert (got.qb, got.qe, got.tb, got.te) == (
            ref.qb, ref.qe, ref.tb, ref.te), mode
        assert (got.aln, got.mat, got.mis, got.ins, got.del_) == (
            ref.aln, ref.mat, ref.mis, ref.ins, ref.del_)
        assert got.cigar == ref.cigar


@pytest.mark.parametrize("mode", ["global", "qfree", "local"])
def test_random_pairs(mode, rng):
    for _ in range(8):
        tlen = int(rng.integers(5, 120))
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        q = synth.mutate(rng, t, 0.05, 0.08, 0.08)
        _check(q, t, mode)


@pytest.mark.parametrize("mode", ["global", "qfree", "local"])
def test_unrelated_and_edge(mode, rng):
    q = rng.integers(0, 4, 40).astype(np.uint8)
    t = rng.integers(0, 4, 55).astype(np.uint8)
    _check(q, t, mode)
    _check(np.array([0], np.uint8), np.array([3], np.uint8), mode)
    # N bases never match
    _check(np.full(10, 4, np.uint8), np.full(10, 4, np.uint8), mode)


def test_clipping_qfree(rng):
    t = rng.integers(0, 4, 60).astype(np.uint8)
    junk = rng.integers(0, 4, 25).astype(np.uint8)
    q = np.concatenate([junk, synth.mutate(rng, t, 0.02, 0.02, 0.02), junk])
    _check(q, t, "qfree")


def test_alt_scores(rng):
    t = rng.integers(0, 4, 80).astype(np.uint8)
    q = synth.mutate(rng, t, 0.1, 0.05, 0.05)
    _check(q, t, "global", match=1, mismatch=-4, gap_open=-6, gap_extend=-1)


def test_size_cap_returns_none():
    q = np.zeros(1 << 14, np.uint8)
    t = np.zeros(1 << 13, np.uint8)
    assert align_scalar_native(q, t) is None
    assert jalign(q, t) is None


def test_banded_fill_vec_equals_scalar_and_the_jax_build(rng):
    """The port's two builds of baseline_simd.cpp agree bit for bit, with
    each other and with the JAX package's library, on the final band
    row; the pool driver fills the cells it says."""
    L, J = native.lib(), jnative.lib()
    P = ctypes.POINTER

    def run(fn, q, t):
        h = np.zeros(128, np.int16)
        rc = fn(q.ctypes.data_as(P(ctypes.c_uint8)), len(q),
                t.ctypes.data_as(P(ctypes.c_uint8)), len(t), 2, -6, -3, -2,
                h.ctypes.data_as(P(ctypes.c_int16)))
        assert rc == 0
        return h

    for _ in range(8):
        q = rng.integers(0, 4, int(rng.integers(50, 2500))).astype(np.uint8)
        t = rng.integers(0, 4, int(rng.integers(50, 2500))).astype(np.uint8)
        hv = run(L.ccsx_banded_fill_vec, q, t)
        np.testing.assert_array_equal(hv, run(L.ccsx_banded_fill_scalar,
                                              q, t))
        np.testing.assert_array_equal(hv, run(J.ccsx_banded_fill_vec, q, t))
    q = rng.integers(0, 4, 1000).astype(np.uint8)
    assert run(L.ccsx_banded_fill_vec, q, q).max() == 2 * 1000
    qs = np.tile(q, 4)
    cells = L.ccsx_banded_fill_many(
        qs.ctypes.data_as(P(ctypes.c_uint8)),
        qs.ctypes.data_as(P(ctypes.c_uint8)), 1000, 1000, 4, 2, 1,
        2, -6, -3, -2, None)
    assert cells == 4 * 1000 * 128
