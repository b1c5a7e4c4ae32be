"""Parity: the port's column vote and materialize against the JAX
package's make_voter / materialize / emit_insertions, on random
projections with masked rows and tie-heavy columns."""

import numpy as np
import torch

from ccsx_tpu.ops import msa as jmsa

from ccsx_tpu_torch.ops import msa


def _projection(rng, P, T, R):
    # few passes and a small alphabet make ties common (argmax must take
    # the first maximum, as jnp.argmax does)
    aligned = rng.integers(0, 6, (P, T)).astype(np.uint8)
    ins_cnt = rng.integers(0, R + 3, (P, T)).astype(np.int32) * \
        (rng.random((P, T)) < 0.3)
    ins_b = np.where(np.arange(R)[None, None, :] < ins_cnt[:, :, None],
                     rng.integers(0, 4, (P, T, R)), 5).astype(np.uint8)
    row_mask = np.arange(P) < P - 2
    return aligned, ins_cnt.astype(np.int32), ins_b, row_mask


def test_vote_matches_reference():
    rng = np.random.default_rng(3)
    R = 4
    voter = jmsa.make_voter(R)
    for P, T in ((4, 37), (8, 256), (3, 5)):
        a, c, b, m = _projection(rng, P, T, R)
        want = [np.asarray(x) for x in voter(a, c, b, m)]
        got = msa.vote(torch.from_numpy(a), torch.from_numpy(c),
                       torch.from_numpy(b), torch.from_numpy(m), R)
        for k, (w, g) in enumerate(zip(want, got)):
            assert g.numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(k))


def test_emit_and_materialize_match_reference():
    rng = np.random.default_rng(4)
    R = 4
    for case in range(20):
        T = int(rng.integers(1, 120))
        ncov = rng.integers(0, 40, T).astype(np.uint8)     # uint8 on purpose
        votes = (rng.integers(0, 80, (T, R)) % (ncov[:, None].astype(int) + 1)
                 ).astype(np.uint8)
        base = rng.integers(0, 4, (T, R)).astype(np.uint8)
        cons = rng.integers(0, 6, T).astype(np.uint8)
        for spec in (False, True):
            want = jmsa.emit_insertions(base, votes, ncov, spec)
            got = msa.emit_insertions(base, votes, ncov, spec)
            np.testing.assert_array_equal(got, want)
            tl = int(rng.integers(0, T + 1))
            np.testing.assert_array_equal(msa.materialize(cons, got, tl),
                                          jmsa.materialize(cons, want, tl))
