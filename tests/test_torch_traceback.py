"""Parity: the port's traceback walk against the JAX package's
make_projector_reference, on the moves of the JAX fill.

Passes of noisy copies (insertion-heavy, so insertion runs overflow the
max_ins cells), an empty padding row, a leading insertion and an
unreachable band are walked by both; all four outputs must be equal.
"""

import numpy as np
import torch

import jax

from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.ops import banded as jbanded
from ccsx_tpu.ops import traceback as jtraceback
from ccsx_tpu.utils import synth

from ccsx_tpu_torch.ops import traceback

PAD = 5
QMAX, TMAX, R = 256, 256, 4


def _corpus(rng):
    t = rng.integers(0, 4, 180).astype(np.uint8)
    passes = [synth.mutate(rng, t, 0.03, 0.08, 0.05) for _ in range(4)]
    passes.append(synth.mutate(rng, t, 0.02, 0.4, 0.02)[:QMAX])  # long runs
    passes.append(np.zeros(0, np.uint8))                          # padding row
    passes.append(np.concatenate([[1, 2, 3], t[:100]]).astype(np.uint8))
    passes.append(rng.integers(0, 4, 12).astype(np.uint8))        # band misses
    qs = np.full((len(passes), QMAX), PAD, np.uint8)
    for k, p in enumerate(passes):
        qs[k, :len(p)] = p
    qlens = np.array([len(p) for p in passes], np.int32)
    ts = np.broadcast_to(np.pad(t, (0, TMAX - len(t)), constant_values=PAD),
                         (len(passes), TMAX)).copy()
    return qs, qlens, ts, len(t)


def _jax_moves(qs, qlens, ts, tlen):
    """The JAX global fill's move bytes and offsets, as numpy arrays."""
    fill = jbanded.make_batched("global", JaxParams(), with_moves=True,
                                with_stats=False)
    _, moves, offs = fill(qs, qlens, ts, np.full(len(qs), tlen, np.int32))
    return np.array(moves), np.array(offs)


def test_walk_matches_reference_projector():
    rng = np.random.default_rng(23)
    qs, qlens, ts, tlen = _corpus(rng)
    moves, offs = _jax_moves(qs, qlens, ts, tlen)
    proj = jax.jit(jax.vmap(jtraceback.make_projector_reference(TMAX, R),
                            in_axes=(0, 0, 0, 0, None)))
    want = proj(moves, offs, qs, qlens, np.int32(tlen))
    got = traceback.project(
        torch.from_numpy(moves), torch.from_numpy(offs),
        torch.from_numpy(qs), torch.from_numpy(qlens),
        torch.full((len(qs),), tlen, dtype=torch.int32), TMAX, R)
    names = ("aligned", "ins_cnt", "ins_b", "lead_ins")
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the corpus reaches the interesting paths
    assert int(got[1].max()) > R and int(got[3].max()) > 0
