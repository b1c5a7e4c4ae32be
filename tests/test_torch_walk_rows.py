"""The traceback walk's row-level chain, emulated in NumPy, against the cell
walk.

csrc/traceback_walk.cu steps once per query row or less: a run of
diagonals is one step (the walker warp's lanes read 32 cells down the
diagonal at once), each deletion run is one step, its length a closed form
of the row's move bytes (the run of F-extend bits from an unclamped lane,
or the edge byte's bits where the lane is clamped), and each insertion
slot's bases are kept as they are met and written left-justified when the
walk leaves the slot.  ``walk_rows`` below
is that chain, step for step, in Python.  It is held, by exact equality,
against the plain cell walk (``traceback.project_plain``) and the JAX
package's ``make_projector_reference`` on the JAX fill's moves, and against
the plain walk on random move bytes, offsets and lengths
(``synth.walk_cases``) at max_ins 1, 4 and 16.
"""

import numpy as np
import pytest
import torch

import jax

from ccsx_tpu.ops import traceback as jtraceback

from ccsx_tpu_torch.ops import traceback
from ccsx_tpu_torch.utils import synth

from test_torch_traceback import QMAX, TMAX, _corpus, _jax_moves

GAP, PAD = 4, 5
H, E, F = 0, 1, 2


def _f_run(mask: int, lane: int) -> int:
    """Consecutive F-extend bits from ``lane`` down, in a row's 128-bit mask
    (the kernel's f_run: the highest clear bit at or below the lane)."""
    clear = ~mask & ((1 << (lane + 1)) - 1)
    return lane - (clear.bit_length() - 1)


def walk_rows(mv, of, q, qlen, tlen, tmax, max_ins, seen=None):
    """One pass through the row-level chain; returns (aligned, ins_cnt,
    ins_b, lead_ins, steps).  ``seen`` collects the kinds of deletion runs
    taken."""
    seen = set() if seen is None else seen
    qmax = mv.shape[0]
    i = min(max(qlen, 0), qmax)
    j = min(max(tlen, 0), tmax)
    aligned = np.full(tmax, PAD, np.uint8)
    aligned[:j] = GAP
    ins_cnt = np.zeros(tmax, np.int32)
    ins_b = np.full((tmax, max_ins), PAD, np.uint8)
    fbit = (mv & 8) != 0
    masks = [int("".join("1" if b else "0" for b in r[::-1]), 2) for r in fbit]
    state, slot, kept, steps = H, 0, [], 0

    def close(slot, kept, cnt):
        if slot > 0:
            ins_cnt[slot - 1] = cnt
            used = min(cnt, max_ins)
            ins_b[slot - 1, :used] = kept[:used][::-1]

    cnt = 0
    while i > 0 and j > 0:
        row = i - 1
        off = int(of[row])
        lane = j - off
        m = int(mv[row, min(max(lane, 0), 127)])
        if state == H and m & 3 == 0 and row >= 32 and j > 32:
            # the warp's look down the diagonal: cells k = 1..32 at once,
            # the run of diagonals up to the first other move in one step
            cells = [int(mv[row - k, min(max(j - k - int(of[row - k]), 0),
                                         127)]) for k in range(1, 33)]
            run = next((k for k in range(1, 33) if cells[k - 1] & 3), 32)
            for c in range(run):
                aligned[j - 1 - c] = q[row - c]
            i, j, steps = i - run, j - run, steps + 1
            seen.add("diagonal run")
            continue
        while True:                       # the row's deletion runs
            lane = j - off
            m = int(mv[row, min(max(lane, 0), 127)])
            choice = m & 3
            if not (state == F or (state == H and choice >= 2)):
                break
            steps += 1
            goes_on = bool(m & 8) or choice >= 2
            if lane > 127:
                cells = lane - 127 if goes_on else 1
                state = F if goes_on and m & 8 else H
                seen.add("right")
            elif lane < 0:
                cells, state = (j if goes_on else 1), H
                seen.add("left")
            else:
                run = _f_run(masks[row], lane)
                cells, state = (j if run > lane else run + 1), H
                seen.add("to lane 0" if run > lane else "in")
            j -= min(cells, j)
            if j == 0:
                break
        if j == 0:
            break
        steps += 1
        if state == H and choice == 0:
            aligned[j - 1] = q[row]
            j -= 1
        else:
            if j != slot:
                close(slot, kept, cnt)
                slot, cnt, kept = j, 0, []
            if cnt < max_ins:
                kept.append(q[row])
            cnt += 1
            state = E if m & 4 else H
        i -= 1
    close(slot, kept, cnt)
    return aligned, ins_cnt, ins_b, (i if j == 0 else 0), steps


def emulate(moves, offs, qs, qlens, tlens, tmax, max_ins, seen=None):
    outs = [walk_rows(moves[p], offs[p], qs[p], int(qlens[p]), int(tlens[p]),
                      tmax, max_ins, seen) for p in range(len(moves))]
    return (np.stack([o[0] for o in outs]), np.stack([o[1] for o in outs]),
            np.stack([o[2] for o in outs]),
            np.array([o[3] for o in outs], np.int32),
            np.array([o[4] for o in outs]))


def _plain(moves, offs, qs, qlens, tlens, tmax, max_ins):
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (moves, offs, qs, qlens, tlens)]
    return [x.numpy() for x in traceback.project_plain(*t, tmax, max_ins)]


NAMES = ("aligned", "ins_cnt", "ins_b", "lead_ins")


def test_row_chain_matches_reference_projector_on_fill_moves():
    """The JAX fill's moves of the parity corpus (noisy passes, long
    insertion runs, an empty row, a leading insertion, a band miss): the
    row chain, the plain walk and the JAX reference projector agree."""
    qs, qlens, ts, tlen = _corpus(np.random.default_rng(23))
    moves, offs = _jax_moves(qs, qlens, ts, tlen)
    tlens = np.full(len(qs), tlen, np.int32)
    proj = jax.jit(jax.vmap(jtraceback.make_projector_reference(TMAX, 4),
                            in_axes=(0, 0, 0, 0, None)))
    want = [np.asarray(x) for x in proj(moves, offs, qs, qlens,
                                        np.int32(tlen))]
    plain = _plain(moves, offs, qs, qlens, tlens, TMAX, 4)
    got = emulate(moves, offs, qs, qlens, tlens, TMAX, 4)
    for name, w, p, g in zip(NAMES, want, plain, got):
        np.testing.assert_array_equal(p, w, err_msg=name)
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the chain is shorter than the cell walk: a step per run of diagonals,
    # deletions or insertions
    cells = qlens.sum() + tlen * (qlens > 0).sum()
    assert got[4].sum() < 0.3 * cells


@pytest.mark.parametrize("max_ins", [1, 4, 16])
def test_row_chain_matches_plain_on_random_bytes(max_ins):
    """Random bytes (choice 3, random E/F and high bits), offsets that are
    non-monotone or put the lanes out of [0, 127], and lengths 0, at the
    padded widths, negative and beyond them."""
    for seed in (5, 6):
        cases = synth.walk_cases(np.random.default_rng(seed), QMAX, TMAX)
        plain = _plain(*cases, TMAX, max_ins)
        got = emulate(*cases, TMAX, max_ins)
        for name, p, g in zip(NAMES, plain, got):
            np.testing.assert_array_equal(g, p, err_msg=f"{name} seed {seed}")
    # the corpus reaches the paths that matter: insertion runs longer than
    # max_ins, leading insertions, walks left to column 0
    assert int(plain[1].max()) > max_ins and int(plain[3].max()) > 0


def test_walk_cases_reach_every_jump():
    """Each closed form of a deletion run is taken on the random corpus:
    right of the band, left of it, and within it, with and without the run
    reaching lane 0; and runs of diagonals are taken 32 cells at a time."""
    seen = set()
    emulate(*synth.walk_cases(np.random.default_rng(5), QMAX, TMAX), TMAX, 4,
            seen)
    assert seen == {"right", "left", "in", "to lane 0", "diagonal run"}
