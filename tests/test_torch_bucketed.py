"""Parity of the port's bucketed control path (--pass-buckets), its CLI
knobs and whole_read with the JAX package.

The bucketed (Z, P) round and refine steps, the batched vote and the
single-hole breakpoint scan against the JAX package's functions on the
same numpy inputs; the CLI's bytes with --pass-buckets against the port's
packed default and the JAX package's (which pins packed == bucketed
itself, tests/test_packing.py); whole_read.consensus_passes against JAX's;
and each knob's validation against the JAX CLI's return code (the bytes
of the knobs that change them are in tests/test_torch_knobs.py).
Every output is an integer or a byte: the tolerance is exact equality.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccsx_tpu import cli as jcli
from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.config import CcsConfig as JaxConfig
from ccsx_tpu.consensus import star as jstar
from ccsx_tpu.consensus import whole_read as jwhole
from ccsx_tpu.ops import breakpoint as jbp
from ccsx_tpu.ops import msa as jmsa
from ccsx_tpu.pipeline import batch as jbatch
from ccsx_tpu.utils import synth as jsynth
from ccsx_tpu.utils.metrics import Metrics

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.config import AlignParams, CcsConfig
from ccsx_tpu_torch.consensus import star, whole_read
from ccsx_tpu_torch.ops import breakpoint as bp_mod
from ccsx_tpu_torch.ops import msa
from ccsx_tpu_torch.pipeline import batch
from ccsx_tpu_torch.utils.run_metrics import PORT_KEYS, RunMetrics

M = 4
CONSTS = (10, 5, 80, 80, 60)
ERR = dict(sub_rate=0.02, ins_rate=0.05, del_rate=0.05)


# ---- the bucketed steps -------------------------------------------------------

def _group(rng, P, qmax, tmax, holes):
    """(qs, qlens, ts, tlens, row_mask) of a bucketed group: per hole a
    (template length, passes) pair, 0 passes for an empty hole; each draft
    is the hole's first pass, or ``draft_of(template)`` when given."""
    Z = len(holes)
    qs = np.full((Z, P, qmax), 5, np.uint8)
    qlens = np.zeros((Z, P), np.int32)
    ts = np.full((Z, tmax), 5, np.uint8)
    tlens = np.zeros(Z, np.int32)
    row_mask = np.zeros((Z, P), bool)
    for z, (tlen, n, draft_of) in enumerate(holes):
        tpl = rng.integers(0, 4, tlen).astype(np.uint8)
        ps = [jsynth.mutate(rng, tpl, 0.01, 0.02, 0.02)[:qmax]
              for _ in range(max(n, 1))]
        for k in range(n):
            qs[z, k, :len(ps[k])] = ps[k]
            qlens[z, k] = len(ps[k])
            row_mask[z, k] = True
        d = ps[0] if draft_of is None else draft_of(tpl)
        ts[z, :len(d)] = d
        tlens[z] = len(d)
    return qs, qlens, ts, tlens, row_mask


def _thinned(tpl):
    """The template with every fifth base deleted: the passes' consensus
    outgrows a draft capacity sized to it."""
    return np.delete(tpl, np.arange(0, len(tpl), 5))


@pytest.fixture(scope="module")
def groups():
    """The small shape (P 8, qmax 512, tmax 1024, iters 2) with holes of
    5, 8 and 0 passes, and an overflow shape (P 8, qmax 1024, tmax 512)
    where one hole's draft outgrows tmax; the JAX package's transfer-packed
    round and refine steps on each."""
    rng = np.random.default_rng(5)
    cases = {
        "small": (8, 512, 1024, [(450, 5, None), (430, 8, None),
                                 (400, 0, None)]),
        "overflow": (8, 1024, 512, [(600, 6, _thinned), (420, 5, None)]),
    }
    out = {}
    for name, (P, qmax, tmax, holes) in cases.items():
        args = _group(rng, P, qmax, tmax, holes)
        big, small = jbatch._pack_args(args)
        jr = jbatch._round_step(JaxParams(), M, tmax, CONSTS,
                                pack=(P, qmax))(big, small)
        jf = jbatch._refine_step(JaxParams(), M, tmax, 2, CONSTS,
                                 pack=(P, qmax))(big, small)
        out[name] = (args, P, qmax, tmax,
                     jbatch._unpack_round(np.asarray(jr[0]),
                                          np.asarray(jr[1]), M, tmax),
                     jbatch._unpack_refine(np.asarray(jf[0]),
                                           np.asarray(jf[1]), M, tmax))
    return out


ROUND = ("cons", "ins_base", "ins_votes", "ncov", "nwin", "bp", "advance")
REFINE = ROUND + ("dlen", "ovf")


def _equal(names, want, got):
    for name, w, g in zip(names, want, got):
        w, g = np.asarray(w), np.asarray(g)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("name", ["small", "overflow"])
def test_round_step_matches_reference(name, groups):
    args, P, qmax, tmax, want, _ = groups[name]
    step = batch._round_step(AlignParams(), M, tmax, CONSTS, (P, qmax))
    got = batch._unpack_round(step(batch._pack_args(args)).numpy(), M, tmax)
    _equal(ROUND, want, got)


@pytest.mark.parametrize("impl", ["", "rotband"])
@pytest.mark.parametrize("name", ["small", "overflow"])
def test_refine_step_matches_reference(name, impl, groups):
    args, P, qmax, tmax, _, want = groups[name]
    step = batch._refine_step(AlignParams(), M, tmax, 2, CONSTS, (P, qmax),
                              impl)
    got = batch._unpack_refine(step(batch._pack_args(args)).numpy(), M, tmax)
    _equal(REFINE, want, got)
    ovf = got[8]
    if name == "overflow":
        assert ovf[0] and not ovf[1]
    else:
        assert not ovf.any() and (got[5][:2] >= 1).all()
        assert got[7][2] == args[3][2]       # the empty hole never grew


def test_pack_args_round_trip(groups):
    args, P, qmax, tmax, _, _ = groups["small"]
    for a, b in zip(args, batch._unpack_args(batch._pack_args(args), P,
                                             qmax, tmax)):
        np.testing.assert_array_equal(b.numpy(), a)


def test_executor_serves_round_requests_like_reference():
    """Bare RoundRequests of two pass buckets go to the bucketed single
    round, one step per (P, qmax, tmax) group, with the JAX executor's
    results."""
    rng = np.random.default_rng(6)
    reqs = []
    for n in (3, 5, 6):
        tpl = rng.integers(0, 4, 420).astype(np.uint8)
        ps = [jsynth.mutate(rng, tpl, **ERR) for _ in range(n)]
        qs, qlens, mask = star.StarMsa(AlignParams(), device="cpu").pack(
            ps, (4, 8), 8)
        reqs.append((qs, qlens, mask, ps[0]))
    jm = Metrics()
    want = jbatch.BatchExecutor(JaxConfig(is_bam=False), metrics=jm).run(
        [jstar.RoundRequest(*r) for r in reqs])
    m = RunMetrics()
    got = batch.BatchExecutor(CcsConfig(is_bam=False), device="cpu",
                              metrics=m).run(
        [star.RoundRequest(*r) for r in reqs])
    assert {k: getattr(m, k) for k in PORT_KEYS if getattr(m, k)} == \
        {"round_groups": 2, "bucketed_dispatches": 2}
    # the JAX keys the port keeps alike; dp_cells_padded and
    # dp_round_cells_padded differ by design: the JAX package pads Z to a
    # power of two (_z_bucket), the port does not
    for k in ("device_dispatches", "banded_dispatches", "dp_cells_real",
              "dp_round_cells_real", "dp_rowcells_real", "dp_rowcells_cap",
              "windows"):
        assert getattr(m, k) == getattr(jm, k), k
    for w, g in zip(want, got):
        assert (g.tlen, g.bp) == (w.tlen, w.bp)
        for name in ("cons", "ins_base", "ins_votes", "ncov", "nwin",
                     "advance"):
            np.testing.assert_array_equal(getattr(g, name),
                                          np.asarray(getattr(w, name)),
                                          err_msg=name)


# ---- the batched vote and the breakpoint scan --------------------------------

def _projections(rng, Z, P, T, live):
    """Random (Z, P, T) projections; ``live[z]`` real rows per hole."""
    aligned = rng.integers(0, 6, (Z, P, T)).astype(np.uint8)
    ins_cnt = (rng.integers(0, M + 3, (Z, P, T))
               * (rng.random((Z, P, T)) < 0.3)).astype(np.int32)
    ins_b = np.where(np.arange(M) < ins_cnt[..., None],
                     rng.integers(0, 4, (Z, P, T, M)), 5).astype(np.uint8)
    row_mask = np.arange(P)[None, :] < np.asarray(live)[:, None]
    return aligned, ins_cnt, ins_b, row_mask


@pytest.mark.parametrize("case", ["random", "ties", "all_padded"])
def test_batched_vote_matches_reference(case):
    rng = np.random.default_rng(11)
    Z, P, T = 3, 6, 40
    live = {"random": [6, 3, 5], "ties": [4, 2, 6],
            "all_padded": [0, 0, 0]}[case]
    aligned, ins_cnt, ins_b, row_mask = _projections(rng, Z, P, T, live)
    if case == "ties":
        # two codes per column, two votes each (four real rows): the first
        # maximum wins; the inserted bases tie the same way
        aligned[0] = np.repeat(rng.integers(0, 5, (2, T)), 2, axis=0).astype(
            np.uint8)[[0, 2, 1, 3, 0, 1]]
        ins_cnt[0] = 1
        ins_b[0, :, :, 0] = aligned[0] % 4
    want = jax.vmap(jmsa.make_voter(M))(*(jnp.asarray(x) for x in (
        aligned, ins_cnt, ins_b, row_mask)))
    got = msa.vote(*(torch.from_numpy(x) for x in (
        aligned, ins_cnt, ins_b, row_mask)), M)
    _equal(("cons", "ins_base", "ins_votes", "ncov", "match", "nwin"),
           want, got)
    one = msa.vote(*(torch.from_numpy(x[1]) for x in (
        aligned, ins_cnt, ins_b, row_mask)), M)
    for g, o in zip(got, one):
        assert torch.equal(g[1], o)


@pytest.mark.parametrize("case", ["random", "short_tlen", "all_padded",
                                  "ties"])
def test_bp_advance_matches_reference(case):
    rng = np.random.default_rng(12)
    Z, P, T = 4, 8, 48
    live = {"all_padded": [0, 0, 0, 0]}.get(case, [8, 5, 3, 12 % 8])
    aligned, ins_cnt, _, row_mask = _projections(rng, Z, P, T, live)
    cons = np.where(rng.random((Z, T)) < 0.8, rng.integers(0, 4, (Z, T)),
                    4).astype(np.uint8)
    match = (rng.random((Z, P, T)) < 0.93) & row_mask[:, :, None]
    tlen = np.array([T, T - 5, 30, 41], np.int32)
    if case == "short_tlen":
        tlen = np.array([0, 1, 10, 11], np.int32)     # tlen < W + 1 and = W + 1
    if case == "ties":
        match[:] = row_mask[:, :, None]               # every window is valid
    lead = rng.integers(0, 3, (Z, P)).astype(np.int32)
    want = jax.vmap(jbp.make_bp_advance(T, *CONSTS))(*(jnp.asarray(x) for x in (
        match, cons, aligned, ins_cnt, lead, row_mask, tlen)))
    got = bp_mod.make_bp_advance(T, *CONSTS)(*(torch.from_numpy(x) for x in (
        match, cons, aligned, ins_cnt, lead, row_mask, tlen)))
    _equal(("bp", "advance"), want, got)
    if case == "random":
        assert (got[0].numpy() >= 1).any()
    if case == "short_tlen":
        assert (got[0].numpy()[:3] == -1).all()


# ---- the CLI -----------------------------------------------------------------

def _zmws(rng, passes, tlen=600):
    return [jsynth.make_zmw(rng, template_len=tlen, n_passes=n, movie="mv",
                            hole=str(h), **ERR) for h, n in enumerate(passes)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four holes of 600 bp templates (5, 6, 7 and 11 passes) and the JAX
    package's packed --batch on FASTQ for it."""
    d = tmp_path_factory.mktemp("bucketed")
    fa = d / "in.fa"
    fa.write_text(jsynth.make_fasta(_zmws(np.random.default_rng(19),
                                          (5, 6, 7, 11))))
    out = d / "ref.fq"
    assert jcli.main(["-A", "-m", "1000", "--batch", "on", "--device", "cpu",
                      "--fastq", str(fa), str(out)]) == 0
    assert out.read_bytes().count(b"@mv/") == 4
    return str(fa), out.read_bytes()


def _port(fa, out, *extra):
    rc = cli.main(["-A", "-m", "1000", "--device", "cpu", "--batch", "on",
                   *extra, fa, str(out)])
    return rc, (out.read_bytes() if out.exists() else b"")


def _counts(err):
    """The driver's counters: -v's last stderr line is the final metrics
    snapshot, ``[ccsx-tpu-torch] {json}``."""
    prefix, snap = err.strip().splitlines()[-1].split(" ", 1)
    assert prefix == "[ccsx-tpu-torch]"
    return json.loads(snap)


@pytest.mark.parametrize("arm", ["packed", "bucketed", "bucketed_rotband"])
def test_cli_bucketed_equals_packed_equals_reference(arm, corpus, tmp_path,
                                                     capsys):
    """--pass-buckets runs the (Z, P) groups, not the slabs, and gives the
    packed default's and the JAX package's bytes."""
    fa, ref = corpus
    extra = {"packed": [],
             "bucketed": ["--pass-buckets", "4,8,16,32"],
             "bucketed_rotband": ["--pass-buckets", "4,8,16,32",
                                  "--banded-impl", "rotband"]}[arm]
    assert _port(fa, tmp_path / "o.fq", "--fastq", "-v", *extra) == (0, ref)
    counts = _counts(capsys.readouterr().err)
    if arm == "packed":
        assert counts["slabs"] > 0 and counts["bucketed_groups"] == 0
    else:
        assert counts["bucketed_groups"] > 0 and counts["slabs"] == 0
        assert counts["bucketed_dispatches"] >= counts["bucketed_groups"]


def test_whole_read_consensus_passes_matches_reference():
    rng = np.random.default_rng(21)
    tpl = rng.integers(0, 4, 700).astype(np.uint8)
    passes = [jsynth.mutate(rng, tpl, **ERR) for _ in range(6)]
    want = jwhole.consensus_passes(passes, JaxConfig(emit_quality=True))
    got = whole_read.consensus_passes(
        passes, CcsConfig(emit_quality=True, device="cpu"))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("flags", [
    ["--pass-buckets", "8,4,32"], ["--pass-buckets", "4,4,32"],
    ["--pass-buckets", "4,x"], ["--pass-buckets", "0,32"],
    ["--pass-buckets", "4,8,16"], ["--pass-buckets", "4,8", "--max-passes",
                                   "8"],
    ["--slab-rows", "0"], ["--slab-rows", "-4"], ["--slab-rows", "3"],
    ["--slab-shape-ladder", "0"], ["--slab-shape-ladder", "9"],
    ["--slab-shape-ladder", "8"], ["--seed-device-min-t", "-1"],
    ["--seed-device-min-t", "0"], ["--prefilter", "maybe"],
    ["--window-growth", "wide"], ["--refine-iters", "x"],
    ["--prep-threads", "-1"], ["--prep-threads", "65"],
    ["--prep-threads", "64"], ["--prep-threads", "x"]])
def test_knob_validation_matches_reference(flags, tmp_path, monkeypatch):
    """The same return code as the JAX CLI (1 for a refused value, argparse's
    2 for a bad choice or type); a valid value gets past validation in both,
    to the missing input."""
    def rc(main):
        try:
            return main([*flags, str(tmp_path / "none.fa"),
                         str(tmp_path / "o.fa")])
        except SystemExit as e:
            return e.code

    # the port's run would start on the card; stop both at the input
    monkeypatch.setattr("ccsx_tpu_torch.pipeline.run.run_pipeline",
                        lambda *a, **k: 1)
    want = rc(jcli.main)
    assert rc(cli.main) == want
    assert want in (1, 2)
