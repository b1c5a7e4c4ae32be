"""Parity of the port's batched packed driver with the JAX package.

The slab planner, the segment vote, the device materializer and insertion
rule, the packed breakpoint scan and one whole packed refine step (both
global-fill arms) against the JAX package's functions on the same numpy
inputs; the CLI's output bytes under --batch on against the JAX package's
--batch on and the port's own --batch off; and the driver's failure rules
(a kernel or card fault ends the run, an out-of-memory error bisects the
slab) and its --batch auto choice.  Every output is an integer or a byte:
the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccsx_tpu import cli as jcli
from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.ops import breakpoint as jbp
from ccsx_tpu.ops import msa as jmsa
from ccsx_tpu.ops import seed as jseed
from ccsx_tpu.ops import sketch as jsketch
from ccsx_tpu.pipeline import batch as jbatch
from ccsx_tpu.pipeline import pack as jpack
from ccsx_tpu.utils import synth as jsynth

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.config import AlignParams, CcsConfig
from ccsx_tpu_torch.consensus import prepare, star
from ccsx_tpu_torch.consensus.align_host import HostAligner
from ccsx_tpu_torch.ops import breakpoint as bp_mod
from ccsx_tpu_torch.ops import cuda_ext, msa, sketch
from ccsx_tpu_torch.ops import encode as enc
from ccsx_tpu_torch.pipeline import batch, pack, run
from ccsx_tpu_torch.utils.run_metrics import RunMetrics

R_INS = 4


# ---- the slab planner ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_planner_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        rows = [int(x) for x in rng.integers(1, 40, int(rng.integers(1, 30)))]
        budget = int(rng.choice([16, 64, 128]))
        assert pack.plan_slabs(rows, budget) == jpack.plan_slabs(rows, budget)
        for ladder in (1, 2):
            assert pack.slab_shape(rows, budget, ladder=ladder) == \
                jpack.slab_shape(rows, budget, ladder=ladder)
        R, _ = pack.slab_shape(rows, budget)
        np.testing.assert_array_equal(pack.segment_ids(rows, R),
                                      jpack.segment_ids(rows, R))
    assert pack.canonical_heights(128, 3) == jpack.canonical_heights(128, 3)


# ---- the strand walk's pair filter and the pair executor -------------------

def _pairs(seed, n, tlen):
    """strand_match candidates: forward passes, reverse-strand passes in
    both orientations, an off-diagonal read and a random read."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        z = jsynth.make_zmw(rng, template_len=tlen, n_passes=2,
                            first_strand=0)
        fwd, rev = z.passes
        shifted = np.concatenate([rng.integers(0, 4, 300).astype(np.uint8),
                                  fwd[:tlen - 200]])
        out += [(fwd, z.template), (rev, z.template),
                (enc.revcomp_codes(rev), z.template), (shifted, z.template),
                (rng.integers(0, 4, tlen).astype(np.uint8), z.template)]
    return out


def test_sketch_rules_match_reference():
    """The filter rule on seed statistics, pair by pair, at both sides of
    the screening floor and for lines on and off the diagonal."""
    rng = np.random.default_rng(33)
    t = rng.integers(0, 4, 10000).astype(np.uint8)
    noise = rng.integers(0, 4, 10000).astype(np.uint8)
    far = [(np.concatenate([noise[:8000], t[:2000]]), t),    # band_overlap
           (np.concatenate([noise[:9975], t[:25]]), t)]       # noise_gate
    rules = set()
    for q, t in _pairs(31, 3, 2600) + _pairs(32, 2, 1500) + far:
        assert sketch.noise_gate(len(q), len(t)) == \
            jsketch.noise_gate(len(q), len(t))
        hit = jseed.seed_diagonal(q, t)
        if hit is None:
            continue
        for pct, band in ((70, 128), (75, 128), (75, 64)):
            got = sketch.reject_from_hit(hit, len(q), len(t), pct, band)
            assert got == jsketch.reject_from_hit(hit, len(q), len(t), pct,
                                                  band)
            rules.add(got)
    assert rules == {"", "band_overlap", "noise_gate"}


def test_pair_executor_host_twins_match_per_pair_spec():
    """With the device-seeding floor lowered to these pairs' lengths, every
    pair (PairBatch arms included) seeds through seed_device.seed_step, and
    the results equal the per-pair strand_match of the per-hole path (its
    host twin), except that a filtered pair's payload is empty (the walk
    discards the payload of a failed pair)."""
    pairs = _pairs(37, 2, 1300)
    reqs = [prepare.PairRequest(q, t, 75) for q, t in pairs]
    batch_req = prepare.PairBatch(reqs[:2])
    m = RunMetrics()
    ex = batch.PairExecutor(AlignParams(), device="cpu", metrics=m,
                            seed_device_min_t=1000)
    got = ex.run(reqs + [batch_req])
    spec = [HostAligner(AlignParams(), device="cpu").strand_match(q, t, 75)
            for q, t in pairs]
    assert m.pairs_seeded_device == len(pairs) + 2
    assert m.pairs_seeded_host == 0 and m.seed_steps == 1
    assert got[-1] == got[:2]
    for (ok, rs), (ok_s, rs_s) in zip(got[:-1], spec):
        assert ok == ok_s
        if ok:
            assert rs == rs_s
    assert any(ok for ok, _ in spec) and not all(ok for ok, _ in spec)


# ---- the segment vote, materializer, insertion rule, breakpoint scan -------

def _slab(rng, rows, T, pad_rows):
    """A random (R, T) slab of projections: holes with ``rows`` rows each
    (0 = an empty segment), sorted seg, then masked padding rows."""
    seg = np.concatenate([np.full(n, h, np.int32) for h, n in enumerate(rows)]
                         + [np.full(pad_rows, len(rows) - 1, np.int32)])
    R = len(seg)
    aligned = rng.integers(0, 6, (R, T)).astype(np.uint8)
    ins_cnt = (rng.integers(0, R_INS + 3, (R, T))
               * (rng.random((R, T)) < 0.3)).astype(np.int32)
    ins_b = np.where(np.arange(R_INS)[None, None, :] < ins_cnt[:, :, None],
                     rng.integers(0, 4, (R, T, R_INS)), 5).astype(np.uint8)
    row_mask = np.arange(R) < sum(rows)
    lead = rng.integers(0, 3, R).astype(np.int32)
    return aligned, ins_cnt, ins_b, row_mask, seg, lead


_SLABS = [([3, 0, 5, 2], 37, 3), ([12, 7], 256, 0), ([1], 16, 2)]


@pytest.mark.parametrize("rows,T,pad", _SLABS)
def test_segment_voter_matches_reference(rows, T, pad):
    rng = np.random.default_rng(T)
    aligned, ins_cnt, ins_b, row_mask, seg, _ = _slab(rng, rows, T, pad)
    H = len(rows) + 1                       # one slot stays empty
    want = jmsa.make_segment_voter(R_INS, H)(
        jnp.asarray(aligned), jnp.asarray(ins_cnt), jnp.asarray(ins_b),
        jnp.asarray(row_mask), jnp.asarray(seg))
    got = msa.make_segment_voter(R_INS, H)(
        torch.from_numpy(aligned), torch.from_numpy(ins_cnt),
        torch.from_numpy(ins_b), torch.from_numpy(row_mask),
        torch.from_numpy(seg).long())
    for name, w, g in zip(("cons", "ins_base", "ins_votes", "ncov", "match",
                           "nwin"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("speculative", [False, True])
def test_emit_insertions_matches_reference(speculative):
    rng = np.random.default_rng(5)
    H, T = 3, 64
    ncov = rng.integers(0, 12, (H, T)).astype(np.int32)
    votes = np.minimum(rng.integers(0, 12, (H, T, R_INS)),
                       ncov[:, :, None]).astype(np.int32)
    base = rng.integers(0, 4, (H, T, R_INS)).astype(np.uint8)
    want = jax.vmap(lambda b, v, n: jmsa.emit_insertions_jax(
        b, v, n, speculative))(base, votes, ncov)
    got = msa.emit_insertions_t(torch.from_numpy(base),
                                torch.from_numpy(votes),
                                torch.from_numpy(ncov), speculative)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy()[0], msa.emit_insertions(base[0], votes[0], ncov[0],
                                            speculative))


def test_materializer_matches_reference_with_overflow():
    rng = np.random.default_rng(9)
    H, T = 4, 48
    cons = rng.integers(0, 5, (H, T)).astype(np.uint8)
    ins = np.where(rng.random((H, T, R_INS)) < 0.5,
                   rng.integers(0, 4, (H, T, R_INS)), 5).astype(np.uint8)
    ins[0] = 5                              # a hole that cannot overflow
    tlen = np.array([T, 30, T, 1], np.int32)
    want = jax.vmap(jmsa.make_materializer(T, T, R_INS))(cons, ins, tlen)
    got = msa.make_materializer(T, T, R_INS)(
        torch.from_numpy(cons), torch.from_numpy(ins), torch.from_numpy(tlen))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("rows,T,pad", _SLABS)
def test_bp_advance_packed_matches_reference(rows, T, pad):
    rng = np.random.default_rng(T + 1)
    aligned, ins_cnt, _, row_mask, seg, lead = _slab(rng, rows, T, pad)
    H = len(rows) + 1
    # matches concentrated on base columns, so breakpoints exist
    cons = np.where(rng.random((H, T)) < 0.8,
                    rng.integers(0, 4, (H, T)), 4).astype(np.uint8)
    match = (rng.random((len(seg), T)) < 0.93) & row_mask[:, None]
    tlen = np.array([T - 3 * (h % 3) for h in range(H)], np.int32)
    consts = (10, 5, 80, 80, 60)
    want = jbp.make_bp_advance_packed(T, H, *consts)(
        jnp.asarray(match), jnp.asarray(cons), jnp.asarray(aligned),
        jnp.asarray(ins_cnt), jnp.asarray(lead), jnp.asarray(row_mask),
        jnp.asarray(seg), jnp.asarray(tlen))
    got = bp_mod.make_bp_advance_packed(T, H, *consts)(
        *(torch.from_numpy(x) for x in (match, cons, aligned, ins_cnt, lead,
                                        row_mask)),
        torch.from_numpy(seg).long(), torch.from_numpy(tlen))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if T > 16:
        assert (got[0].numpy()[:len(rows)] >= 1).any()


# ---- one packed refine step --------------------------------------------------

@pytest.fixture(scope="module")
def refine_slab():
    """Four holes of 5, 9, 6 and 7 passes over ~400 bp templates packed into
    one slab (qmax 512, tmax from _fused_tmax), iters 2, and the JAX
    package's packed refine step on it."""
    rng = np.random.default_rng(23)
    cfg = CcsConfig(is_bam=False)
    sm = star.StarMsa(cfg.align, device="cpu")
    reqs = []
    for n in (5, 9, 6, 7):
        tpl = rng.integers(0, 4, int(rng.integers(380, 440))).astype(np.uint8)
        ps = [jsynth.mutate(rng, tpl, 0.02, 0.05, 0.05) for _ in range(n)]
        qs, qlens, row_mask = sm.pack(ps, cfg.pass_buckets, cfg.max_passes)
        reqs.append(star.RefineRequest(qs, qlens, row_mask, ps[0], 2))
    qmax = reqs[0].qs.shape[1]
    tmax = batch._fused_tmax(max(len(r.draft) for r in reqs),
                             cfg.len_bucket_quant)
    assert qmax == 512 and all(r.qs.shape[1] == qmax for r in reqs)
    ex = batch.BatchExecutor(cfg, device="cpu")
    args = ex._stack_slab(reqs, range(len(reqs)), qmax, tmax)
    H = args[4].shape[0]
    consts = ex._bp_consts()
    core = jbatch._refine_core_packed(JaxParams(), R_INS, tmax, 2, H, consts)
    want = jax.jit(core)(*args)
    return args, tmax, H, consts, [np.asarray(w) for w in want]


@pytest.mark.parametrize("impl", ["", "rotband"])
def test_packed_refine_step_matches_reference(impl, refine_slab):
    args, tmax, H, consts, want = refine_slab
    core = batch._refine_core_packed(AlignParams(), R_INS, tmax, 2, H, consts,
                                     impl)
    got = core(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    names = ("cons", "ins_base", "ins_votes", "ncov", "nwin", "bp",
             "advance", "dlen", "ovf")
    for name, w, g in zip(names, want, got):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert (want[5][:4] >= -1).all() and not want[8].any()


def test_slab_wire_protocol_round_trip(refine_slab):
    """The two-buffer slab protocol carries the step's inputs unchanged, and
    its one output buffer splits back into the core's nine fields."""
    args, tmax, H, consts, want = refine_slab
    R, qmax = args[0].shape
    big, small = batch._pack_slab_args(args)
    for a, b in zip(args, batch._unpack_slab_args(big, small, R, qmax, H,
                                                  tmax)):
        np.testing.assert_array_equal(b.numpy(), a)
    step = batch._refine_step_packed(AlignParams(), R_INS, tmax, 2, H,
                                     consts, (R, qmax))
    out = batch._unpack_slab_refine(step(big, small).numpy(), R_INS, tmax,
                                    H, R)
    order = (0, 1, 2, 3, 4, 5, 6, 7, 8)
    for k in order:
        np.testing.assert_array_equal(out[k], want[k])


# ---- the CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three holes of 900 bp templates (one with an adapter read-through),
    and the JAX package's --batch on output for it, FASTA and FASTQ."""
    rng = np.random.default_rng(17)
    zs = []
    for h in range(3):
        z = jsynth.make_zmw(rng, template_len=900, n_passes=5 + (h % 3),
                            movie="mv", hole=str(h), sub_rate=0.02,
                            ins_rate=0.05, del_rate=0.05)
        if h == 1:
            z.passes.insert(3, jsynth.read_through(rng, z.template))
            z.strands.insert(3, 0)
        zs.append(z)
    d = tmp_path_factory.mktemp("batch")
    fa = d / "in.fa"
    fa.write_text(jsynth.make_fasta(zs))
    ref = {}
    for fmt, extra in (("fasta", []), ("fastq", ["--fastq"])):
        out = d / f"ref.{fmt}"
        assert jcli.main(["-A", "-m", "800", "--batch", "on", "--device",
                          "cpu", *extra, str(fa), str(out)]) == 0
        ref[fmt] = out.read_bytes()
    assert ref["fasta"].count(b"/ccs\n") == 3
    return str(fa), ref


def _port_run(fa, tmp_path, *extra):
    out = tmp_path / "out"
    rc = cli.main(["-A", "-m", "800", "--device", "cpu", *extra, fa,
                   str(out)])
    return rc, (out.read_bytes() if out.exists() else b"")


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_cli_batch_on_matches_reference(fmt, corpus, tmp_path):
    fa, ref = corpus
    extra = ["--fastq"] if fmt == "fastq" else []
    assert _port_run(fa, tmp_path, "--batch", "on", *extra) == (0, ref[fmt])


def test_cli_batch_on_equals_batch_off(corpus, tmp_path):
    """The port twin of tests/test_batch.py's batched == per-hole pin."""
    fa, ref = corpus
    assert _port_run(fa, tmp_path, "--batch", "off") == (0, ref["fasta"])


def test_cli_rotband_arm_same_bytes(corpus, tmp_path):
    fa, ref = corpus
    assert _port_run(fa, tmp_path, "--batch", "on", "--banded-impl",
                     "rotband") == (0, ref["fasta"])


# ---- the driver's failure rules and its --batch choice ----------------------

@pytest.mark.parametrize("step,exc", [
    ("_refine_step_packed",
     cuda_ext.KernelError("rotating-band global fill: CUDA launch failed")),
    ("_refine_step_packed",
     RuntimeError("CUDA error: an illegal memory access was encountered")),
    ("_refine_step_packed",
     cuda_ext.RefusedInputs("traceback walk: inputs must be contiguous")),
    ("_pair_fill_packed",
     cuda_ext.RefusedInputs("banded local fill: inputs must be contiguous "
                            "rows"))])
@pytest.mark.parametrize("prep", ["0", "2"])
def test_device_fault_in_a_slab_ends_the_run(step, exc, prep, corpus,
                                             tmp_path, monkeypatch, capsys):
    """A kernel or card fault inside a slab or a pair group, or a kernel
    wrapper refusing its tensors there, is fatal: rc 1, no per-request
    replay, no quarantined hole — inline, and with the prep pool, whose
    pump thread runs the pair groups and hands the fault to the driver
    thread."""
    fa, _ = corpus

    def faulty(*a, **k):
        def run_step(*args):
            raise exc
        return run_step

    def no_replay(*a, **k):
        raise AssertionError("a device fault was replayed")

    monkeypatch.setattr(batch, step, faulty)
    monkeypatch.setattr(batch, "refine_host", no_replay)
    monkeypatch.setattr(batch, "HostAligner", no_replay)
    rc, _ = _port_run(fa, tmp_path, "--batch", "on", "--prep-threads", prep,
                      "-v")
    err = capsys.readouterr().err
    assert rc == 1
    assert "device failure, run aborted" in err and str(exc) in err
    assert "replaying" not in err and "failed:" not in err


def test_data_fault_replays_per_request_and_is_reported(corpus, tmp_path,
                                                        monkeypatch, capsys):
    """A slab failing on its data (not the card's fault) replays each of
    its requests on the per-hole round: same bytes, rc 0, and the run says
    so without -v.  The step fails on real slabs only: its program's
    build runs it on an all-zero slab (pipeline/graphs.py), which a data
    fault cannot reach."""
    fa, ref = corpus
    real = batch._refine_step_packed

    def bad_data(*a, **k):
        step = real(*a, **k)

        def run_step(big, small):
            if bool(small.any()):
                raise IndexError("a slab's own data is at fault")
            return step(big, small)
        return run_step

    monkeypatch.setattr(batch, "_refine_step_packed", bad_data)
    assert _port_run(fa, tmp_path, "--batch", "on") == (0, ref["fasta"])
    err = capsys.readouterr().err
    assert "replaying per request" in err
    assert "failed_steps=" in err and "host_fallbacks=" in err


def test_oom_in_a_slab_bisects_with_the_same_bytes(corpus, tmp_path,
                                                   monkeypatch, capsys):
    fa, ref = corpus
    real = batch._refine_step_packed
    calls = []

    def oom_once(*a, **k):
        step = real(*a, **k)

        def wrapped(big, small):
            # the first real slab (a program's build runs an all-zero one)
            if bool(small.any()):
                calls.append(1)
                if len(calls) == 1:
                    raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
            return step(big, small)
        return wrapped

    monkeypatch.setattr(batch, "_refine_step_packed", oom_once)
    monkeypatch.setattr(batch.BatchExecutor, "oom_backoff_s", 0.0)
    # inline prep: the first refine step is the first slab of the schedule
    assert _port_run(fa, tmp_path, "--batch", "on", "--inflight", "3",
                     "--prep-threads", "0") == (0, ref["fasta"])
    err = capsys.readouterr().err
    assert "device OOM on a" in err and "resplitting (depth 1)" in err
    assert "replaying" not in err


@pytest.mark.parametrize("batch_arg,card,want", [
    ("auto", True, "batched"), ("auto", False, "per_hole"),
    ("on", False, "batched"), ("off", True, "per_hole"),
    (None, True, "batched"), (None, False, "per_hole")])
def test_batch_auto_is_on_for_the_card_off_for_the_cpu(
        batch_arg, card, want, tmp_path, monkeypatch):
    """The CLI's --batch, and run_pipeline's default (None here), which is
    the CLI's: auto."""
    called = []
    if card:
        monkeypatch.setattr(run, "resolve_device",
                            lambda requested: torch.device("cuda"))
        monkeypatch.setattr(cuda_ext, "load_all", lambda: None)
    monkeypatch.setattr(batch, "drive_batched",
                        lambda *a, **k: called.append("batched"))
    monkeypatch.setattr(run, "drive_per_hole",
                        lambda *a, **k: called.append("per_hole"))
    fa = tmp_path / "in.fa"
    fa.write_text(">m/1/0_4\nACGT\n")
    out = str(tmp_path / "out.fa")
    if batch_arg is None:
        cfg = CcsConfig(is_bam=False, device="cuda" if card else "cpu")
        assert run.run_pipeline(str(fa), out, cfg) == 0
    else:
        argv = ["-A", "--batch", batch_arg, str(fa), out]
        if not card:
            argv += ["--device", "cpu"]
        assert cli.main(argv) == 0
    assert called == [want]
