"""The warmup plane of the port (pipeline/warmup.py, pipeline/graphs.py,
--warmup and --no-warmup) against the JAX package's.

The WarmupCompiler pins of tests/test_dispatch.py run against the port's
copy; the device-only refine loop (exactly iters + 1 rounds, no host read,
the form a CUDA graph captures) against the early-exit loop and the JAX
package's packed refine step on the same numpy slabs; the program cache's
static buffers with two same-shape slabs in flight; the dispatch rule (a
shape's first slab eager, its second builds from the same step); the warm
proof in the trace (warmup spans book the compile, the first dispatch
books execute); the CLI with --warmup, --no-warmup and neither against the
JAX CLI's bytes; the capture budget per packed group; a program whose
build raises; and an out-of-memory error, which drops the programs and
reaches the resplit as itself.  Everything runs on the CPU.  Every output is an integer or a byte:
the tolerance is exact equality.
"""

import json
import threading
import time

import numpy as np
import pytest

from ccsx_tpu import cli as jcli
from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.pipeline import batch as jbatch
from ccsx_tpu.utils import synth as jsynth

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.config import AlignParams, CcsConfig
from ccsx_tpu_torch.consensus import star
from ccsx_tpu_torch.ops import cuda_ext
from ccsx_tpu_torch.pipeline import batch, graphs
from ccsx_tpu_torch.pipeline.warmup import WarmupCompiler
from ccsx_tpu_torch.utils import synth, trace
from ccsx_tpu_torch.utils.run_metrics import RunMetrics

M = 4                        # max_ins
CONSTS = (10, 5, 80, 80, 60)
NAMES = ("cons", "ins_base", "ins_votes", "ncov", "nwin", "bp", "advance",
         "dlen", "ovf")


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---- WarmupCompiler (tests/test_dispatch.py's pins, on the port's copy) ---

def test_warmup_compiler_runs_each_key_once():
    wc = WarmupCompiler()
    try:
        ran = []
        for _ in range(3):
            wc.submit("k", lambda: ran.append(1))
        assert wc.drain(timeout=10)
        assert ran == [1]
        assert not wc.submit("k", lambda: ran.append(1))
        assert len(wc._threads) == 1 and wc.debounce_s == 0.0
    finally:
        wc.close()


def test_warmup_compiler_claim_semantics():
    """queued -> cancelled (dispatch captures inline); running -> wait
    Event; done/unknown -> None; a cancelled key is resubmittable."""
    wc = WarmupCompiler()
    try:
        gate = threading.Event()
        started = threading.Event()
        ran = []

        def slow():
            started.set()
            gate.wait(10)

        wc.submit("slow", slow)
        started.wait(10)
        wc.submit("queued", lambda: ran.append(1))
        assert wc.claim("queued") is None
        ev = wc.claim("slow")
        assert ev is not None and not ev.is_set()
        assert wc.busy()
        gate.set()
        assert ev.wait(10)
        assert wc.drain(timeout=10)
        assert not wc.busy()
        assert ran == []
        assert wc.claim("slow") is None
        assert wc.claim("never-submitted") is None
        assert wc.submit("queued", lambda: ran.append(2))
        assert wc.drain(timeout=10)
        assert ran == [2]
    finally:
        wc.close()


def test_warmup_urgent_jumps_debouncing_queue():
    wc = WarmupCompiler(debounce_s=5.0, workers=1)
    try:
        ran = []
        wc.submit("pred", lambda: ran.append("pred"))
        wc.submit("exact", lambda: ran.append("exact"), urgent=True)
        t0 = time.monotonic()
        while "exact" not in ran and time.monotonic() - t0 < 3:
            time.sleep(0.02)
        assert ran == ["exact"]
    finally:
        wc.close()
    assert not wc.submit("late", lambda: None)   # closed


def test_warmup_compiler_builder_failure_contained(capsys):
    wc = WarmupCompiler()
    try:
        wc.submit("boom", lambda: 1 / 0)
        ok = []
        wc.submit("ok", lambda: ok.append(1))
        assert wc.drain(timeout=10)
        assert ok == [1]
    finally:
        wc.close()
    err = capsys.readouterr().err
    assert "[ccsx-tpu-torch] warmup capture failed for 'boom'" in err


# ---- the device-only refine loop -----------------------------------------

def _hole(rng, n, tlen, err, cut=0):
    """RefineRequest parts of one hole: ``n`` passes over a random
    template (identical copies when ``err`` is 0), and a draft that is the
    first pass with ``cut`` bases taken out, spread evenly (each a one-base
    insertion to restore, so the draft can grow by all of them in one
    round)."""
    tpl = rng.integers(0, 4, tlen).astype(np.uint8)
    ps = [tpl.copy() if err == 0 else
          jsynth.mutate(rng, tpl, err / 3, err / 3, err / 3)
          for _ in range(n)]
    draft = ps[0]
    if cut:
        drop = np.linspace(5, len(draft) - 5, cut).astype(int)
        draft = np.delete(draft, drop)
    return ps, draft


@pytest.fixture(scope="module")
def loop_slabs():
    """Two packed slabs of one shape (R 32, qmax 1024, tmax 512, H 8):
    'frozen', three holes of identical passes (each freezes after round
    1), and 'mixed': a noisy hole, a hole whose draft outgrows tmax (150
    bases cut from a 600-base template, one in four) and a frozen one;
    both have empty hole slots."""
    rng = np.random.default_rng(31)
    cfg = CcsConfig(is_bam=False, slab_rows=32)
    sm = star.StarMsa(cfg.align, device="cpu")
    specs = {"frozen": [(7, 300, 0.0, 0), (6, 350, 0.0, 0), (5, 280, 0.0, 0)],
             "mixed": [(6, 400, 0.1, 0), (7, 600, 0.03, 150),
                       (4, 300, 0.0, 0)]}
    ex = batch.BatchExecutor(cfg, device="cpu")
    slabs = {}
    for name, holes in specs.items():
        reqs = []
        for n, tlen, err, cut in holes:
            ps, draft = _hole(rng, n, tlen, err, cut)
            qs, qlens, mask = sm.pack(ps, cfg.pass_buckets, cfg.max_passes)
            qs = np.pad(qs, ((0, 0), (0, 1024 - qs.shape[1])),
                        constant_values=5)
            reqs.append(star.RefineRequest(qs, qlens, mask, draft, 2))
        args = ex._stack_slab(reqs, range(len(reqs)), 1024, 512)
        assert args[0].shape == (32, 1024) and args[4].shape == (8, 512)
        slabs[name] = args
    return slabs


def _jax_step(args, iters):
    R, qmax = args[0].shape
    H, tmax = args[4].shape
    big, small = jbatch._pack_slab_args(args, M)
    step = jbatch._refine_step_packed(JaxParams(), M, tmax, iters, H, CONSTS,
                                      (R, qmax))
    ob, os_ = step(big, small)
    return jbatch._unpack_slab_refine(np.asarray(ob), np.asarray(os_), M,
                                      tmax, H, R)


def _port_step(args, iters, device_only, rounds):
    R, qmax = args[0].shape
    H, tmax = args[4].shape
    big, small = batch._pack_slab_args(args)
    step = batch._refine_step_packed(AlignParams(), M, tmax, iters, H,
                                     CONSTS, (R, qmax),
                                     device_only=device_only)
    real = batch._refine_loop

    def counting(one_round, *a, **k):
        def counted(d, dl):
            rounds.append(1)
            return one_round(d, dl)
        return real(counted, *a, **k)

    batch._refine_loop = counting
    try:
        out = step(big, small).numpy()
    finally:
        batch._refine_loop = real
    return batch._unpack_slab_refine(out, M, tmax, H, R)


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_device_only_loop_matches_early_exit_and_reference(iters,
                                                           loop_slabs):
    for name, args in loop_slabs.items():
        want = _jax_step(args, iters)
        early, dev = [], []
        got_early = _port_step(args, iters, False, early)
        got_dev = _port_step(args, iters, True, dev)
        # exactly iters + 1 rounds on the device; the early exit stops
        # after round 1 once every hole of 'frozen' froze
        assert len(dev) == iters + 1, name
        if name == "frozen":
            assert len(early) == 1
        for k, w, e, d in zip(NAMES, want, got_early, got_dev):
            np.testing.assert_array_equal(d, e, err_msg=f"{name} {k}")
            np.testing.assert_array_equal(d, np.asarray(w),
                                          err_msg=f"{name} {k}")
        ovf = got_dev[8]
        if name == "mixed" and iters:
            assert ovf[1] and not ovf[[0, 2]].any()
        assert not ovf[3:].any() and (got_dev[7][3:] == 1).all()


def test_two_same_shape_slabs_in_flight_through_the_program(loop_slabs):
    """Both slabs dispatched through one cached program before either is
    read back: each gives the JAX step's bytes (the static output is
    cloned at each run)."""
    ex = batch.BatchExecutor(CcsConfig(is_bam=False, slab_rows=32),
                             device="cpu")
    prog = ex._packed_program(1024, 512, 2, 32, 8)
    assert prog is ex._packed_program(1024, 512, 2, 32, 8)
    assert prog.graph is None and prog.out.shape[0] == (
        8 * 512 * (3 + 2 * M) + 4 * (3 * 8 + 32))
    outs = [prog.run(*batch._pack_slab_args(args))
            for args in loop_slabs.values()]
    assert outs[0].data_ptr() != outs[1].data_ptr()
    for out, args in zip(outs, loop_slabs.values()):
        got = batch._unpack_slab_refine(out.numpy(), M, 512, 8, 32)
        for k, w, g in zip(NAMES, _jax_step(args, 2), got):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    st = graphs.stats()[prog.key]
    assert st["replays"] >= 2 and st["graph"] is False


# ---- the warm proof --------------------------------------------------------

SPECS = [(3, 500, 0.12), (5, 500, 0.06), (4, 500, 0.0), (9, 500, 0.12),
         (11, 500, 0.1)]


def _requests(rng, cfg):
    sm = star.StarMsa(cfg.align, device="cpu")
    reqs = []
    for n, tlen, err in SPECS:
        tpl = rng.integers(0, 4, tlen).astype(np.uint8)
        ps = [tpl.copy() if err == 0.0 else
              jsynth.mutate(rng, tpl, err / 3, err / 3, err / 3)
              for _ in range(n)]
        qs, qlens, mask = sm.pack(ps, cfg.pass_buckets, cfg.max_passes)
        reqs.append(star.RefineRequest(qs, qlens, mask, ps[0],
                                       cfg.refine_iters))
    return reqs


def test_warmup_first_dispatch_books_execute(tmp_path):
    """After warm_refine and drain, every real refine_packed dispatch books
    as steady-state execute: the warmup spans (warmup: true, compile:
    true) paid for the programs, off the dispatch path."""
    cfg = CcsConfig(is_bam=False, slab_rows=16)
    reqs = _requests(np.random.default_rng(0), cfg)
    p = str(tmp_path / "t.jsonl")
    metrics = RunMetrics()
    tr = trace.Tracer(p, metrics=metrics)
    trace.install(tr)
    wc = WarmupCompiler()
    try:
        ex = batch.BatchExecutor(cfg, device="cpu", metrics=metrics,
                                 warmup=wc)
        for i, req in enumerate(reqs):
            ex.warm_refine(req, hole_id=i)
        assert wc.drain(timeout=120)
        res = ex.run(list(reqs))
    finally:
        wc.close()
        trace.uninstall()
        tr.close()
    assert all(isinstance(r, star.RefineResult) for r in res)
    recs = [r for r in _read_jsonl(p) if r.get("ev") == "span"]
    warm = [r for r in recs if r.get("warmup")]
    disp = [r for r in recs if r["name"] == "refine_packed"]
    assert warm and disp
    assert all(r["compile"] is False for r in disp), \
        "a warmed shape's first dispatch must book as execute"
    assert any(r["compile"] for r in warm)
    packed = {k: st for k, st in metrics.group_stats.items()
              if k.startswith("packed:")}
    for key, st in packed.items():
        assert st["compiles"] >= 1 and st["execute_s"] > 0
    summ = trace.summarize([p])
    for key, st in packed.items():
        assert summ["groups"][key]["compiles"] == st["compiles"]
        assert summ["groups"][key]["dispatches"] == st["dispatches"]
    assert metrics.distinct_slab_shapes == len(
        {r["args"]["shape"] for r in disp})


# ---- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three holes of 600 bp templates and the JAX CLI's --batch on bytes."""
    rng = np.random.default_rng(2)
    zs = [jsynth.make_zmw(rng, template_len=600, n_passes=5 + h,
                          movie="mv", hole=str(h)) for h in range(3)]
    d = tmp_path_factory.mktemp("warm")
    fa = d / "in.fa"
    fa.write_text(jsynth.make_fasta(zs))
    out = d / "ref.fa"
    assert jcli.main(["-A", "-m", "1000", "--batch", "on", "--device", "cpu",
                      "--no-warmup", str(fa), str(out)]) == 0
    ref = out.read_bytes()
    assert ref.count(b"/ccs\n") == 3
    return str(fa), ref


def test_cli_no_warmup_reaches_config_and_keeps_bytes(corpus, tmp_path):
    """On the card the plane is off unless --warmup; on the CPU it is on
    unless --no-warmup, as the JAX CLI's is everywhere.  The bytes are the
    JAX CLI's either way."""
    def warmup(*argv):
        args = cli.build_parser().parse_args([*argv, "in", "out"])
        return cli.config_from_args(args).warmup_compile

    assert warmup("--no-warmup") is False and warmup() is False
    assert warmup("--warmup") is True
    assert warmup("--warmup", "--no-warmup") is False
    assert warmup("--device", "cpu") is True
    assert warmup("--device", "cpu", "--no-warmup") is False
    fa, ref = corpus
    for extra in ([], ["--no-warmup"]):
        out = tmp_path / "o.fa"
        assert cli.main(["-A", "-m", "1000", "--device", "cpu", "--batch",
                         "on", *extra, fa, str(out)]) == 0
        assert out.read_bytes() == ref, extra


@pytest.mark.parametrize("extra", [[], ["--no-warmup"]])
def test_capture_budget_per_packed_group(tmp_path, extra):
    """About 12 holes through the batched driver under --trace, with and
    without the warmup plane: each packed group builds at most
    slab_shape_ladder + 1 programs (warmup spans and inline builds alike
    book a group's compiles)."""
    rng = np.random.default_rng(12)
    zs = [synth.make_zmw(rng, template_len=int(rng.integers(400, 700)),
                         n_passes=int(rng.integers(4, 9)), movie="mv",
                         hole=str(h)) for h in range(12)]
    fa = tmp_path / "in.fa"
    fa.write_text(synth.make_fasta(zs))
    t, m = str(tmp_path / "t.jsonl"), str(tmp_path / "m.jsonl")
    assert cli.main(["-A", "-m", "400", "--device", "cpu", "--batch", "on",
                     "--slab-rows", "32", "--trace", t, "--metrics", m,
                     *extra, str(fa), str(tmp_path / "o.fa")]) == 0
    fin = [e for e in _read_jsonl(m) if e["event"] == "final"][0]
    packed = {k: g for k, g in fin["groups"].items()
              if k.startswith("packed:")}
    assert packed and fin["holes_out"] > 0
    for key, g in packed.items():
        assert 1 <= g["compiles"] <= CcsConfig().slab_shape_ladder + 1, key
    assert fin["distinct_slab_shapes"] >= len(packed)


def test_a_program_whose_build_raises_ends_the_run(corpus, tmp_path,
                                                   monkeypatch, capsys):
    """rc 1, the build's error named, and no eager rerun: the step runs
    only in the builds (the priming runs on all-zero slabs), never on a
    slab, and no request is replayed per hole.  A shape's program is
    built at its first dispatch here (CAPTURE_AT 1): at the default a
    shape's first slab runs the step eagerly, where a raising step is the
    data's fault (tests/test_torch_batch.py)."""
    fa, _ = corpus
    monkeypatch.setattr(graphs, "CAPTURE_AT", 1)
    graphs.clear()
    calls = []

    def broken(*a, **k):
        def step(big, small):
            calls.append(bool(small.any()))
            raise RuntimeError("the step cannot be built")
        return step

    def no_replay(*a, **k):
        raise AssertionError("a failed build was rerun per request")

    monkeypatch.setattr(batch, "_refine_step_packed", broken)
    monkeypatch.setattr(batch, "refine_host", no_replay)
    out = tmp_path / "o.fa"
    rc = cli.main(["-A", "-m", "1000", "--device", "cpu", "--batch", "on",
                   "--prep-threads", "0", fa, str(out)])
    err = capsys.readouterr().err
    assert rc == 1
    assert "device failure, run aborted" in err
    assert "the build raised RuntimeError: the step cannot be built" in err
    assert calls and not any(calls)     # all-zero slabs only
    assert "replaying" not in err


def test_launches_add_at_replay_not_at_capture():
    """cuda_ext.tally keeps a thread's counts out of LAUNCHES (a capture
    records launches it does not make); add() books a replay's."""
    cuda_ext.reset_counts()
    with cuda_ext.tally() as t:
        cuda_ext.count("traceback_walk")
        cuda_ext.count("banded_global")
    assert t["traceback_walk"] == 1 and t["banded_global"] == 1
    assert sum(cuda_ext.LAUNCHES.values()) == 0
    cuda_ext.add({"traceback_walk": 3})
    cuda_ext.count("banded_local")
    assert cuda_ext.LAUNCHES["traceback_walk"] == 3
    assert cuda_ext.LAUNCHES["banded_local"] == 1
    cuda_ext.reset_counts()


# ---- the dispatch rule and out-of-memory errors ---------------------------

def _counting_step(calls):
    def make():
        def step(x):
            calls.append(x.clone())
            return x * 2 + 1
        return step
    return make


@pytest.mark.parametrize("capture_at", [1, 2, 3])
def test_dispatch_runs_eagerly_then_builds_from_the_same_step(
        capture_at, monkeypatch):
    """A shape's first CAPTURE_AT - 1 dispatches run its step eagerly on
    the slab; the next builds the program from that same step object,
    primed on the zero inputs only when no eager run came first; later
    dispatches run the program.  Every output is the step's on its slab."""
    monkeypatch.setattr(graphs, "CAPTURE_AT", capture_at)
    graphs.reset_stats()
    calls, made = [], []
    make = _counting_step(calls)

    def factory():
        made.append(1)
        return make()

    key = ("dispatch-rule", capture_at)
    spec = [((4,), graphs.torch.int32)]
    slabs = [graphs.torch.arange(4, dtype=graphs.torch.int32) + 10 * i
             for i in range(4)]
    for i, x in enumerate(slabs):
        out = graphs.dispatch(key, factory, spec, "cpu", x)
        assert graphs.torch.equal(out, x * 2 + 1), i
    st = graphs.stats()[key]
    assert made == [1]
    assert st["eager"] == capture_at - 1 and st["builds"] == 1
    assert st["replays"] == 4 - (capture_at - 1)
    primed = capture_at == 1
    assert len(calls) == 4 + primed
    if primed:
        assert not calls[0].any()       # the priming run's zero inputs
    graphs.clear()


def test_an_oom_in_a_build_reaches_the_resplit_as_itself():
    """An out-of-memory error while a program is built (priming or
    capture) stays torch.cuda.OutOfMemoryError, which classify_failure
    sends down the resplit ladder; any other build error is a
    KernelError, which ends the run."""
    def make(exc):
        def step(x):
            raise exc
        return lambda: step

    spec = [((2,), graphs.torch.int32)]
    with pytest.raises(graphs.torch.cuda.OutOfMemoryError) as oom:
        graphs.program(("oom-build",), make(
            graphs.torch.cuda.OutOfMemoryError("injected")), spec, "cpu")
    assert batch.classify_failure(oom.value) == "oom"
    with pytest.raises(cuda_ext.KernelError) as err:
        graphs.program(("bad-build",), make(ValueError("no")), spec, "cpu")
    assert batch.classify_failure(err.value) == "fatal"


def test_an_oom_drops_the_programs_before_the_split(corpus, tmp_path,
                                                    monkeypatch, capsys):
    """An out-of-memory error in a slab empties the program cache before
    the halves are retried (the halves are new shapes, built afresh), and
    the run keeps the JAX CLI's bytes."""
    fa, ref = corpus
    real = batch._refine_step_packed
    fired, clears = [], []

    def oom_once(*a, **k):
        step = real(*a, **k)

        def wrapped(big, small):
            if bool(small.any()) and not fired:
                fired.append(1)
                raise graphs.torch.cuda.OutOfMemoryError("injected OOM")
            return step(big, small)
        return wrapped

    real_clear = graphs.clear

    def clear():
        clears.append(len(graphs._programs) + len(graphs._eager))
        real_clear()

    monkeypatch.setattr(batch, "_refine_step_packed", oom_once)
    monkeypatch.setattr(graphs, "clear", clear)
    out = tmp_path / "o.fa"
    assert cli.main(["-A", "-m", "1000", "--device", "cpu", "--batch", "on",
                     "--prep-threads", "0", fa, str(out)]) == 0
    err = capsys.readouterr().err
    assert fired and "resplitting" in err and "replaying" not in err
    assert clears and clears[0] >= 1     # the failed shape's entry, at least
    assert out.read_bytes() == ref


def test_warmup_promote_jumps_the_queue_and_waits():
    """promote: a queued key builds next (ahead of older queued keys) and
    the caller waits for it; a running key is waited for; a finished or
    never-submitted key returns at once; a closed compiler never hangs a
    waiter."""
    wc = WarmupCompiler()
    try:
        gate = threading.Event()
        started = threading.Event()
        ran = []

        def slow():
            started.set()
            gate.wait(10)
            ran.append("slow")

        wc.submit("slow", slow)
        started.wait(10)
        wc.submit("older", lambda: ran.append("older"))
        wc.submit("wanted", lambda: ran.append("wanted"))
        threading.Timer(0.2, gate.set).start()
        assert wc.promote("wanted", timeout=10)
        assert ran[:2] == ["slow", "wanted"]
        assert wc.promote("wanted", timeout=0) and wc.promote("never")
        assert wc.drain(timeout=10) and ran[2] == "older"
    finally:
        wc.close()
    closed = WarmupCompiler()
    block = threading.Event()
    closed.submit("busy", lambda: block.wait(10))
    closed.submit("queued", lambda: None)
    threading.Timer(0.2, closed.close, kwargs={"timeout": 0.1}).start()
    assert closed.promote("queued", timeout=10)
    block.set()
