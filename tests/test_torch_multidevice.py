"""The port's multi-device dispatch and its control plane against the JAX
package's.

* The fused packed dispatch (BatchExecutor with more than one device,
  pipeline/batch.py): D = 2 and D = 8 logical CPU devices give the
  single-device executor's results and the JAX executor's on its virtual
  devices; one dispatch and one span a group a wave, with the JAX
  executor's fused_waves, fused_slabs_real and fused_slots on the same
  requests; an injected OOM bisects a wave and re-plans its halves with
  the same results, and a lasting one rides the ladder down to the
  per-request replay (the JAX package's tests/test_dispatch.py cases).
* ``--coordinator``: two port CLI processes (``--device cpu``) join one
  gloo process group through a localhost port, run their shares and merge
  to the JAX CLI's single-host bytes; a rank that cannot reach its
  coordinator ends at rc 1 and writes no shard.

The card's own cases (``[cuda:0] * 2`` fused and ``[cuda:0] * 8`` under
--mesh 4,2 equal to one device, each logical device launching the kernels
of its own work) are in tests/test_torch_cuda.py, which runs without JAX.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from ccsx_tpu import cli as jcli
from ccsx_tpu.config import CcsConfig as JaxConfig
from ccsx_tpu.pipeline import batch as jbatch
from ccsx_tpu.utils import faultinject as jfault
from ccsx_tpu.utils.metrics import Metrics

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.consensus import star
from ccsx_tpu_torch.parallel import distributed as dist
from ccsx_tpu_torch.pipeline import batch, graphs
from ccsx_tpu_torch.pipeline.warmup import WarmupCompiler
from ccsx_tpu_torch.utils import faultinject, synth, trace
from ccsx_tpu_torch.utils.run_metrics import RunMetrics

from test_packing import _requests

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU8 = [torch.device("cpu")] * 8
FUSED = ("fused_waves", "fused_slabs_real", "fused_slots",
         "packed_dispatches", "packed_holes", "dp_rows_real",
         "dp_rows_dispatched", "device_dispatches", "windows")


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.disarm()
    jfault.disarm()
    yield
    faultinject.disarm()
    jfault.disarm()


def _port(reqs):
    return [star.RefineRequest(r.qs, r.qlens, r.row_mask, r.draft, r.iters)
            for r in reqs]


def _same(a, b):
    np.testing.assert_array_equal(a.draft, np.asarray(b.draft))
    assert (a.rr.tlen, a.rr.bp) == (b.rr.tlen, b.rr.bp)
    for name in ("cons", "ins_base", "ins_votes", "ncov", "nwin",
                 "advance"):
        np.testing.assert_array_equal(getattr(a.rr, name),
                                      np.asarray(getattr(b.rr, name)),
                                      err_msg=name)


# ---- the fused dispatch -------------------------------------------------------

@pytest.mark.parametrize("D", [2, 8])
def test_fused_matches_one_device_and_jax(rng, D):
    cfg = JaxConfig(is_bam=False, slab_rows=16)
    _, reqs = _requests(rng, cfg)
    jm = Metrics()
    want = jbatch.BatchExecutor(cfg, metrics=jm,
                                devices=jax.local_devices()[:D]).run(
        list(reqs))
    pcfg = CcsConfig(is_bam=False, slab_rows=16)
    m = RunMetrics()
    ex = batch.BatchExecutor(pcfg, device="cpu", metrics=m,
                             devices=CPU8[:D])
    assert ex._slab_mesh is not None and ex.packing
    got = ex.run(_port(reqs))
    one = batch.BatchExecutor(pcfg, device="cpu", devices=CPU8[:1])
    assert one._slab_mesh is None
    for g, s, w in zip(got, one.run(_port(reqs)), want):
        _same(g, s)
        _same(g, w)
    for k in FUSED:
        assert getattr(m, k) == getattr(jm, k), k
    assert m.slabs == m.fused_slabs_real


def test_fused_one_dispatch_a_group_a_wave(rng):
    """D = 2 and a plan of two slabs a shape group: one wave, one dispatch
    and one span with the JAX package's shape tag and plan."""
    cfg = JaxConfig(is_bam=False, slab_rows=16)
    _, reqs = _requests(rng, cfg)
    jm = Metrics()
    jbatch.BatchExecutor(cfg, metrics=jm,
                         devices=jax.local_devices()[:2]).run(list(reqs))
    m = RunMetrics()
    spans = []
    tr = trace.Tracer(None, metrics=m)
    real_span = trace.device_span

    def spy(name, **kw):
        if name == "refine_packed":
            spans.append(kw)
        return real_span(name, **kw)

    trace.install(tr)
    try:
        batch.trace.device_span = spy
        batch.BatchExecutor(CcsConfig(is_bam=False, slab_rows=16),
                            device="cpu", metrics=m,
                            devices=CPU8[:2]).run(_port(reqs))
    finally:
        batch.trace.device_span = real_span
        trace.uninstall()
        tr.close()
    packed = {k: st for k, st in m.group_stats.items()
              if k.startswith("packed:")}
    assert packed
    for key, st in packed.items():
        assert st["dispatches"] == 1, (key, st)
    assert m.fused_waves == jm.fused_waves == len(packed) == len(spans)
    for sp in spans:
        assert sp["shape"].startswith("D2:R")
        assert sp["plan"]["chips"] == 2 and sp["plan"]["slabs"] == 2
        assert set(sp["plan"]) == {"wave", "slabs", "chips", "rows",
                                   "holes"}


def test_fused_warmup_builds_every_lane(rng, tmp_path):
    """--warmup under the fused dispatch: each predicted and each swept
    shape is built and warmed on every logical device before its wave, so
    no wave runs a step eagerly and every dispatch books as execute; the
    results are one device's."""
    cfg = CcsConfig(is_bam=False, slab_rows=16)
    _, reqs = _requests(rng, JaxConfig(is_bam=False, slab_rows=16))
    want = batch.BatchExecutor(cfg, device="cpu", devices=CPU8[:1]).run(
        _port(reqs))
    p = str(tmp_path / "t.jsonl")
    m = RunMetrics()
    tr = trace.Tracer(p, metrics=m)
    trace.install(tr)
    graphs.clear()
    graphs.reset_stats()
    wc = WarmupCompiler()
    try:
        ex = batch.BatchExecutor(cfg, device="cpu", metrics=m, warmup=wc,
                                 devices=CPU8[:2])
        for i, req in enumerate(_port(reqs)):
            ex.warm_refine(req, hole_id=i)
        assert wc.drain(timeout=120)
        got = ex.run(_port(reqs))
    finally:
        wc.close()
        trace.uninstall()
        tr.close()
    for g, w in zip(got, want):
        _same(g, w)
    lanes = {}
    for key, st in graphs.stats().items():
        if key[0] == "refine_packed":
            assert key[-1] in (1, 2), key
            ln = lanes.setdefault(key[-1], {"builds": 0, "eager": 0,
                                            "replays": 0, "warm": 0})
            ln["builds"] += st["builds"]
            ln["eager"] += st["eager"]
            ln["replays"] += st["replays"]
            ln["warm"] += st["warm_replays"]
    assert sorted(lanes) == [1, 2]
    for ln in lanes.values():
        assert ln["eager"] == 0 and ln["builds"] >= 1 and ln["warm"] >= 1
    assert all(ln["replays"] >= 1 for ln in lanes.values())
    recs = [json.loads(x) for x in open(p)]
    spans = [r for r in recs if r.get("ev") == "span"]
    warm = [r for r in spans if r.get("warmup")]
    disp = [r for r in spans if r["name"] == "refine_packed"]
    assert warm and disp and any(r["compile"] for r in warm)
    assert all(r["args"]["shape"].startswith("D2:R") for r in warm + disp)
    assert not any(r["compile"] for r in disp)


def test_fused_oom_bisect_and_host_ladder(rng):
    """An OOM on a wave bisects it by hole (each half re-planned, same
    results); a lasting one replays per request, with the same results."""
    cfg = JaxConfig(is_bam=False, slab_rows=16)
    sm, reqs = _requests(rng, cfg)
    want = batch.BatchExecutor(CcsConfig(is_bam=False, slab_rows=16),
                               device="cpu", devices=CPU8[:1]).run(
        _port(reqs))
    faultinject.arm("device_oom@1")
    m1 = RunMetrics()
    ex = batch.BatchExecutor(CcsConfig(is_bam=False, slab_rows=16),
                             device="cpu", metrics=m1, devices=CPU8[:2])
    assert ex._slab_mesh is not None
    res = ex.run(_port(reqs))
    assert m1.oom_resplits >= 1 and m1.host_fallbacks == 0
    for g, w in zip(res, want):
        _same(g, w)
    faultinject.arm("device_oom@1+")
    m2 = RunMetrics()
    res = batch.BatchExecutor(CcsConfig(is_bam=False, slab_rows=16),
                              device="cpu", metrics=m2,
                              devices=CPU8[:2]).run(_port(reqs))
    assert m2.host_fallbacks >= 1
    for g, w in zip(res, want):
        np.testing.assert_array_equal(g.draft, w.draft)
        assert g.rr.tlen == w.rr.tlen
        T = g.rr.tlen
        np.testing.assert_array_equal(g.rr.cons[:T], w.rr.cons[:T])


# ---- --coordinator --------------------------------------------------------------

def _corpus(d, seed=21, n_holes=3, tlen=600):
    from ccsx_tpu_torch.ops import encode as enc

    rng = np.random.default_rng(seed)
    zs = [synth.make_zmw(rng, tlen, 5 + (h % 3), movie="mv", hole=str(h))
          for h in range(n_holes)]
    fa = d / "in.fa"
    fa.write_text("".join(f">{n}\n{enc.decode(p)}\n" for z in zs
                          for n, p in zip(z.names, z.passes)))
    return fa


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_coordinator_run(tmp_path):
    """Two ranks rendezvous through a localhost coordinator, each runs its
    share, and the merge gives the JAX CLI's single-host bytes."""
    fa = _corpus(tmp_path)
    ref = tmp_path / "ref.fa"
    assert jcli.main(["-A", "-m", "500", "--batch", "on", str(fa),
                      str(ref)]) == 0
    out = tmp_path / "dist.fa"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    # the port picked here may be taken before rank 0 binds it: retry the
    # rendezvous on a fresh one if that race hits
    for attempt in range(3):
        port = _free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ccsx_tpu_torch.cli", "-A", "-m", "500",
             "--device", "cpu", "--hosts", "2", "--host-id", str(r),
             "--coordinator", f"127.0.0.1:{port}", str(fa), str(out)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if (attempt < 2 and any(p.returncode for p in procs)
                and any("in use" in se.lower() for _, se in outs)):
            continue
        break
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{so}\n{se}"
    assert dist.merge_shards(str(out), 2) == ref.read_text().count(">")
    assert out.read_bytes() == ref.read_bytes()


def test_unreachable_coordinator_is_rc1_and_writes_nothing(
        tmp_path, monkeypatch, capsys):
    fa = _corpus(tmp_path, n_holes=1)
    out = tmp_path / "o.fa"
    monkeypatch.setattr(dist, "RENDEZVOUS_TIMEOUT_S", 2.0)
    rc = cli.main(["-A", "-m", "500", "--device", "cpu", "--hosts", "2",
                   "--host-id", "1", "--coordinator",
                   f"127.0.0.1:{_free_port()}", str(fa), str(out)])
    assert rc == 1
    assert "could not rendezvous" in capsys.readouterr().err
    assert not list(tmp_path.glob("o.fa*"))
    assert not torch.distributed.is_initialized()
