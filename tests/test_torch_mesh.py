"""The port's device mesh (ccsx_tpu_torch/parallel/mesh.py, the executor's
(data, pass) mesh under --mesh D,P, mesh_precheck) against the JAX
package's.

The JAX side runs on the conftest's 8 virtual CPU devices; the port's on 8
logical CPU devices: an explicit ``devices=[cpu] * 8`` list, or
``utils/device.local_devices`` patched to return one, its counterpart of
those virtual devices.  Every comparison is exact: the vote's counts are
integer sums over the pass axis, so no split may change a bit.

* ``make_sharded_round`` at (4, 2) equals the JAX package's sharded round;
  (8, 1) and (2, 4) equal (4, 2); a pass shard with no live row adds zero.
* ``BatchExecutor(devices=[cpu] * 8, mesh (4, 2))``: bare rounds equal the
  JAX executor's under the same mesh and the JAX per-hole round; refine
  requests equal the JAX host refinement spec (refine_host) and the
  single-device executor.
* The CLI on a few ~600 bp holes: ``--batch on --mesh 4,2`` gives the JAX
  CLI's bytes for the same flags, plain and sharded over two ranks and
  merged; ``--mesh nope`` is rc 1; ``--mesh 16,2`` with 8 devices is rc 1
  ("invalid --mesh") and leaves an existing output or shard file as it
  was; with one device it is ignored (the stderr line) and gives the same
  bytes.
"""

import numpy as np
import pytest
import torch

import jax

from ccsx_tpu import cli as jcli
from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.config import CcsConfig as JaxConfig
from ccsx_tpu.consensus import star as jstar
from ccsx_tpu.parallel import mesh as jmesh
from ccsx_tpu.pipeline import batch as jbatch

from ccsx_tpu_torch import cli
from ccsx_tpu_torch.config import AlignParams, CcsConfig
from ccsx_tpu_torch.consensus import star
from ccsx_tpu_torch.parallel import distributed as dist
from ccsx_tpu_torch.parallel import mesh as mesh_mod
from ccsx_tpu_torch.pipeline import batch
from ccsx_tpu_torch.utils import device as device_mod
from ccsx_tpu_torch.utils import faultinject, synth

from test_sharded_round import _batch

W = 256
MAX_INS = 4
CPU8 = [torch.device("cpu")] * 8
FIELDS = ("cons", "ins_base", "ins_votes", "ncov", "nwin")
PORT = ["-A", "-m", "500", "--device", "cpu", "--batch", "on"]


@pytest.fixture(autouse=True)
def _disarm():
    faultinject.disarm()
    yield
    faultinject.disarm()


@pytest.fixture
def eight_devices(monkeypatch):
    """local_devices patched to 8 logical CPU devices."""
    monkeypatch.setattr(device_mod, "local_devices", lambda device: CPU8)


# ---- the sharded round ------------------------------------------------------

def _port_round(shape, qs, qlens, ts, tlens, row_mask):
    m = mesh_mod.build_mesh(shape, devices=CPU8[:int(np.prod(shape))])
    return mesh_mod.make_sharded_round(m, AlignParams(), W, MAX_INS)(
        qs, qlens, ts, tlens, row_mask)


def test_sharded_round_matches_jax(rng):
    """(4, 2): the port's five outputs equal the JAX sharded round's."""
    args = _batch(rng, Z=8, P=8)
    m = jmesh.build_mesh(shape=(4, 2), devices=jax.devices()[:8])
    want = jmesh.make_sharded_round(m, JaxParams(), tmax=W,
                                    max_ins=MAX_INS)(*args)
    got = _port_round((4, 2), *args)
    for g, w, name in zip(got, want, FIELDS):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_sharded_round_split_invariant(rng, shape):
    """The pass-axis split changes nothing: (8, 1) and (2, 4) equal
    (4, 2)."""
    args = _batch(rng, Z=8, P=8)
    base = _port_round((4, 2), *args)
    for g, w, name in zip(_port_round(shape, *args), base, FIELDS):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {shape}")


def test_sharded_round_dead_rows_on_one_pass_shard(rng):
    """A hole whose live passes all lie on one pass shard votes as the JAX
    sharded round does (the other shard's counts are zero)."""
    qs, qlens, ts, tlens, row_mask = _batch(rng, Z=4, P=8, dead_rows=False)
    row_mask[:, 4:] = False
    qlens[:, 4:] = 0
    qs[:, 4:] = 5
    args = (qs, qlens, ts, tlens, row_mask)
    m = jmesh.build_mesh(shape=(4, 2), devices=jax.devices()[:8])
    want = jmesh.make_sharded_round(m, JaxParams(), tmax=W,
                                    max_ins=MAX_INS)(*args)
    got = _port_round((4, 2), *args)
    for g, w, name in zip(got, want, FIELDS):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert int(got[3].max()) <= 4


def test_build_mesh_default_split_and_entries():
    """JAX's default split (pass 2 when n >= 4 and even), one entry per
    listed device, each with its index; no stream on the CPU."""
    assert mesh_mod.build_mesh(devices=CPU8).shape == (4, 2)
    assert mesh_mod.build_mesh(devices=CPU8[:3]).shape == (3, 1)
    m = mesh_mod.build_slab_mesh(CPU8[:2])
    assert m.shape == (2,) and m.axis_names == ("slab",)
    assert [e.index for e in m.flat] == [0, 1]
    assert all(e.stream is None for e in m.flat)


# ---- the executor's (data, pass) mesh --------------------------------------

def _round_requests(rng, n=5):
    sm = jstar.StarMsa(JaxParams(), max_ins=MAX_INS, len_quant=512)
    out = []
    for i in range(n):
        tpl = rng.integers(0, 4, 500 + 40 * i).astype(np.uint8)
        ps = [synth.mutate(rng, tpl, 0.02, 0.03, 0.03)
              for _ in range(5 + i % 4)]            # pass bucket 8
        qs, qlens, mask = sm.pack(ps, (4, 8, 16, 32), 32)
        out.append((qs, qlens, mask, ps[0]))
    return out


def test_executor_mesh_rounds_match_jax(rng, capsys):
    """Bare rounds over a (4, 2) mesh of 8 logical devices: cons, ins,
    ncov, bp and advance equal the JAX executor's under the same mesh and
    the JAX per-hole round's; packing goes off with the JAX line."""
    reqs = _round_requests(rng)
    want = jbatch.BatchExecutor(JaxConfig(is_bam=False, mesh_shape=(4, 2))
                                ).run([jstar.RoundRequest(*r) for r in reqs])
    ex = batch.BatchExecutor(CcsConfig(is_bam=False, mesh_shape=(4, 2)),
                             device="cpu", devices=CPU8)
    assert ex._mesh is not None and ex._mesh.shape == (4, 2)
    assert not ex.packing
    assert "pass packing disabled under --mesh" in capsys.readouterr().err
    got = ex.run([star.RoundRequest(*r) for r in reqs])
    sm = jstar.StarMsa(JaxParams(), max_ins=MAX_INS, len_quant=512)
    for r, w, g in zip(reqs, want, got):
        host = sm.round(*r)
        assert (g.tlen, g.bp) == (w.tlen, w.bp)
        for name in FIELDS + ("advance",):
            np.testing.assert_array_equal(getattr(g, name),
                                          np.asarray(getattr(w, name)),
                                          err_msg=name)
        for name in ("cons", "ins_base", "ins_votes", "ncov"):
            np.testing.assert_array_equal(getattr(g, name),
                                          np.asarray(getattr(host, name)),
                                          err_msg=name)


def _refine_requests(rng, specs=((5, 600, 0.1), (7, 900, 0.1),
                                 (6, 600, 0.0))):
    sm = jstar.StarMsa(JaxParams(), max_ins=MAX_INS, len_quant=512)
    out = []
    for n, tlen, err in specs:
        tpl = rng.integers(0, 4, tlen).astype(np.uint8)
        ps = ([tpl.copy() for _ in range(n)] if err == 0 else
              [synth.mutate(rng, tpl, err / 3, err / 3, err / 3)
               for _ in range(n)])
        qs, qlens, mask = sm.pack(ps, (4, 8, 16, 32), 32)
        out.append((qs, qlens, mask, ps[0], 2))
    return sm, out


def test_fused_refine_under_mesh_matches_refine_host(rng):
    """Refine requests over the (4, 2) mesh (the speculative rounds, the
    freeze and the breakpoint scan across pass entries) equal the JAX
    host refinement spec and the single-device executor."""
    sm, reqs = _refine_requests(rng)
    got = batch.BatchExecutor(CcsConfig(is_bam=False, mesh_shape=(4, 2)),
                              device="cpu", devices=CPU8).run(
        [star.RefineRequest(*r) for r in reqs])
    one = batch.BatchExecutor(CcsConfig(is_bam=False, pass_packing=False),
                              device="cpu", devices=CPU8[:1]).run(
        [star.RefineRequest(*r) for r in reqs])
    for r, g, s in zip(reqs, got, one):
        want = jstar.refine_host(sm.round, *r)
        np.testing.assert_array_equal(g.draft, np.asarray(want.draft))
        T = g.rr.tlen
        assert T == want.rr.tlen
        for name in ("cons", "ins_base", "ins_votes", "ncov"):
            np.testing.assert_array_equal(
                getattr(g.rr, name)[:T],
                np.asarray(getattr(want.rr, name))[:T], err_msg=name)
        assert (g.rr.tlen, g.rr.bp) == (s.rr.tlen, s.rr.bp)
        for name in FIELDS + ("advance",):
            np.testing.assert_array_equal(getattr(g.rr, name),
                                          getattr(s.rr, name), err_msg=name)


def test_validate_mesh_rules():
    """JAX's rules: a bad shape raises; too few devices raises only when
    more than one is visible."""
    v = batch.BatchExecutor.validate_mesh
    assert v((4, 2), 8) == (4, 2)
    assert v((3,), 8) == (3, 1)
    assert v(None, 8) == (8, 1)
    assert v((16, 2), 1) == (16, 2)
    with pytest.raises(ValueError, match="needs 32 devices, host has 8"):
        v((16, 2), 8)
    with pytest.raises(ValueError):
        v((0, 2), 8)
    with pytest.raises(ValueError):
        v((2, 2, 2), 8)


# ---- the CLI ------------------------------------------------------------------

def _make_corpus(d, seed=5, n_holes=3, tlen=600):
    from ccsx_tpu_torch.ops import encode as enc

    rng = np.random.default_rng(seed)
    zs = [synth.make_zmw(rng, tlen, 5 + (h % 3), movie="mv", hole=str(h))
          for h in range(n_holes)]
    fa = d / "in.fa"
    fa.write_text("".join(f">{n}\n{enc.decode(p)}\n" for z in zs
                          for n, p in zip(z.names, z.passes)))
    return fa


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A few holes and the JAX CLI's ``--batch on --mesh 4,2`` bytes."""
    d = tmp_path_factory.mktemp("mesh")
    fa = _make_corpus(d)
    ref = d / "ref.fa"
    assert jcli.main(["-A", "-m", "500", "--batch", "on", "--mesh", "4,2",
                      str(fa), str(ref)]) == 0
    assert ref.read_bytes().count(b">") >= 2
    return fa, ref.read_bytes()


def test_cli_mesh_bytes_equal_the_jax_cli(corpus, tmp_path, eight_devices,
                                          capsys):
    fa, want = corpus
    out = tmp_path / "o.fa"
    assert cli.main(PORT + ["--mesh", "4,2", str(fa), str(out)]) == 0
    assert out.read_bytes() == want
    assert "pass packing disabled under --mesh" in capsys.readouterr().err


def test_cli_mesh_unparsable_is_rc1(tmp_path, capsys):
    for mod in (cli, jcli):
        assert mod.main(["--mesh", "nope", "x.fa",
                          str(tmp_path / "y.fa")]) == 1
        assert "--mesh expects D,P integers" in capsys.readouterr().err


def test_cli_mesh_too_large_leaves_the_output(corpus, tmp_path,
                                             eight_devices, capsys):
    fa, _ = corpus
    out = tmp_path / "o.fa"
    out.write_text("precious\n")
    assert cli.main(PORT + ["--mesh", "16,2", str(fa), str(out)]) == 1
    err = capsys.readouterr().err
    assert "invalid --mesh: mesh (16, 2) needs 32 devices, host has 8" in err
    assert out.read_text() == "precious\n"


def test_cli_mesh_ignored_on_one_device(corpus, tmp_path, capsys):
    fa, want = corpus
    assert device_mod.local_devices("cpu") == [torch.device("cpu")]
    out = tmp_path / "o.fa"
    assert cli.main(PORT + ["--mesh", "16,2", str(fa), str(out)]) == 0
    assert "--mesh ignored: single device visible" in \
        capsys.readouterr().err
    assert out.read_bytes() == want


def test_cli_sharded_mesh_merges_to_the_jax_bytes(corpus, tmp_path,
                                                  eight_devices):
    fa, want = corpus
    out = tmp_path / "dist.fa"
    for r in range(2):
        assert cli.main(PORT[:-2] + ["--hosts", "2", "--host-id", str(r),
                                     "--mesh", "4,2", str(fa),
                                     str(out)]) == 0
    assert dist.merge_shards(str(out), 2) == want.count(b">")
    assert out.read_bytes() == want


def test_cli_sharded_invalid_mesh_leaves_the_shard(corpus, tmp_path,
                                                   eight_devices, capsys):
    fa, _ = corpus
    out = tmp_path / "o.fa"
    shard = tmp_path / "o.fa.shard0"
    shard.write_text("precious\n")
    assert cli.main(PORT[:-2] + ["--hosts", "2", "--host-id", "0",
                                 "--mesh", "16,2", str(fa), str(out)]) == 1
    assert "invalid --mesh" in capsys.readouterr().err
    assert shard.read_text() == "precious\n"


def test_cli_mesh_batch_off_note(corpus, tmp_path, capsys):
    fa, want = corpus
    out = tmp_path / "o.fa"
    assert cli.main(PORT[:-2] + ["--batch", "off", "--mesh", "4,2",
                                 str(fa), str(out)]) == 0
    assert "--mesh has no effect with --batch off" in \
        capsys.readouterr().err
    assert out.read_bytes() == want
