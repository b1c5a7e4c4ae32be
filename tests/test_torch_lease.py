"""The port's lease primitive (ccsx_tpu_torch/utils/lease.py) and the fleet
plane's integer-keyed wrappers over it (pipeline/fleet.py) against the JAX
package's.

tests/test_lease.py's scenario bodies (the 8-racer single-winner acquire,
torn-lease mtime expiry, expired-then-renewed, foreign-release no-op,
exclusive retirement) run through each lease domain — the JAX package's
string keys, the port's string keys and the port's range wrappers — and
the string-domain specifics through both packages.  The range table
(fleet.init_fleet, table_hash) and the queue scan give the JAX package's
state and hash.
"""

import json
import os
import time

import pytest

from test_lease import (LeaseOps, check_acquire_race_admits_exactly_one,
                        check_exclusive_retirement_single_winner,
                        check_expired_then_renewed_stays_owned,
                        check_release_ignores_foreign,
                        check_torn_lease_expires_by_mtime)

from ccsx_tpu.pipeline import fleet as jfleet
from ccsx_tpu.utils import journal as jjournal
from ccsx_tpu.utils import lease as jlease

from ccsx_tpu_torch.parallel import distributed
from ccsx_tpu_torch.pipeline import fleet
from ccsx_tpu_torch.utils import journal
from ccsx_tpu_torch.utils import lease as leaselib


def _ops(mod):
    return LeaseOps(path=mod.lease_path, read=mod.read_lease,
                    acquire=mod.try_acquire, renew=mod.renew,
                    expire=mod.expire_lease, release=mod.release,
                    graveyard=mod.GRAVEYARD)


# (ops, key) of each lease domain
DOMAINS = {"jax": (_ops(jlease), "j00001"), "port": (_ops(leaselib), "j00001"),
           "port-ranges": (_ops(fleet), 3)}
CHECKS = {"race": check_acquire_race_admits_exactly_one,
          "torn": check_torn_lease_expires_by_mtime,
          "renewed": check_expired_then_renewed_stays_owned,
          "foreign": check_release_ignores_foreign}
MODS = {"jax": (jlease, jjournal), "port": (leaselib, journal)}


@pytest.mark.parametrize("domain", list(DOMAINS))
@pytest.mark.parametrize("check", list(CHECKS))
def test_lease_scenarios(check, domain, tmp_path):
    ops, key = DOMAINS[domain]
    CHECKS[check](ops, str(tmp_path), key)


def test_range_leases_keep_the_string_layout(tmp_path):
    """fleet's integer keys are utils/lease's str(i): one file name, one
    owner record carrying the range, in either package."""
    for mod in (fleet, jfleet):
        d = str(tmp_path / mod.__name__)
        os.makedirs(d)
        rec = mod.try_acquire(d, 7, "w0", cid="c1")
        assert rec["range"] == 7 and rec["cid"] == "c1"
        assert mod.lease_path(d, 7) == os.path.join(d, "lease.7")
        assert leaselib.read_lease(d, "7") == rec


@pytest.mark.parametrize("pkg", list(MODS))
def test_exclusive_retirement_single_winner(pkg, tmp_path):
    # the port's writer, and the JAX package's, on the same fence
    mod, jrnl = MODS[pkg]
    assert jrnl.write_json_exclusive(str(tmp_path / "x.json"), {"a": 1})
    check_exclusive_retirement_single_winner(str(tmp_path / "done.j1.json"))


@pytest.mark.parametrize("pkg", list(MODS))
def test_acquire_record_carries_extra(pkg, tmp_path):
    mod, _ = MODS[pkg]
    d = str(tmp_path)
    rec = mod.try_acquire(d, "j00007", "replica-a",
                          extra={"port": 8851, "host": "h1"}, kind="job")
    assert rec["key"] == "j00007" and rec["pid"] == os.getpid()
    assert rec["port"] == 8851 and rec["host"] == "h1"
    assert mod.read_lease(d, "j00007") == rec
    assert mod.try_acquire(d, "j00007", "replica-b") is None


@pytest.mark.parametrize("pkg", list(MODS))
def test_renew_merges_extra_and_bumps_heartbeat(pkg, tmp_path):
    mod, _ = MODS[pkg]
    d = str(tmp_path)
    rec = mod.try_acquire(d, "r0", "replica-a", extra={"ready": False})
    time.sleep(0.01)
    assert mod.renew(d, "r0", rec, extra={"ready": True}) is True
    got = mod.read_lease(d, "r0")
    assert got["ready"] is True and got["renewed"] > rec["renewed"]
    assert mod.renew(d, "r0", dict(rec, worker="other")) is False


@pytest.mark.parametrize("pkg", list(MODS))
def test_reclaim_pid_leases_frees_only_that_pid(pkg, tmp_path):
    mod, jrnl = MODS[pkg]
    d = str(tmp_path)
    rec0 = mod.try_acquire(d, "j00001", "dead")
    rec2 = mod.try_acquire(d, "j00003", "dead")
    mod.try_acquire(d, "j00002", "alive")
    jrnl.write_json_atomic(mod.lease_path(d, "j00001"), dict(rec0, pid=987654))
    jrnl.write_json_atomic(mod.lease_path(d, "j00003"), dict(rec2, pid=987654))
    keys = ("j00001", "j00002", "j00003")
    assert mod.reclaim_pid_leases(d, keys, 987654) == ["j00001", "j00003"]
    assert mod.read_lease(d, "j00001") is None
    assert mod.read_lease(d, "j00002") is not None
    assert mod.read_lease(d, "j00003") is None


@pytest.mark.parametrize("pkg", list(MODS))
def test_list_leases_skips_tmp_and_filters_prefix(pkg, tmp_path):
    mod, _ = MODS[pkg]
    d = str(tmp_path)
    mod.try_acquire(d, "j00001", "a")
    mod.try_acquire(d, "r0", "b")
    open(os.path.join(d, "lease.r1.tmp"), "w").close()
    assert set(dict(mod.list_leases(d))) == {"j00001", "r0"}
    assert set(dict(mod.list_leases(d, prefix="r"))) == {"r0"}


@pytest.mark.parametrize("pkg", list(MODS))
def test_graveyard_names_collide_safely(pkg, tmp_path):
    mod, jrnl = MODS[pkg]
    d = str(tmp_path)
    for seq in range(3):
        rec = mod.try_acquire(d, "j00001", f"w{seq}")
        jrnl.write_json_atomic(mod.lease_path(d, "j00001"),
                               dict(rec, renewed=time.time() - 999))
        assert mod.expire_lease(d, "j00001", timeout_s=1.0, kill=False,
                                seq=0) is not None
    names = sorted(os.listdir(os.path.join(d, mod.GRAVEYARD)))
    assert names == [f"lease.j00001.{os.getpid()}.0",
                     f"lease.j00001.{os.getpid()}.0~1",
                     f"lease.j00001.{os.getpid()}.0~2"]


def test_range_table_and_queue_state_as_the_jax_packages(tmp_path):
    """init_fleet writes the JAX package's state (same ranges, same table
    hash), re-opens it unchanged, refuses a foreign split; queue_state
    counts done, leased and queued ranges the same way."""
    states = {}
    for name, mod in (("port", fleet), ("jax", jfleet)):
        d = str(tmp_path / name)
        out = str(tmp_path / f"{name}.fa")
        st = mod.init_fleet(d, "/data/in.bam", out, 10, 4, 10.0, cid="c9")
        assert mod.init_fleet(d, "/data/in.bam", out, 10, 4, 10.0) == st
        with pytest.raises(ValueError):
            mod.init_fleet(d, "/data/in.bam", out, 10, 3, 10.0)
        assert json.load(open(os.path.join(d, mod.FLEET_STATE))) == st
        mod.try_acquire(d, 1, "w")
        open(distributed.done_path(out, 0), "w").close()
        assert mod.queue_state(d, out, 4) == {"done": 1, "leased": 1,
                                              "queued": 2}
        states[name] = dict(st, output=None)
    assert states["port"] == states["jax"]
    assert fleet.table_hash("in.bam", 10, [(0, 5), (5, 10)]) == \
        jfleet.table_hash("in.bam", 10, [(0, 5), (5, 10)])
