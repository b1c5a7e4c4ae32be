"""The rotating-band fill's CUDA source, built for the host and held against
its plain version.

csrc/banded_rotband.cu is compiled here with g++ against the header of
tests/test_torch_fill_host.py, which stands in for the CUDA builtins: each
warp runs as 32 threads, a warp shuffle exchanges values through a slot
array between two barrier phases, and ``__byte_perm`` and
``__funnelshift_rc`` are written out byte by byte.  The kernel body is the
card's own source, so its split-lane arithmetic, the cyclic F scan's
masks, the two byte permutes and the deferred F bits are checked on the
CPU, bit for bit against ``rotband_global_moves``, before any card run;
only timing and the compiler for the card are left to the card
(tests/test_torch_cuda.py, chip_smoke.py).

A lane that skips a shuffle its warp takes leaves the other 31 waiting at
the barrier, so every launch here runs under a time limit of its own and a
hang fails the test.

Every output is an integer or a byte: the tolerance is exact equality.
"""

import ctypes
import re
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.ops import banded_rotband, cuda_ext
from ccsx_tpu_torch.utils import synth

from test_torch_fill_host import SHIM

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARAMS = AlignParams()
# O + E = 0: band position 0's F bit (its F and its left neighbour NEG) is 0
# here and 8 under the defaults
ZERO_GAP = AlignParams(gap_open=3, gap_extend=-3)
LIMIT_S = 60


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    with open(f"{cuda_ext.CSRC_DIR}/banded_rotband.cu") as f:
        src = f.read()
    src = src.replace('asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));',
                      "lane = threadIdx.x & 31;")
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    src, n = re.subn(r"(\w+)<<<(.*?),\s*([^,]*?),\s*0,\s*stream>>>\(",
                     r"host_launch(\2, \3, \1, ", src, flags=re.S)
    assert n == 1, "no kernel launch found in banded_rotband.cu"
    d = tmp_path_factory.mktemp("rotband_host")
    (d / "rot.cpp").write_text(src)
    r = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared",
                        "-fPIC", "-w", "-o", str(d / "rot.so"),
                        str(d / "rot.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    so = ctypes.CDLL(str(d / "rot.so"))
    so.ccsx_banded_rotband.argtypes = [
        _P, _I, _P, _P, _L, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P]
    return so


def _host_rotband(so, qs, qlens, ts, tlens, t_stride, tmax, p=PARAMS):
    """The host build on (qs, qlens, the template rows at ts with row
    stride t_stride, tlens), under LIMIT_S seconds."""
    n, qmax = qs.shape
    moves = np.full((n, qmax, 128), 0x77, np.uint8)  # the kernel writes all
    offs = np.full((n, qmax), -7, np.int32)
    score = np.full(n, 3, np.int32)
    rc = []

    def call():
        rc.append(so.ccsx_banded_rotband(
            qs.ctypes.data, qmax, qlens.ctypes.data, ts.ctypes.data, t_stride,
            tmax, tlens.ctypes.data, p.match, p.mismatch, p.gap_open,
            p.gap_extend, moves.ctypes.data, offs.ctypes.data,
            score.ctypes.data, n, None))

    th = threading.Thread(target=call, daemon=True)
    th.start()
    th.join(LIMIT_S)
    assert not th.is_alive(), (f"the host build did not finish in {LIMIT_S}s:"
                               " a lane is waiting on a shuffle")
    assert rc == [0]
    return score, moves, offs


def _plain(qs, qlens, ts, tlens, p=PARAMS):
    return [x.numpy() for x in banded_rotband.rotband_global_moves(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (qs, qlens, ts, tlens)), p)]


def _check(got, want):
    for name, g, w in zip(("score", "moves", "offsets"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("params", [PARAMS, ZERO_GAP], ids=["default", "O+E=0"])
def test_host_rotband_tie_cases(lib, params):
    """The tie cases: homopolymers, all-mismatch pairs, repeats, qlen 0, 1
    and == qmax, tlen < 128, a band clipped at tcap; every move byte,
    rows beyond qlen (zero) included; under the default scores and under
    scores whose O + E is 0."""
    qs, qlens, ts, tlens, _ = synth.fill_tie_cases(np.random.default_rng(31))
    _check(_host_rotband(lib, qs, qlens, ts, tlens, ts.shape[1], ts.shape[1],
                         params),
           _plain(qs, qlens, ts, tlens, params))


def test_host_rotband_cases(lib):
    """Band offsets through every (OFF % 4, d) pair, the ring wrapped up to
    three times, bands clipped at tcap for about 190 rows, tlen < 128, qlen
    0, 1 and == qmax."""
    qs, qlens, ts, tlens = synth.rotband_cases(np.random.default_rng(5))
    _check(_host_rotband(lib, qs, qlens, ts, tlens, ts.shape[1], ts.shape[1]),
           _plain(qs, qlens, ts, tlens))


def test_host_rotband_broadcast_and_unaligned_templates(lib):
    """One template broadcast over the batch (stride 0, as the per-hole
    round passes it) from an odd byte offset, so no template row is
    word-aligned; and per-row templates at an odd stride from an odd
    offset."""
    qs, qlens, ts, tlens = synth.rotband_cases(np.random.default_rng(5))
    tmax = ts.shape[1]
    # the slope-2.7 template under three queries that follow it
    rng = np.random.default_rng(3)
    t = ts[5]
    tl = int(tlens[5])
    n = 3
    bq = np.full((n, 256), 5, np.uint8)
    bql = np.zeros(n, np.int32)
    for k in range(n):
        q = synth.mutate(rng, t[:tl], 0.02, 0.02, 0.6)[:256]
        bq[k, :len(q)] = q
        bql[k] = len(q)
    buf = np.full(tmax + 1, 5, np.uint8)
    buf[1:] = t
    row = buf[1:]                                  # odd address
    btl = np.full(n, tl, np.int32)
    _check(_host_rotband(lib, bq, bql, row, btl, 0, tmax),
           _plain(bq, bql, np.broadcast_to(row, (n, tmax)), btl))
    # rows 13 (tlen < 128) and 15-16 (qlen 0 and 1) at stride tmax + 1
    sel = [13, 15, 16]
    wide = np.full((len(sel), tmax + 1), 5, np.uint8)
    wide[:, :tmax] = ts[sel]
    flat = np.concatenate([np.full(1, 5, np.uint8), wide.reshape(-1)])[1:]
    _check(_host_rotband(lib, qs[sel], qlens[sel], flat, tlens[sel], tmax + 1,
                         tmax),
           _plain(qs[sel], qlens[sel], ts[sel], tlens[sel]))
