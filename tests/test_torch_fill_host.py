"""The banded fill kernels' CUDA source, built for the host and held
against the plain fills.

csrc/banded_fill.cu is compiled here with g++ against a small header that
stands in for the CUDA builtins it uses: each warp runs as 32 threads, a
warp shuffle exchanges values through a slot array between two barrier
phases, and a launch runs its blocks' warps one after another.  The header
(``SHIM``) also has the byte permute and clamped funnel shift that
csrc/banded_rotband.cu uses: tests/test_torch_rotband_host.py builds that
source with it.  The kernel
bodies are the card's own source, so their lane arithmetic, shuffles, tie
rules, offsets and packing are checked on the CPU, bit for bit against
ops/banded.py, before any card run; only timing and the compiler for the
card are left to the card (tests/test_torch_cuda.py, chip_smoke.py).

Every output is an integer or a byte: the tolerance is exact equality.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.ops import banded, cuda_ext
from ccsx_tpu_torch.utils import synth

SHIM = r"""
#include <stdint.h>
#include <algorithm>
#include <barrier>
#include <thread>
#include <vector>
using std::max; using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(x) __attribute__((aligned(x)))
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
struct dim { unsigned x; };
thread_local dim threadIdx, blockIdx, blockDim;
struct int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned sh) {
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> (sh & 31));
}
inline uint32_t __funnelshift_rc(uint32_t lo, uint32_t hi, unsigned sh) {
  return (uint32_t)(((((uint64_t)hi) << 32) | lo) >> (sh < 32 ? sh : 32));
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (((uint64_t)y) << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
inline uint32_t __vcmpeq4(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    if (((a >> (8 * i)) & 0xff) == ((b >> (8 * i)) & 0xff)) r |= 0xffu << (8 * i);
  return r;
}
struct Warp { std::barrier<> bar{32}; long long slot[32]; };
inline Warp* g_warp = nullptr;
inline int host_lane() { return threadIdx.x & 31; }
template <class T> inline T exchange(T v, int src, bool ok) {
  g_warp->slot[host_lane()] = (long long)v;
  g_warp->bar.arrive_and_wait();
  T r = ok ? (T)g_warp->slot[src] : v;
  g_warp->bar.arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  return exchange(v, src & 31, true);
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  int s = host_lane() - (int)d;
  return exchange(v, s < 0 ? 0 : s, s >= 0);
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  int s = host_lane() + (int)d;
  return exchange(v, s > 31 ? 0 : s, s <= 31);
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) {
  return exchange(v, host_lane() ^ m, true);
}
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp->bar.arrive_and_wait(); }
template <class K, class... A>
void host_launch(int grid, int block, K kernel, A... args) {
  for (int b = 0; b < grid; ++b)
    for (int w = 0; w < block / 32; ++w) {
      Warp warp;
      g_warp = &warp;
      std::vector<std::thread> lanes;
      for (int l = 0; l < 32; ++l)
        lanes.emplace_back([=] {
          threadIdx.x = w * 32 + l; blockIdx.x = b; blockDim.x = block;
          kernel(args...);
        });
      for (auto& t : lanes) t.join();
    }
}
"""

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARAMS = AlignParams()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    with open(f"{cuda_ext.CSRC_DIR}/banded_fill.cu") as f:
        src = f.read()
    src = src.replace('asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));',
                      "lane = threadIdx.x & 31;")
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    # kernel<<<grid, block, 0, stream>>>(args) -> host_launch(grid, block,
    # kernel, args)
    src, n = re.subn(r"(\w+(?:<[\w, ]+>)?)<<<(.*?),\s*([^,]*?),\s*0,\s*stream>>>\(",
                     r"host_launch(\2, \3, \1, ", src, flags=re.S)
    assert n >= 2, "no kernel launch found in banded_fill.cu"
    d = tmp_path_factory.mktemp("fill_host")
    (d / "fill.cpp").write_text(src)
    r = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared",
                        "-fPIC", "-w", "-o", str(d / "fill.so"),
                        str(d / "fill.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    so = ctypes.CDLL(str(d / "fill.so"))
    so.ccsx_banded_global_warps.argtypes = [
        _P, _I, _P, _P, _L, _I, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P]
    so.ccsx_banded_local_warps.argtypes = [
        _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P]
    return so


def _ptr(a):
    return a.ctypes.data


def _host_global(so, qs, qlens, ts, tlens, warps, t_stride):
    n, qmax = qs.shape
    moves = np.full((n, qmax, 128), 0x77, np.uint8)  # the kernel writes all
    offs = np.full((n, qmax), -7, np.int32)
    score = np.full(n, 3, np.int32)
    p = PARAMS
    rc = so.ccsx_banded_global_warps(
        _ptr(qs), qmax, _ptr(qlens), _ptr(ts), t_stride, ts.shape[-1],
        _ptr(tlens), p.match, p.mismatch, p.gap_open, p.gap_extend,
        _ptr(moves), _ptr(offs), _ptr(score), n, warps, None)
    assert rc == 0
    return score, moves, offs


def _host_local(so, qs, qlens, ts, tlens, lines, warps):
    n, qmax = qs.shape
    out = np.full((7, n), 99, np.int32)
    p = PARAMS
    rc = so.ccsx_banded_local_warps(
        _ptr(qs), qmax, _ptr(qlens), _ptr(ts), ts.shape[1], _ptr(tlens),
        _ptr(lines), p.match, p.mismatch, p.gap_open, p.gap_extend,
        _ptr(out), n, warps, None)
    assert rc == 0
    return out


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def ties():
    return synth.fill_tie_cases(np.random.default_rng(31))


@pytest.mark.parametrize("warps", [1, 4])
def test_host_global_fill_matches_plain(lib, ties, warps):
    """The tie cases at one and at four problems per block (a part-filled
    last block): scores, offsets and every move byte, rows beyond qlen
    (zero) included."""
    qs, qlens, ts, tlens, _ = ties
    score, moves, offs = _host_global(lib, qs, qlens, ts, tlens, warps,
                                      ts.shape[1])
    res, m, o = banded.banded_global_moves(_t(qs), _t(qlens), _t(ts),
                                           _t(tlens))
    np.testing.assert_array_equal(score, res.score.numpy())
    np.testing.assert_array_equal(offs, o.numpy())
    np.testing.assert_array_equal(moves, m.numpy())


def test_host_global_fill_broadcast_unaligned_template(lib):
    """One template broadcast over the batch (stride 0, as the round
    passes it) from an odd byte offset, so no template row is word-aligned;
    and per-row templates with an odd stride."""
    rng = np.random.default_rng(3)
    tl, tmax, qmax, n = 333, 401, 390, 5
    t = rng.integers(0, 4, tl).astype(np.uint8)
    buf = np.full(tmax + 1, 5, np.uint8)
    buf[1:1 + tl] = t
    qs = np.full((n, qmax), 5, np.uint8)
    qlens = np.zeros(n, np.int32)
    for k in range(n - 1):
        q = synth.mutate(rng, t, 0.02, 0.08, 0.05)[:qmax]
        qs[k, :len(q)] = q
        qlens[k] = len(q)
    tlens = np.full(n, tl, np.int32)
    row = buf[1:]                                  # odd address
    got = _host_global(lib, qs, qlens, row, tlens, 2, 0)
    res, m, o = banded.banded_global_moves(
        _t(qs), _t(qlens), _t(row)[None].expand(n, tmax), _t(tlens))
    for g, w in zip(got, (res.score, m, o)):
        np.testing.assert_array_equal(g, w.numpy())
    ts = np.full((n, tmax), 5, np.uint8)
    for k in range(n):
        L = int(rng.integers(100, 400))
        ts[k, :L] = rng.integers(0, 4, L)
        tlens[k] = L
    got = _host_global(lib, qs, qlens, ts, tlens, 1, tmax)
    res, m, o = banded.banded_global_moves(_t(qs), _t(qlens), _t(ts),
                                           _t(tlens))
    for g, w in zip(got, (res.score, m, o)):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("case", ["seeded", "corners", "unpacked"])
def test_host_local_fill_matches_plain(lib, ties, case):
    """The tie cases with their seeded lines and with the corners, and with
    the template rows padded to 32,768 bytes: the body that keeps the
    statistics unpacked (qmax + tmax + 128 >= 32768)."""
    qs, qlens, ts, tlens, lines = ties
    if case == "corners":
        lines = banded.corner_lines(_t(qlens), _t(tlens)).numpy()
    if case == "unpacked":
        wide = np.full((len(ts), 32768), 5, np.uint8)
        wide[:, :ts.shape[1]] = ts
        ts = wide
    lines = np.ascontiguousarray(lines, np.int32)
    got = _host_local(lib, qs, qlens, ts, tlens, lines, 2)
    want = banded.banded_local(_t(qs), _t(qlens), _t(ts), _t(tlens),
                               _t(lines))
    np.testing.assert_array_equal(got, np.stack([f.numpy() for f in want]))
