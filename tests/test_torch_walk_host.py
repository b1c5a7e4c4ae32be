"""The traceback walk's CUDA source, built for the host and held against the
plain walk.

csrc/traceback_walk.cu is compiled here with g++ against a small header
that stands in for what it uses of CUDA: its barrier and bulk-copy helpers
(mbarrier, cp.async.bulk) become a mutex-guarded phase counter and a
memcpy, a block's shared memory a buffer, and a launch runs each block's
threads at once, as real threads (the producer, mask and walker
warps wait on each other, so they cannot run one after another).  Warp
ballots and __syncwarp go through a per-warp barrier.  The kernel body is
the card's own source, so the ring's stage and phase arithmetic, the
row-level chain, the insertion registers and the plain-load fallback are
checked on the CPU, bit for bit against ``traceback.project_plain``,
before any card run; only timing and the compiler for the card are left to
the card (tests/test_torch_cuda.py, chip_smoke.py).

Every output is an integer or a byte: the tolerance is exact equality.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch


from ccsx_tpu_torch.ops import cuda_ext, traceback
from ccsx_tpu_torch.utils import synth

from test_torch_traceback import QMAX, TMAX, _corpus, _jax_moves

SHIM = r"""
#define CCSX_HOST_SHIM 1
#include <stdint.h>
#include <string.h>
#include <algorithm>
#include <atomic>
#include <barrier>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(x) __attribute__((aligned(x)))
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K> inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
struct dim { unsigned x; };
thread_local dim threadIdx, blockIdx, blockDim;
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline int __clzll(long long x) {
  return x ? __builtin_clzll((unsigned long long)x) : 64;
}
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
struct HostWarp {
  std::barrier<> bar{32};
  int slot[32];
};
struct HostBlock {
  explicit HostBlock(int threads, int smem)
      : bar(threads), warps(threads / 32), ring(smem + 16) {}
  std::barrier<> bar;
  std::vector<HostWarp> warps;
  std::vector<uint8_t> ring;
};
inline HostBlock* g_block = nullptr;
inline HostWarp& host_warp() { return g_block->warps[threadIdx.x / 32]; }
inline void __syncthreads() { g_block->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_warp().bar.arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned, int pred) {
  HostWarp& w = host_warp();
  w.slot[threadIdx.x & 31] = pred != 0;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (unsigned)w.slot[l] << l;
  w.bar.arrive_and_wait();
  return m;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  HostWarp& w = host_warp();
  w.slot[threadIdx.x & 31] = (int)v;
  w.bar.arrive_and_wait();
  T r = (T)w.slot[src & 31];
  w.bar.arrive_and_wait();
  return r;
}
inline uint8_t* ring_base() {
  uintptr_t p = (uintptr_t)g_block->ring.data();
  return (uint8_t*)((p + 15) & ~(uintptr_t)15);
}
// an mbarrier: arrivals and transaction bytes outstanding in the current
// phase; the phase advances when both reach zero
struct mbar_t {
  std::mutex mu;
  int count = 1, pending = 1;
  long tx = 0;
  std::atomic<unsigned> phase{0};
};
inline void mbar_settle(mbar_t* b) {
  if (b->pending == 0 && b->tx == 0) {
    b->pending = b->count;
    b->phase.fetch_add(1);
  }
}
inline void mbar_init(mbar_t* b, unsigned count) {
  std::lock_guard<std::mutex> g(b->mu);
  b->count = b->pending = (int)count;
  b->tx = 0;
  b->phase.store(0);
}
inline void mbar_fence_init() {}
inline void mbar_arrive(mbar_t* b) {
  std::lock_guard<std::mutex> g(b->mu);
  --b->pending;
  mbar_settle(b);
}
inline void mbar_expect_tx(mbar_t* b, unsigned bytes) {
  std::lock_guard<std::mutex> g(b->mu);
  b->tx += bytes;
  --b->pending;
  mbar_settle(b);
}
inline bool mbar_try_wait(mbar_t* b, unsigned parity) {
  if ((b->phase.load() & 1u) != parity) return true;
  std::this_thread::yield();
  return false;
}
inline void bulk_load(void* dst, const void* src, unsigned bytes, mbar_t* b) {
  memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> g(b->mu);
  b->tx -= bytes;
  mbar_settle(b);
}
template <class K, class... A>
void host_launch(int grid, int block, int smem, K kernel, A... args) {
  for (int b = 0; b < grid; ++b) {
    HostBlock blk(block, smem);
    g_block = &blk;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        threadIdx.x = t; blockIdx.x = b; blockDim.x = block;
        kernel(args...);
      });
    for (auto& t : threads) t.join();
  }
}
"""

_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    with open(f"{cuda_ext.CSRC_DIR}/traceback_walk.cu") as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    # kernel<<<grid, block, smem, stream>>>(args) -> host_launch(grid,
    # block, smem, kernel, args)
    src, n = re.subn(r"(\w+<\w+>)<<<(\w+), (\w+), (\w+), stream>>>\(",
                     r"host_launch(\2, \3, \4, \1, ", src)
    assert n == 1, "no kernel launch found in traceback_walk.cu"
    d = tmp_path_factory.mktemp("walk_host")
    (d / "walk.cpp").write_text(src)
    r = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-shared",
                        "-fPIC", "-w", "-o", str(d / "walk.so"),
                        str(d / "walk.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    so = ctypes.CDLL(str(d / "walk.so"))
    so.ccsx_traceback_walk_variant.argtypes = [
        _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    return so


def _host_walk(so, moves, offs, qs, qlens, tlens, tmax, max_ins, rows=32,
               stages=4, threads=96):
    moves, offs, qs, qlens, tlens = (np.ascontiguousarray(x) for x in
                                     (moves, offs, qs, qlens, tlens))
    n, qmax, _ = moves.shape
    # outputs start as garbage: the kernel writes every byte of them
    out = (np.full((n, tmax), 0x77, np.uint8),
           np.full((n, tmax), -9, np.int32),
           np.full((n, tmax, max_ins), 0x77, np.uint8),
           np.full(n, -9, np.int32))
    rc = so.ccsx_traceback_walk_variant(
        moves.ctypes.data, offs.ctypes.data, qs.ctypes.data, qmax,
        qlens.ctypes.data, tlens.ctypes.data, tmax, max_ins,
        *(o.ctypes.data for o in out), n, rows, stages, threads, None)
    assert rc == 0
    return out


def _plain(moves, offs, qs, qlens, tlens, tmax, max_ins):
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (moves, offs, qs, qlens, tlens)]
    return [x.numpy() for x in traceback.project_plain(*t, tmax, max_ins)]


NAMES = ("aligned", "ins_cnt", "ins_b", "lead_ins")


def _check(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{name} ({what})")


@pytest.mark.parametrize("ring", [(64, 4, 96), (32, 2, 128)])
def test_host_walk_matches_plain_on_fill_moves(lib, ring):
    """The JAX fill's moves of the parity corpus (where project_plain equals
    make_projector_reference), at the default ring and at 32-row tiles on
    two stages with a fourth, filling warp."""
    qs, qlens, ts, tlen = _corpus(np.random.default_rng(23))
    moves, offs = _jax_moves(qs, qlens, ts, tlen)
    tlens = np.full(len(qs), tlen, np.int32)
    _check(_host_walk(lib, moves, offs, qs, qlens, tlens, TMAX, 4, *ring),
           _plain(moves, offs, qs, qlens, tlens, TMAX, 4), f"ring {ring}")


@pytest.mark.parametrize("max_ins", [1, 4, 16])
def test_host_walk_matches_plain_on_random_bytes(lib, max_ins):
    """Random bytes, offsets out of the band and edge lengths, through the
    bulk copy (qmax 256) with the ring wrapping eight times on two stages."""
    cases = synth.walk_cases(np.random.default_rng(5), QMAX, TMAX)
    _check(_host_walk(lib, *cases, TMAX, max_ins, 32, 2),
           _plain(*cases, TMAX, max_ins), f"max_ins {max_ins}")


def test_host_walk_plain_loads_on_odd_shapes(lib):
    """qmax not a multiple of 16, an odd tmax, and a move buffer that does
    not start on a 16-byte boundary: the producer warp's plain loads."""
    qmax, tmax = 203, 251
    cases = list(synth.walk_cases(np.random.default_rng(7), qmax, tmax, n=14))
    _check(_host_walk(lib, *cases, tmax, 4),
           _plain(*cases, tmax, 4), "qmax 203")
    qmax = 208                                   # bulk-sized, but unaligned
    cases = list(synth.walk_cases(np.random.default_rng(8), qmax, tmax, n=6))
    buf = np.zeros(cases[0].size + 1, np.uint8)
    shifted = buf[1:].reshape(cases[0].shape)
    shifted[:] = cases[0]
    assert shifted.ctypes.data % 16
    _check(_host_walk(lib, shifted, *cases[1:], tmax, 4, 32, 8),
           _plain(*cases, tmax, 4), "unaligned moves")
