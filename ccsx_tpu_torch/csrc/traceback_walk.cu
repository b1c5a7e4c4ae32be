// Traceback walk for Hopper (sm_90a): move bytes -> star-MSA projection.
//
// Replaces: no Pallas original.  It replaces the lax.while_loop of the JAX
// package's ccsx_tpu/ops/traceback.py:173 make_projector_reference (its
// default projector), which walks one pass from (qlen, tlen) back to (0, 0)
// cell by cell, in qlen + tlen steps.  The plain version in
// ccsx_tpu_torch/ops/traceback.py (project_plain) is the spec it is held
// against, for any move bytes, offsets and lengths.
//
// What bounds it: the serial chain of one pass.  Every step needs the move
// byte of the cell it stands on, whose lane depends on the column the step
// before reached.  The first design (one thread walking cell by cell, each
// step two dependent global loads) paid an L2 round trip per cell, about
// 330 cycles.  A pass moves a few KB and does a few dozen integer
// operations per step, so neither bandwidth nor arithmetic is the limit:
// the latency of the chain is, a few cycles per dependent instruction and
// some 30 per shared-memory load.  Counting each integer operation of the
// walker's loop as one, a step that takes one row (an insertion, or a
// diagonal near the matrix edge) is 40, a jumped deletion run 30, and a run
// of diagonals 28 on each of the warp's 32 lanes (chip_smoke.py uses these
// counts for the bound, and keeps the smaller of this tally and the cell
// walk's, since both compute one function).
//
// What the design does about it: fewer steps, each from shared memory.
// - A row-level chain.  A global traceback consumes one query row per
//   diagonal or up move; the only moves that take several cells of one row
//   are horizontal (F) runs, and the length of a run is a function of the
//   row's move bytes alone: from an unclamped lane l it takes 1 + runc
//   cells, runc the number of consecutive F-extend bits from lane l down
//   (from the row's 128-bit F mask, by __clzll).  Where the lane is clamped
//   (the column lies left or right of the row's band) the cell walk keeps
//   re-reading the edge byte, and the run's end is again a closed form of
//   that byte: all the way to column 0 left of the band, down to lane 127
//   right of it, or one cell.  So every deletion run is one step, exact
//   for arbitrary bytes (choice 3 is LEFT, as in the plain walk).
// - Runs of diagonals in one step.  From a diagonal the walk's next cells
//   are known if they are diagonals too: (x - k, j - k).  The walker is a
//   warp; lane k - 1 reads cell k for k = 1..32, a ballot finds the first
//   cell that is no diagonal, and the lanes before it store their query
//   bases (one coalesced store).  The chain thus has one step per run of
//   diagonals, deletions or insertions, not one per cell.
// - Move rows in shared memory ahead of the walker.  The walk's rows are a
//   contiguous descending window, so a producer warp keeps a ring of
//   `stages` tiles of T rows (the move bytes, offsets and query bases, in
//   one region each, row x at ring row x % (stages * T)) filled by
//   cp.async.bulk into mbarrier-tracked stages; a second warp builds each
//   row's F mask with four ballots as a tile lands; the walker reads
//   bytes, offsets, masks and bases from shared memory only.  A shape the
//   bulk copy cannot take (qmax not a multiple of 16, or a base not 16-byte
//   aligned) is copied by the producer warp with plain loads instead.
// - Each output written once where it can be.  Before the walk the block
//   fills aligned with GAP below the clamped tlen and PAD beyond, ins_cnt
//   with 0 and ins_b with PAD, while the first tiles are in flight; the
//   walker then writes only diagonal bases, and each insertion slot's count
//   and cell once, when the walk leaves the slot: the first min(cnt,
//   max_ins) bases it met (the last ones in forward order) are kept in
//   shared memory and written left-justified.  No right-aligned pass, no
//   second pass.
// - One block per pass, three warps (producer, mask warp, walker) or
//   four (the fourth only fills).  The default ring, 4 stages of 64 rows
//   (38 KB), and 96 threads were the fastest within 48 KB on the card
//   (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBand = 128;
constexpr int kGap = 4;
constexpr int kPad = 5;
constexpr int kMaxIns = 16;
constexpr int kMaxStages = 8;
constexpr int kMaxThreads = 128;
enum { sH, sE, sF };

#ifndef CCSX_HOST_SHIM
// The asynchronous-copy and barrier primitives, as small helpers (a host
// build of this file replaces them with a memcpy and a mutex barrier).
typedef uint64_t mbar_t;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint8_t* ring_base() {
  extern __shared__ __align__(128) uint8_t ring[];
  return ring;
}

__device__ __forceinline__ void mbar_init(mbar_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(mbar_t* b) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}"
               :: "r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(mbar_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(b)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(mbar_t* b, unsigned parity) {
  uint32_t ok;
  asm volatile("{\n\t.reg .pred p;\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
               "selp.u32 %0, 1, 0, p;\n\t}"
               : "=r"(ok) : "r"(smem_u32(b)), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, mbar_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b))
               : "memory");
}
#endif

__device__ __forceinline__ void mbar_wait(mbar_t* b, unsigned parity) {
  while (!mbar_try_wait(b, parity)) {
  }
}

// The ring: `rows` = stages * T rows in four regions (move bytes, offsets,
// F masks, query bases).  Tile t of the pass (its rows [t*T, t*T + T))
// goes to stage t % stages, ring rows [s*T, s*T + T), so row x of the pass
// lies at ring row x % rows.
constexpr int kRowBytes = kBand + 4 + 16 + 1;

struct Ring {
  uint8_t* mv;
  int* of;
  uint4* mask;
  uint8_t* q;
  __device__ Ring(uint8_t* base, int rows)
      : mv(base),
        of(reinterpret_cast<int*>(base + rows * kBand)),
        mask(reinterpret_cast<uint4*>(base + rows * (kBand + 4))),
        q(base + rows * (kBand + 4 + 16)) {}
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// n bytes of v from dst, by `nt` threads: bytes up to a 16-byte boundary,
// then 16 bytes a store.
__device__ void fill_bytes(uint8_t* dst, int n, uint8_t v, int tid, int nt) {
  const int head = (int)((16 - ((uintptr_t)dst & 15)) & 15);
  const int h = head < n ? head : n;
  for (int x = tid; x < h; x += nt) dst[x] = v;
  const uint32_t w = v * 0x01010101u;
  const uint4 v4 = make_uint4(w, w, w, w);
  uint4* body = reinterpret_cast<uint4*>(dst + h);
  const int nv = (n - h) >> 4;
  for (int x = tid; x < nv; x += nt) body[x] = v4;
  for (int x = h + (nv << 4) + tid; x < n; x += nt) dst[x] = v;
}

__device__ void fill_zero_ints(int* dst, int n, int tid, int nt) {
  int head = (int)(((16 - ((uintptr_t)dst & 15)) & 15) >> 2);
  head = head < n ? head : n;
  for (int x = tid; x < head; x += nt) dst[x] = 0;
  uint4* body = reinterpret_cast<uint4*>(dst + head);
  const int nv = (n - head) >> 2;
  for (int x = tid; x < nv; x += nt) body[x] = make_uint4(0, 0, 0, 0);
  for (int x = head + (nv << 2) + tid; x < n; x += nt) dst[x] = 0;
}

// Put tile k (the k-th from the top: rows [t*T, t*T + n), t = ntiles-1-k)
// into stage t % stages and arrive on the stage's full barrier: by
// cp.async.bulk from lane 0, or by the producer warp's plain loads.  A row
// x of the pass thus lies in stage (x / T) % stages, at index x % T.
template <int T>
__device__ void produce(int k, int ntiles, int stages, int qmax, bool bulk,
                        const uint8_t* mv, const int* of, const uint8_t* q,
                        const Ring& ring, mbar_t* full, int lane) {
  const int t = ntiles - 1 - k;
  const int s = t & (stages - 1);
  const int r0 = t * T;
  const int n = qmax - r0 < T ? qmax - r0 : T;
  uint8_t* dmv = ring.mv + s * T * kBand;
  int* dof = ring.of + s * T;
  uint8_t* dq = ring.q + s * T;
  if (bulk) {
    if (lane == 0) {
      mbar_expect_tx(full + s, (unsigned)n * (kBand + 4 + 1));
      bulk_load(dmv, mv + (size_t)r0 * kBand, n * kBand, full + s);
      bulk_load(dof, of + r0, n * 4, full + s);
      bulk_load(dq, q + r0, n, full + s);
    }
    return;
  }
  const uint8_t* src = mv + (size_t)r0 * kBand;
  for (int x = lane; x < n * kBand; x += 32) dmv[x] = src[x];
  for (int x = lane; x < n; x += 32) dof[x] = of[r0 + x];
  for (int x = lane; x < n; x += 32) dq[x] = q[r0 + x];
  __syncwarp();
  if (lane == 0) mbar_arrive(full + s);
}

// The number of consecutive F-extend bits from lane l (0..127) down, in a
// row's mask (bit b of word w: lane 32w + b).
__device__ __forceinline__ int f_run(uint4 fm, int l) {
  const uint64_t clo = ~((uint64_t)fm.x | ((uint64_t)fm.y << 32));
  const uint64_t chi = ~((uint64_t)fm.z | ((uint64_t)fm.w << 32));
  int p;  // the highest lane <= l whose F bit is clear, -1 if none
  if (l >= 64) {
    const uint64_t x = chi & (~0ull >> (127 - l));
    p = x ? 127 - __clzll((long long)x)
          : (clo ? 63 - __clzll((long long)clo) : -1);
  } else {
    const uint64_t x = clo & (~0ull >> (63 - l));
    p = x ? 63 - __clzll((long long)x) : -1;
  }
  return l - p;
}

__device__ __forceinline__ int clamp_lane(int l) {
  return l < 0 ? 0 : (l > kBand - 1 ? kBand - 1 : l);
}

template <int T>
__global__ void __launch_bounds__(kMaxThreads)
walk_kernel(const uint8_t* __restrict__ moves, const int* __restrict__ offs,
            const uint8_t* __restrict__ qs, int qmax,
            const int* __restrict__ qlens, const int* __restrict__ tlens,
            int tmax, int max_ins, int stages, uint8_t* __restrict__ aligned,
            int* __restrict__ ins_cnt, uint8_t* __restrict__ ins_b,
            int* __restrict__ lead_ins) {
  __shared__ mbar_t bars[3 * kMaxStages];  // full | masks ready | empty
  __shared__ uint8_t kept[kMaxIns];  // the open slot's bases, as met
  mbar_t* full = bars;
  mbar_t* ready = bars + kMaxStages;
  mbar_t* empty = bars + 2 * kMaxStages;
  const int rows = stages * T, rmask = rows - 1;
  const Ring ring(ring_base(), rows);
  const int p = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  // lengths clamped to the padded widths: no input reads out of bounds
  const int ql = qlens[p], tl = tlens[p];
  const int i0 = ql < 0 ? 0 : (ql > qmax ? qmax : ql);
  const int j0 = tl < 0 ? 0 : (tl > tmax ? tmax : tl);
  const int ntiles = i0 > 0 ? (i0 - 1) / T + 1 : 0;
  const uint8_t* mv = moves + (size_t)p * qmax * kBand;
  const int* of = offs + (size_t)p * qmax;
  const uint8_t* q = qs + (size_t)p * qmax;
  const bool bulk = qmax % 16 == 0 && aligned16(mv) && aligned16(of) &&
                    aligned16(q);
  uint8_t* al = aligned + (size_t)p * tmax;
  int* ic = ins_cnt + (size_t)p * tmax;
  uint8_t* ib = ins_b + (size_t)p * tmax * max_ins;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(ready + s, 1);
      mbar_init(empty + s, 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  // the first tiles are copied while the block fills the outputs
  const int first = ntiles < stages ? ntiles : stages;
  if (warp == 0)
    for (int k = 0; k < first; ++k)
      produce<T>(k, ntiles, stages, qmax, bulk, mv, of, q, ring, full, lane);
  fill_bytes(al, j0, kGap, tid, nt);
  fill_bytes(al + j0, tmax - j0, kPad, tid, nt);
  fill_zero_ints(ic, tmax, tid, nt);
  fill_bytes(ib, tmax * max_ins, kPad, tid, nt);
  __syncthreads();

  if (warp == 0) {
    // producer: refill each stage once the walker has left it
    for (int k = first; k < ntiles; ++k) {
      if (bulk && lane != 0) break;
      mbar_wait(empty + ((ntiles - 1 - k) & (stages - 1)),
                ((k / stages) - 1) & 1);
      produce<T>(k, ntiles, stages, qmax, bulk, mv, of, q, ring, full, lane);
    }
  } else if (warp == 1) {
    // mask warp: each landed row's F bits as four 32-lane ballots
    for (int k = 0; k < ntiles; ++k) {
      const int t = ntiles - 1 - k;
      const int s = t & (stages - 1);
      mbar_wait(full + s, (k / stages) & 1);
      const int n = qmax - t * T < T ? qmax - t * T : T;
      for (int r = 0; r < n; ++r) {
        const uint8_t* row = ring.mv + (s * T + r) * kBand;
        const unsigned w0 = __ballot_sync(0xffffffffu, row[lane] & 8);
        const unsigned w1 = __ballot_sync(0xffffffffu, row[32 + lane] & 8);
        const unsigned w2 = __ballot_sync(0xffffffffu, row[64 + lane] & 8);
        const unsigned w3 = __ballot_sync(0xffffffffu, row[96 + lane] & 8);
        if (lane == 0) ring.mask[s * T + r] = make_uint4(w0, w1, w2, w3);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(ready + s);
    }
  } else if (warp == 2) {
    // the walker warp: every lane carries the same walk; lane 0 stores,
    // and the lanes look down a diagonal together.  Rows at and above
    // `landed` are in the ring; tiles at and above `tr` have been handed
    // back to the producer.
    int i = i0, j = j0, state = sH;
    int slot = 0, cnt = 0;              // the open insertion slot (0: none)
    int tw = ntiles, tr = ntiles;
    int landed = ntiles * T;
    auto land = [&](int x) {            // wait for the tiles down to row x
      while (x < landed) {
        --tw;
        landed -= T;
        mbar_wait(ready + (tw & (stages - 1)),
                  ((ntiles - 1 - tw) / stages) & 1);
      }
    };
    auto hand_back = [&](int x) {       // the tiles above row x
      while (x < (tr - 1) * T) {
        --tr;
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (tr & (stages - 1)));
      }
    };
    auto close_slot = [&]() {           // write the open slot's count and cell
      if (slot <= 0 || lane != 0) return;
      const int used = cnt < max_ins ? cnt : max_ins;
      ic[slot - 1] = cnt;
      uint8_t* cell = ib + (size_t)(slot - 1) * max_ins;
      for (int r = 0; r < used; ++r) cell[r] = kept[used - 1 - r];
    };
    // the byte the cell (x + 1, jj) stands on: row x, lane jj - off(x)
    auto byte_at = [&](int x, int jj) {
      return (int)ring.mv[(x & rmask) * kBand +
                          clamp_lane(jj - ring.of[x & rmask])];
    };

    if (i > 0 && j > 0) {
      land(i - 1);
      int m = byte_at(i - 1, j);
      for (;;) {
        const int x = i - 1;            // the current row
        if (state == sH && (m & 3) == 0 && x >= 32 && j > 32) {
          // a diagonal: lane k - 1 reads cell k down the diagonal, (x - k,
          // j - k) for k = 1..32, and the run of diagonals up to the first
          // other move is taken in one step
          if (x - 32 < landed) land(x - 32);
          const int mk = byte_at(x - 1 - lane, j - 1 - lane);
          const unsigned stop = __ballot_sync(0xffffffffu, (mk & 3) != 0);
          const int run = stop ? __ffs(stop) : 32;  // cells 0..run-1
          if (lane < run) al[j - 1 - lane] = ring.q[(x - lane) & rmask];
          m = __shfl_sync(0xffffffffu, mk, run - 1);
          i -= run;
          j -= run;
          hand_back(i - 1);
          continue;
        }
        if (state == sF || (state == sH && (m & 2))) {
          // one deletion run of this row, to its end, in one step
          const int l = j - ring.of[x & rmask];
          const bool goes_on = (m & 10) != 0;  // F-extend bit or LEFT
          int cells;
          if (l > kBand - 1) {          // right of the band: to lane 127
            cells = goes_on ? l - (kBand - 1) : 1;
            state = goes_on && (m & 8) ? sF : sH;
          } else if (l < 0) {           // left of the band: to column 0
            cells = goes_on ? j : 1;
            state = sH;
          } else {
            const int run = f_run(ring.mask[x & rmask], l);
            cells = run > l ? j : run + 1;
            state = sH;
          }
          j -= cells < j ? cells : j;
          if (j == 0) break;
          m = byte_at(x, j);
          continue;
        }
        const uint8_t qb = ring.q[x & rmask];
        if (state == sH && (m & 3) == 0) {
          if (lane == 0) al[j - 1] = qb;
          --j;
        } else {
          // one query base inserted after column j-1 (slot j)
          if (j != slot) {
            close_slot();
            slot = j;
            cnt = 0;
          }
          if (cnt < max_ins && lane == 0) kept[cnt] = qb;
          ++cnt;
          state = (m & 4) ? sE : sH;
        }
        --i;
        if (i == 0 || j == 0) break;
        if (i - 1 < landed) land(i - 1);
        hand_back(i - 1);
        m = byte_at(i - 1, j);
      }
    }
    close_slot();
    if (lane == 0) lead_ins[p] = j == 0 ? i : 0;
    // hand back every tile, taking the rest off the ring as they land, so
    // no copy is left in flight
    hand_back(tw * T - 1);
    while (tw > 0) {
      land(landed - 1);
      hand_back(landed - 1);
    }
    hand_back(-1);
  }
}

template <int T>
int launch(const uint8_t* moves, const int* offs, const uint8_t* qs, int qmax,
           const int* qlens, const int* tlens, int tmax, int max_ins,
           int stages, int threads, uint8_t* aligned, int* ins_cnt,
           uint8_t* ins_b, int* lead_ins, int n, cudaStream_t stream) {
  const int smem = stages * T * kRowBytes;
  static bool attr = false;
  if (!attr && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxStages * T * kRowBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  walk_kernel<T><<<n, threads, smem, stream>>>(moves, offs, qs, qmax, qlens, tlens, tmax, max_ins, stages, aligned, ins_cnt, ins_b, lead_ins);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ccsx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch at a chosen ring: `rows` per stage (32 or 64), `stages` (2, 4
// or 8) and `threads` per block (96 or 128).
int ccsx_traceback_walk_variant(const uint8_t* moves, const int* offs,
                                const uint8_t* qs, int qmax,
                                const int* qlens, const int* tlens, int tmax,
                                int max_ins, uint8_t* aligned, int* ins_cnt,
                                uint8_t* ins_b, int* lead_ins, int n,
                                int rows, int stages, int threads,
                                cudaStream_t stream) {
  if (max_ins < 1 || max_ins > kMaxIns || qmax < 1 ||
      (stages != 2 && stages != 4 && stages != kMaxStages) ||
      (threads != 96 && threads != kMaxThreads))
    return (int)cudaErrorInvalidValue;
  if (rows == 32)
    return launch<32>(moves, offs, qs, qmax, qlens, tlens, tmax, max_ins,
                      stages, threads, aligned, ins_cnt, ins_b, lead_ins, n,
                      stream);
  if (rows == 64)
    return launch<64>(moves, offs, qs, qmax, qlens, tlens, tmax, max_ins,
                      stages, threads, aligned, ins_cnt, ins_b, lead_ins, n,
                      stream);
  return (int)cudaErrorInvalidValue;
}

int ccsx_traceback_walk(const uint8_t* moves, const int* offs,
                        const uint8_t* qs, int qmax, const int* qlens,
                        const int* tlens, int tmax, int max_ins,
                        uint8_t* aligned, int* ins_cnt, uint8_t* ins_b,
                        int* lead_ins, int n, cudaStream_t stream) {
  return ccsx_traceback_walk_variant(moves, offs, qs, qmax, qlens, tlens,
                                     tmax, max_ins, aligned, ins_cnt, ins_b,
                                     lead_ins, n, 64, 4, 96, stream);
}

}  // extern "C"
