// Banded affine-gap DP fills for Hopper (sm_90a): global + move bytes, and
// local + path statistics.
//
// Replaces: the global kernel replaces the JAX package's Pallas kernel
// ccsx_tpu/ops/banded_pallas.py::_kernel_g (launched by _batched_align_impl,
// with its helpers compute_offsets and compute_ismatch and the score
// epilogue).  The local kernel has no Pallas original: it replaces the
// lax.scan of ccsx_tpu/ops/banded.py::banded_align in mode='local'.  The
// plain PyTorch versions in ccsx_tpu_torch/ops/banded.py are the spec both
// kernels are held against, bit for bit.
//
// What bounds it: a fill is a chain of qlen dependent rows, each a step of
// 128 band cells.  Bytes are few (one query byte and 128 template bytes in,
// one 128-byte move row out per query row) and so are operations per row,
// so neither the memory rate nor the integer rate of the card is the limit:
// whenever the n problems of a launch fit the SMs' warp slots, the time is
// qlen times the latency of one row.  With one warp per problem that
// latency is the warp's own instruction stream: a warp issues at most one
// instruction a cycle and a 32-lane integer instruction holds a
// sub-partition's 16 integer lanes for two, so a row costs about twice its
// instruction count in cycles, plus the exposed latency of the F scan's
// dependent shuffles.
//
// What the design does about it: one warp per problem, no block barrier, no
// shared-memory carry. Lane L owns band cells 4L..4L+3 and keeps the
// previous row's H and E (and, in local mode, the eight statistic channels)
// in registers. The band shift d in 0..4 is the same for the whole warp, so
// the row body is instantiated once per d and a chain of warp-uniform
// branches (the most frequent shift first) picks it: the diagonal and up
// operands (previous-row cells k+d-1 and k+d, NEG outside the band) are the
// lane's own registers, d shuffles down of lane L+1's registers per channel
// and one shuffle up of lane L-1's last cell. The horizontal gap F is a
// two-level max scan: serial over the lane's four cells, then 5 shuffle
// steps over the 32 lane totals and one exclusive shuffle. In local mode the
// scan carries (value, cell) with the later cell winning ties (one key a
// shuffle when the statistics are packed), and the winner's Hd-side
// statistics come from a warp-private buffer under __syncwarp (measured a
// little faster at the scale corpus's shapes than shuffling them from the
// owner lane). The statistics are packed two to a register when every value
// a launch can reach fits 16 bits, and the path length is kept less the
// cell's column, which the F side then carries unchanged. Everything a row
// does not need for its own values runs inside it, off the chain: the next
// row's band offset (lane l computes the raised nominal line of one row in
// 32 with a division-free line stepper, a row takes it with a shuffle issued
// a row ahead and clips it in 32 bits), the next row's query byte and each
// lane's four template bytes (the two aligned words that hold them, read
// only where they hold a byte of the row, and a funnel shift), and the
// previous row's move bytes (packed four to a lane, one coalesced 128-byte
// row a warp) or best cell. The body has no divergent branch. Several
// problems may share a block (W warps, a launch parameter; chip_smoke.py
// measures W = 1, 2, 4); nothing is shared between them. No cap on the query
// or template length.
//
// Operations (each integer add, sub, mul, compare, logic op, min/max, select
// and shuffle of the source counted once; memory accesses, the d-dependent
// neighbour shuffles and the 64-bit refill of the offsets every 32 rows left
// out; the local fill counted with packed statistics, the body of every
// launch with qmax + tmax + 128 < 32768). A global-mode row is 9 operations
// once (clip 3, loop and dispatch 6), 70 per lane (match word 4, fetch 33 of
// which the template word 28, left neighbour 2, row limit and flags 3,
// column 0 5, in-lane scan 3, warp scan 10, exclusive shift 2, F of cell 0
// 1, addresses and offset store 4, move byte assembly 3) and 32 per band
// cell (match bit 3, E 5, diag 3, move bits 5, invalid 3, scan value 2, F 2,
// F-wins bits 4, H 1, F bit 4). A local-mode row is 9 once, 58 per lane
// (match word 4, fetch 33, row limit and flags 3, warp scan of the keys 10,
// exclusive shift 3, statistics fetch 2, buffer 3) and 57 per cell (match
// bit 2, E 5 and its statistics 3, diag 4 and its statistics 4, invalid 3,
// scan value 2, key 2, in-lane scan 4, F 5 and its statistics 4, H 2, reset
// 2, invalid 1, carried statistics 4 and the reset's 2, best 8). Per row
// that is 6,345 (global) and 9,161 (local) operations against the
// block-per-problem bodies' 29 + 128 x 85 = 10,909 and 25 + 128 x 125 =
// 16,025; chip_smoke.py bounds the kernels (and the rotating-band fill,
// which computes the global function) with the new, smaller tallies.
//
// Values outside the band: H and E read NEG there, as in the reference.
// The local fill's statistics read whatever the edge lane holds: a cell
// that takes its statistics from outside the band has an H of NEG plus a
// little, so it is reset at 0 or lies outside the band itself, and no such
// value reaches an output.
//
// Tie rules (held by the tests): E opens on e_open >= e_ext; diag wins on
// diag >= E; the F scan keeps the right operand on ties (in local mode the
// later cell wins); Hd wins over F on Hd >= F; in local mode a negative H
// resets to 0 with qb = i, tb = j, and the best cell is the largest value,
// then the earliest row, then the lowest cell.  Sums with NEG are never
// clamped, invalid cells are reset to NEG.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBand = 128;
constexpr int kMaxShift = 4;
constexpr int kPer = 4;                       // band cells per lane
constexpr int kMaxWarps = 4;                  // problems per block, at most
constexpr int kNeg = -(1 << 28);
constexpr int kIdent = -2147483647 - 1;       // identity of the max scan
constexpr uint32_t kPad4 = 0x05050505u;       // four PAD bytes
constexpr unsigned kFull = 0xffffffffu;

// chosen by chip_smoke.py's measurement of W = 1, 2, 4 at the main path's
// shapes (PERF.md)
constexpr int kWarpsGlobal = 1;
constexpr int kWarpsLocal = 1;

struct Scores {
  int M, X, O, E;
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// The nominal line lj0 + floor((i - li0) * span / denom), denom =
// max(li1 - li0, 1), at rows i = first, first + stride, ...: floor divisions
// at the start, then per step a quotient step and a remainder kept in
// [0, denom).
struct LineStep {
  long long q, r, dq, dr, denom, lj0;

  __device__ __forceinline__ LineStep(long long li0, long long lj0_,
                                      long long li1, long long lj1,
                                      long long first, long long stride) {
    denom = li1 - li0 < 1 ? 1 : li1 - li0;
    const long long span = lj1 - lj0_;
    dq = floor_div(span * stride, denom);
    dr = span * stride - dq * denom;
    const long long a = (first - li0) * span;
    q = floor_div(a, denom);
    r = a - q * denom;
    lj0 = lj0_;
  }
  __device__ __forceinline__ long long nominal() const { return lj0 + q; }
  __device__ __forceinline__ void step() {
    r += dr;
    const bool carry = r >= denom;
    r -= carry ? denom : 0;
    q += dq + (carry ? 1 : 0);
  }
};

// The band offsets, 32 rows at a time.  A row's offset is the nominal line
// less half the band, raised to a coverage floor lo (global mode), to the
// previous row's offset, then capped at min(off_prev + kMaxShift, tcap)
// (jnp.clip's min(max(x, lo), hi) order: off_prev <= tcap always, so the
// cap never falls below off_prev).  Only the clip depends on the previous
// row: lane l computes row base + l's raised nominal once per 32 rows in
// 64 bits (its own line stepper, 32 rows a step), clamped to
// [-1, tcap + kMaxShift] where the clip's result cannot change; a row takes
// it with one shuffle and clips it in 32 bits.
struct OffsetChunks {
  LineStep line;      // row base + lane
  int z;              // that row's clip input
  int qlen, tcap;
  bool coverage;      // global mode's floor tcap - (qlen - i) * kMaxShift

  __device__ __forceinline__ void refill(int base, int lane) {
    long long x = line.nominal() - kBand / 2;
    if (coverage) {
      const long long lo = tcap - (long long)(qlen - base - lane) * kMaxShift;
      x = x > lo ? x : lo;
    }
    x = x < -1 ? -1 : x;
    z = (int)(x < (long long)tcap + kMaxShift ? x : (long long)tcap + kMaxShift);
    line.step();
  }
  // row r's clip input, fetched a row before its clip
  __device__ __forceinline__ int input(int r) const {
    return __shfl_sync(kFull, z, (r - 1) & 31);
  }
  __device__ __forceinline__ int clip(int x, int off_prev) const {
    return min(max(x, off_prev), min(off_prev + kMaxShift, tcap));
  }
};

// The lane index, read once: the compiler may not re-read it in the row
// loop (a special-register read costs tens of cycles there).
__device__ __forceinline__ int lane_id() {
  int lane;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  return lane;
}

// Template bases entering columns j0 .. j0+3 (t[j-1], PAD outside 1..tmax)
// as one little-endian word, without a branch: the aligned word holding
// t[j0-1] and the next one, each read only if it holds a byte of the row
// (so neither leaves the allocation), a funnel shift, and PAD over the
// bytes outside the row.
__device__ __forceinline__ uint32_t template_word(const uint8_t* t, int tmax,
                                                  int j0) {
  const int a = j0 - 1;
  const uintptr_t addr = (uintptr_t)t + (uintptr_t)(intptr_t)a;
  const uint32_t* w = (const uint32_t*)(addr & ~(uintptr_t)3);
  const int b0 = a - (int)(addr & 3);  // row index of word w's first byte
  uint32_t lo = 0u, hi = 0u;
  if (b0 + 4 > 0 && b0 < tmax) lo = __ldg(w);
  if (b0 + 8 > 0 && b0 + 4 < tmax) hi = __ldg(w + 1);
  const uint32_t word = __funnelshift_r(lo, hi, (unsigned)(addr & 3) * 8);
  const int lead = a < 0 ? -a : 0;                    // 0 or 1 here
  const int tail = a + 4 - tmax;                      // bytes past the row
  uint32_t keep = 0xffffffffu << (8 * lead);
  keep = tail <= 0 ? keep : (tail >= 4 ? 0u : keep & (0xffffffffu >> (8 * tail)));
  return (word & keep) | (kPad4 & ~keep);
}

// Byte c of the result is 0xff where the query base matches template base
// c (bases 0..3 only: a query base >= 4 never matches, and then no template
// byte equal to it counts either).
__device__ __forceinline__ uint32_t match_bytes(uint32_t tword, int qi) {
  return qi < 4 ? __vcmpeq4(tword, (uint32_t)qi * 0x01010101u) : 0u;
}

__device__ __forceinline__ int clamp_len(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// What a row needs of the next one, fetched while it runs: the band offset
// and the input bytes (the query base, this lane's four template bases),
// and the clip input of the row after.
struct Ahead {
  int off, qc;
  uint32_t tw;
  int x;
};

// ---- the shifted carry ----
//
// nx[m] = lane L+1's register m (NEG for lane 31), fetched only for m < D:
// the up operand of cell c is cell c+D, the diagonal one cell c+D-1.
// kPadNeg false leaves lane 31 its own register instead of NEG (the local
// fill's statistics: see "Values outside the band" above).
template <int D, bool kPadNeg = true>
__device__ __forceinline__ void next_lane(const int (&r)[kPer], bool last,
                                          int (&nx)[kPer]) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    nx[m] = kNeg;
    if (m < D) {
      const int v = __shfl_down_sync(kFull, r[m], 1);
      nx[m] = kPadNeg && last ? kNeg : v;
    }
  }
}

// lane L-1's register 3 (NEG for lane 0, or lane 0's own with !kPadNeg)
template <bool kPadNeg = true>
__device__ __forceinline__ int prev_lane(const int (&r)[kPer], int lane) {
  const int v = __shfl_up_sync(kFull, r[kPer - 1], 1);
  return kPadNeg && lane == 0 ? kNeg : v;
}

// Previous-row cell 4L + m of this lane's window (m in -1..7): lane L-1's
// last cell, the lane's own registers, or lane L+1's.
__device__ __forceinline__ int window(const int (&r)[kPer],
                                      const int (&nx)[kPer], int pv, int m) {
  return m < 0 ? pv : (m < kPer ? r[m & 3] : nx[(m - kPer) & 3]);
}

// register r of a lane's four (r the same for the whole warp, or not)
__device__ __forceinline__ int pick4(const int (&x)[kPer], int r) {
  const int lo = r & 1 ? x[1] : x[0];
  const int hi = r & 1 ? x[3] : x[2];
  return r & 2 ? hi : lo;
}

// What a lane of either fill reads of its problem: the query and template
// rows, their widths, and the band offsets.
struct Problem {
  const uint8_t* q;
  const uint8_t* t;
  int qmax, tmax, tlen, tcap, lane;
  OffsetChunks offs;

  // row r's offset and input bytes, and row r+1's clip input
  __device__ __forceinline__ void fetch(Ahead& a, int r, int off_prev) {
    a.off = offs.clip(a.x, off_prev);
    a.x = offs.input(r + 1);
    a.qc = __ldg(q + min(r - 1, qmax - 1));
    a.tw = template_word(t, tmax, a.off + kPer * lane);
  }
};

// ---- global fill + move bytes ----

struct GlobalLane : Problem {
  uint32_t* mrow;     // this lane's word of move row 0
  int* orow;
  int ek[kPer];       // E * k of the lane's cells
  int H[kPer], E[kPer];
  // the previous row's move bytes less their F bits, and its F: the F bit
  // needs that row's H of the cell to the left, which this row reads anyway
  uint32_t part;
  int F[kPer];

  // the previous row's move word, given its H of each cell's left
  // neighbour
  __device__ __forceinline__ uint32_t move_word(int pv, const Scores& sc) {
    uint32_t word = part;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int H_left = c == 0 ? pv : H[c - 1];
      if (F[c] != H_left + sc.O + sc.E) word |= 8u << (8 * c);
    }
    return word;
  }

  // row i, its offset off and inputs in a; leaves row i+1's in a
  template <int D>
  __device__ __forceinline__ void row(int i, int off_prev, Ahead& a,
                                      const Scores& sc) {
    const int off = a.off;
    const uint32_t eq = match_bytes(a.tw, a.qc);
    // the next row's offset and bytes first: their chain of latencies
    // (shuffle, clip, address, loads) overlaps this row's
    fetch(a, i + 1, off);  // past the last row it reads in bounds, unused
    const bool last = lane == 31;
    int nH[kPer], nE[kPer];
    next_lane<D>(H, last, nH);
    next_lane<D>(E, last, nE);
    const int pv = prev_lane(H, lane);
    const int lim = tlen - off - kPer * lane;  // cell c valid if c <= lim

    // the move bytes' E bit and diag-or-E bit (its H choice if Hd wins)
    uint32_t pre = 0u;
    int Hd[kPer], En[kPer], v[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int sub = (eq >> (8 * c)) & 1 ? sc.M : sc.X;
      const int e_ext = window(E, nE, kNeg, c + D) + sc.E;
      const int e_open = window(H, nH, pv, c + D) + sc.O + sc.E;
      const bool eo = e_open >= e_ext;
      En[c] = eo ? e_open : e_ext;
      const int diag = window(H, nH, pv, c + D - 1) + sub;
      const bool dw = diag >= En[c];
      Hd[c] = dw ? diag : En[c];
      pre |= ((dw ? 0u : 1u) | (eo ? 0u : 4u)) << (8 * c);
      if (c == 0 && off == 0 && lane == 0) {  // column 0
        Hd[0] = sc.O + sc.E * i;
        En[0] = Hd[0];
      }
      if (c > lim) { Hd[c] = kNeg; En[c] = kNeg; }
      v[c] = Hd[c] + sc.O - ek[c];
    }

    // F: exclusive max prefix of v over the band, serial in the lane, then
    // a shuffle scan of the lane totals (a lane below s reads its own total)
    int p[kPer];
    p[0] = v[0];
#pragma unroll
    for (int c = 1; c < kPer; ++c) p[c] = max(p[c - 1], v[c]);
    int S = p[kPer - 1];
    S = max(S, __shfl_up_sync(kFull, S, 1));
    // the previous row's move word and this row's offset, while the scan's
    // shuffles are in flight
    // (at row 1 a placeholder into row 0's word, which row 2 or the end
    // overwrites: a store without a branch)
    mrow[(size_t)max(i - 2, 0) * (kBand / 4)] = move_word(pv, sc);
    if (lane == 0) orow[i - 1] = off;
#pragma unroll
    for (int s = 2; s < 32; s <<= 1) S = max(S, __shfl_up_sync(kFull, S, s));
    int X = __shfl_up_sync(kFull, S, 1);
    X = lane == 0 ? kIdent : X;

    // where F wins, the H choice bits become 2
    uint32_t fw = 0u;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      F[c] = (c == 0 ? (lane == 0 ? kNeg : X) : max(X, p[c - 1])) + ek[c];
      fw |= (Hd[c] >= F[c] ? 0u : 3u) << (8 * c);
      H[c] = max(Hd[c], F[c]);
      E[c] = En[c];
    }
    part = (pre & ~fw) | (fw & 0x02020202u);
  }
};

__global__ void __launch_bounds__(32 * kMaxWarps)
global_fill_kernel(const uint8_t* __restrict__ qs, int qmax,
                   const int* __restrict__ qlens,
                   const uint8_t* __restrict__ ts, long long t_stride, int tmax,
                   const int* __restrict__ tlens, Scores sc,
                   uint8_t* __restrict__ moves, int* __restrict__ offs,
                   int* __restrict__ score, int n) {
  const int lane = lane_id();
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= n) return;
  // lengths clamped to the padded widths: no input reads out of bounds
  const int qlen = clamp_len(qlens[p], qmax);
  const int tlen = clamp_len(tlens[p], tmax);
  const int tcap = tlen - kBand + 1 > 0 ? tlen - kBand + 1 : 0;
  GlobalLane g{{qs + (size_t)p * qmax, ts + (size_t)p * t_stride, qmax, tmax,
                tlen, tcap, lane,
                OffsetChunks{LineStep(0, 0, qlen, tlen, 1 + lane, 32), 0,
                             qlen, tcap, true}},
               (uint32_t*)(moves + (size_t)p * qmax * kBand) + lane,
               offs + (size_t)p * qmax};
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int k = kPer * lane + c;
    g.ek[c] = sc.E * k;
    // row 0 (off = 0): H = 0 at j = 0, O + E*j within tlen, NEG beyond
    g.H[c] = k <= tlen ? (k == 0 ? 0 : sc.O + sc.E * k) : kNeg;
    g.E[c] = kNeg;
  }

  g.offs.refill(1, lane);
  Ahead a{0, 0, 0u, g.offs.input(1)};
  if (qlen > 0) g.fetch(a, 1, 0);
  int off_prev = 0;
  for (int i = 1; i <= qlen; ++i) {
    const int off = a.off;
    const int d = off - off_prev;
    if ((i & 31) == 31) g.offs.refill(i + 2, lane);
    // one warp-uniform branch a row, the most frequent shifts first
    if (d == 1) g.row<1>(i, off_prev, a, sc);
    else if (d == 0) g.row<0>(i, off_prev, a, sc);
    else if (d == 2) g.row<2>(i, off_prev, a, sc);
    else if (d == 3) g.row<3>(i, off_prev, a, sc);
    else g.row<4>(i, off_prev, a, sc);
    off_prev = off;
  }
  if (qlen > 0)
    g.mrow[(size_t)(qlen - 1) * (kBand / 4)] =
        g.move_word(prev_lane(g.H, lane), sc);
  // rows beyond qlen: offsets frozen, moves zero
  for (int r = qlen + lane; r < qmax; r += 32) g.orow[r] = off_prev;
  for (int r = qlen; r < qmax; ++r) g.mrow[(size_t)r * (kBand / 4)] = 0u;
  // the score: H at column tlen, held by lane (tlen - off) / 4
  const int laneT = tlen - off_prev;
  const int val = __shfl_sync(kFull, pick4(g.H, laneT & 3), (laneT >> 2) & 31);
  if (lane == 0) score[p] = (laneT >= 0 && laneT < kBand) ? val : kNeg;
}

// ---- local fill + path statistics ----

// The statistics of the path that reaches a cell: its matches (mat), its
// length less the cell's column j (alr: a diagonal or horizontal step
// leaves it, a vertical one raises it by 1), and its query and template
// start (qb, tb).  Unpacked, one channel each.  Packed, when every value a
// launch can reach fits 16 bits (qmax + tmax + 128 < 32768), two to a
// channel, (mat << 16) | qb and (alr << 16) | tb: half the selects and
// shuffles.  No arithmetic carries from a low half into a high one: only
// the high halves are ever added to.
template <bool kPacked>
struct Stats {
  static constexpr int kCh = kPacked ? 2 : 4;
  // added to the diagonal's channel ch on a match, to the E side's per row
  __device__ static constexpr int match_inc(int ch) {
    return ch != 0 ? 0 : (kPacked ? 1 << 16 : 1);
  }
  __device__ static constexpr int gap_inc(int ch) {
    return ch != 1 ? 0 : (kPacked ? 1 << 16 : 1);
  }
  // a path that starts at (i, j): reset at 0, or row 0 (i = 0)
  __device__ static int start(int ch, int i, int j) {
    if (kPacked) return ch == 0 ? i : -65535 * j;  // (-j << 16) | j
    return ch == 0 ? 0 : (ch == 1 ? -j : (ch == 2 ? i : j));
  }
  // the F side of the band's first cell (column j): zeros, as the
  // reference's shift_right fill
  __device__ static int first(int ch, int j) {
    if (kPacked) return ch == 0 ? 0 : -j * 65536;
    return ch == 1 ? -j : 0;
  }
};

// This lane's best cell: strict improvement in cell and row order keeps the
// largest value, then the earliest row, then the lowest cell.  Its
// statistics are kept as carried and unpacked at the end.
template <int kCh>
struct LocalBest {
  int v, qe, k, te;
  int s[kCh];
};

template <bool kPacked>
struct LocalLane : Problem {
  static constexpr int kCh = Stats<kPacked>::kCh;
  static constexpr int kVFloor = -(1 << 23);  // packed scan keys: see row()

  int* buf;           // this warp's two [kCh][kBand] statistics buffers
  int ek[kPer];
  // the carried channels of the lane's four cells: H, E, and the
  // statistics of the paths that reach H and E
  int H[kPer], E[kPer], S[kCh][kPer], ES[kCh][kPer];
  LocalBest<kCh> b;

  // the carry as row i, whose band starts at off, into the best (selects,
  // not a branch: a divergent branch in the row loop costs more); row 0
  // is no candidate
  __device__ __forceinline__ void take_best(int i, int off) {
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const bool t = (H[c] > b.v) & (i > 0);
      const int k = kPer * lane + c;
      b.v = t ? H[c] : b.v;
      b.qe = t ? i : b.qe;
      b.k = t ? k : b.k;
      b.te = t ? off + k : b.te;
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) b.s[ch] = t ? S[ch][c] : b.s[ch];
    }
  }

  template <int D>
  __device__ __forceinline__ void row(int i, int off_prev, Ahead& a,
                                      const Scores& sc) {
    using St = Stats<kPacked>;
    const int off = a.off;
    const uint32_t eq = match_bytes(a.tw, a.qc);
    fetch(a, i + 1, off);  // past the last row it reads in bounds, unused
    const bool last = lane == 31;
    const int k0 = kPer * lane;
    // the previous row's cells are its result: the best cell so far
    take_best(i - 1, off_prev);
    // neighbours: H and its statistics are read as up and diagonal
    // operands, E and its statistics as up operands only
    int nH[kPer], nE[kPer], nS[kCh][kPer], nES[kCh][kPer], pS[kCh];
    next_lane<D>(H, last, nH);
    next_lane<D>(E, last, nE);
    int pH = kNeg;
    if (D == 0) pH = prev_lane(H, lane);  // the diagonal of cell 0
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      next_lane<D, false>(S[ch], last, nS[ch]);
      next_lane<D, false>(ES[ch], last, nES[ch]);
      pS[ch] = D == 0 ? prev_lane<false>(S[ch], lane) : kNeg;
    }
    const int lim = tlen - off - k0;

    int Hd[kPer], En[kPer], v[kPer], HS[kCh][kPer], nEs[kCh][kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int u = c + D, dg = c + D - 1;
      const int ism = (eq >> (8 * c)) & 1;
      // E (vertical: consume a query base, gap in the template)
      const int e_ext = window(E, nE, kNeg, u) + sc.E;
      const int e_open = window(H, nH, pH, u) + sc.O + sc.E;
      const bool eo = e_open >= e_ext;
      En[c] = eo ? e_open : e_ext;
      // Hd = best of diag / E
      const int diag = window(H, nH, pH, dg) + (ism ? sc.M : sc.X);
      const bool dw = diag >= En[c];
      Hd[c] = dw ? diag : En[c];
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) {
        nEs[ch][c] = (eo ? window(S[ch], nS[ch], kNeg, u)
                         : window(ES[ch], nES[ch], kNeg, u)) + St::gap_inc(ch);
        HS[ch][c] = dw ? window(S[ch], nS[ch], pS[ch], dg)
                             + (ism ? St::match_inc(ch) : 0)
                       : nEs[ch][c];
      }
      if (c > lim) { Hd[c] = kNeg; En[c] = kNeg; }
      v[c] = Hd[c] + sc.O - ek[c];
    }
    // this row's Hd-side statistics, for the F side's lookups
    int* sb = buf + (i & 1) * kCh * kBand;
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch)
      ((int4*)sb)[ch * 32 + lane] = make_int4(HS[ch][0], HS[ch][1], HS[ch][2],
                                              HS[ch][3]);

    // F: exclusive prefix of (value, cell), the later cell winning ties;
    // serial in the lane (carrying the statistics), then a shuffle scan of
    // the lane totals (a lane below s reads its own total: a tie it keeps).
    // Packed, value and cell go in one key, max(v, kVFloor) * 128 + cell,
    // one shuffle a step: the floor changes F only where every value to its
    // left is NEG plus a little, and there H ends below 0 either way (reset
    // at 0, or NEG outside the band)
    int pv[kPer], pi[kPer], ps[kCh][kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int key = kPacked ? max(v[c], kVFloor) * 128 + (k0 + c) : v[c];
      // the later cell wins a tie (packed keys never tie)
      const bool tk = c == 0 ? true : key >= pv[c > 0 ? c - 1 : 0];
      pv[c] = tk ? key : pv[c > 0 ? c - 1 : 0];
      pi[c] = tk ? k0 + c : pi[c > 0 ? c - 1 : 0];
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch)
        ps[ch][c] = tk ? HS[ch][c] : ps[ch][c > 0 ? c - 1 : 0];
    }
    int Sv = pv[kPer - 1], Si = pi[kPer - 1];
#pragma unroll
    for (int st = 1; st < 32; st <<= 1) {
      const int ov = __shfl_up_sync(kFull, Sv, st);
      if (kPacked) {
        Sv = max(Sv, ov);
      } else {
        const int oi = __shfl_up_sync(kFull, Si, st);
        if (!(Sv >= ov)) { Sv = ov; Si = oi; }
      }
    }
    int Xv = __shfl_up_sync(kFull, Sv, 1);
    const int Xi = kPacked ? Xv & (kBand - 1) : __shfl_up_sync(kFull, Si, 1);
    Xv = lane == 0 ? kIdent : Xv;
    // the exclusive prefix's statistics, from its owner lane's cells in the
    // buffer (measured a little faster at the scale corpus's shapes than
    // shuffling all four of the owner's registers and picking one)
    __syncwarp();
    int Xs[kCh];
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) Xs[ch] = sb[ch * kBand + Xi];

#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = off + k0 + c;
      // the F side: own-lane cells to the left, or the exclusive prefix
      const bool first = c == 0 && lane == 0;
      const int cp = c > 0 ? c - 1 : 0;  // the lane's cells left of c
      const bool own = c > 0 && pv[cp] >= Xv;
      const int cv = first ? kNeg : (own ? pv[cp] : Xv);
      const int F = (kPacked && !first ? cv >> 7 : cv) + ek[c];
      const bool hw = Hd[c] >= F;
      int Hn = hw ? Hd[c] : F;
      const bool reset = Hn < 0;
      Hn = reset ? 0 : Hn;
      H[c] = c > lim ? kNeg : Hn;
      E[c] = En[c];
#pragma unroll
      for (int ch = 0; ch < kCh; ++ch) {
        const int Fs = first ? St::first(ch, j) : (own ? ps[ch][cp] : Xs[ch]);
        const int sv = hw ? HS[ch][c] : Fs;
        S[ch][c] = reset ? St::start(ch, i, j) : sv;
        ES[ch][c] = nEs[ch][c];
      }
    }
  }
};

template <bool kPacked>
__global__ void __launch_bounds__(32 * kMaxWarps)
local_fill_kernel(const uint8_t* __restrict__ qs, int qmax,
                  const int* __restrict__ qlens,
                  const uint8_t* __restrict__ ts, int tmax,
                  const int* __restrict__ tlens,
                  const int* __restrict__ lines, Scores sc,
                  int* __restrict__ out, int n) {
  using St = Stats<kPacked>;
  constexpr int kCh = St::kCh;
  // per warp, two row buffers of [channel][kBand] Hd-side statistics: a row
  // writes one while the previous row's readers may still be at the other,
  // so one __syncwarp a row suffices
  __shared__ __align__(16) int sbuf[kMaxWarps][2 * kCh * kBand];

  const int lane = lane_id();
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + w;
  if (p >= n) return;
  const int qlen = clamp_len(qlens[p], qmax);
  const int tlen = clamp_len(tlens[p], tmax);
  const int tcap = tlen - kBand + 1 > 0 ? tlen - kBand + 1 : 0;
  LocalLane<kPacked> g{
      {qs + (size_t)p * qmax, ts + (size_t)p * tmax, qmax, tmax, tlen, tcap,
       lane,
       OffsetChunks{LineStep(lines[4 * p], lines[4 * p + 1], lines[4 * p + 2],
                             lines[4 * p + 3], 1 + lane, 32),
                    0, qlen, tcap, false}},
      sbuf[w]};
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int k = kPer * lane + c;
    g.ek[c] = sc.E * k;
    g.H[c] = k <= tlen ? 0 : kNeg;
    g.E[c] = kNeg;
#pragma unroll
    for (int ch = 0; ch < kCh; ++ch) {
      g.S[ch][c] = St::start(ch, 0, k);
      g.ES[ch][c] = g.S[ch][c];
    }
  }
  g.b.v = kNeg; g.b.qe = 0; g.b.k = 0; g.b.te = 0;
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch) g.b.s[ch] = 0;

  g.offs.refill(1, lane);
  Ahead a{0, 0, 0u, g.offs.input(1)};
  if (qlen > 0) g.fetch(a, 1, 0);
  int off_prev = 0;
  for (int i = 1; i <= qlen; ++i) {
    const int off = a.off;
    const int d = off - off_prev;
    if ((i & 31) == 31) g.offs.refill(i + 2, lane);
    if (d == 1) g.template row<1>(i, off_prev, a, sc);
    else if (d == 0) g.template row<0>(i, off_prev, a, sc);
    else if (d == 2) g.template row<2>(i, off_prev, a, sc);
    else if (d == 3) g.template row<3>(i, off_prev, a, sc);
    else g.template row<4>(i, off_prev, a, sc);
    off_prev = off;
  }
  if (qlen > 0) g.take_best(qlen, off_prev);

  // the reference's sequence of per-row first-argmax candidates with strict
  // improvement is the cell with the largest value, then the earliest row,
  // then the lowest cell: a butterfly reduction on (value, row, cell)
  const LocalBest<kCh>& b = g.b;
  int rv = b.v, rq = b.qe, rk = b.k;
#pragma unroll
  for (int st = 16; st >= 1; st >>= 1) {
    const int ov = __shfl_xor_sync(kFull, rv, st);
    const int oq = __shfl_xor_sync(kFull, rq, st);
    const int ok = __shfl_xor_sync(kFull, rk, st);
    if (ov > rv || (ov == rv && (oq < rq || (oq == rq && ok < rk)))) {
      rv = ov; rq = oq; rk = ok;
    }
  }
  // field order of BandedResult: score, qb, qe, tb, te, aln, mat
  if (rv <= kNeg) {
    if (lane == 0) {
      out[0 * n + p] = kNeg;
      for (int f = 1; f < 7; ++f) out[f * n + p] = 0;
    }
  } else if (lane == (rk >> 2)) {
    const int mat = kPacked ? b.s[0] >> 16 : b.s[0];
    const int qb = kPacked ? b.s[0] & 0xffff : b.s[kCh == 4 ? 2 : 0];
    const int alr = kPacked ? b.s[1] >> 16 : b.s[1];
    const int tb = kPacked ? b.s[1] & 0xffff : b.s[kCh == 4 ? 3 : 1];
    out[0 * n + p] = b.v; out[1 * n + p] = qb;
    out[2 * n + p] = b.qe; out[3 * n + p] = tb;
    out[4 * n + p] = b.te; out[5 * n + p] = alr + b.te;
    out[6 * n + p] = mat;
  }
}

int launch_global(const uint8_t* qs, int qmax, const int* qlens,
                  const uint8_t* ts, long long t_stride, int tmax,
                  const int* tlens, Scores sc, uint8_t* moves, int* offs,
                  int* score, int n, int warps, cudaStream_t stream) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  global_fill_kernel<<<(n + warps - 1) / warps, 32 * warps, 0, stream>>>(
      qs, qmax, qlens, ts, t_stride, tmax, tlens, sc, moves, offs, score, n);
  return (int)cudaGetLastError();
}

int launch_local(const uint8_t* qs, int qmax, const int* qlens,
                 const uint8_t* ts, int tmax, const int* tlens,
                 const int* lines, Scores sc, int* out, int n, int warps,
                 cudaStream_t stream) {
  if (warps < 1 || warps > kMaxWarps) return (int)cudaErrorInvalidValue;
  const int blocks = (n + warps - 1) / warps;
  // the statistics two to a channel when every value fits 16 bits
  const bool packed = (long long)qmax + tmax + kBand < 32768;
  if (packed)
    local_fill_kernel<true><<<blocks, 32 * warps, 0, stream>>>(
        qs, qmax, qlens, ts, tmax, tlens, lines, sc, out, n);
  else
    local_fill_kernel<false><<<blocks, 32 * warps, 0, stream>>>(
        qs, qmax, qlens, ts, tmax, tlens, lines, sc, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ccsx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ccsx_banded_global(const uint8_t* qs, int qmax, const int* qlens,
                       const uint8_t* ts, long long t_stride, int tmax,
                       const int* tlens, int M, int X, int O, int E,
                       uint8_t* moves, int* offs, int* score, int n,
                       cudaStream_t stream) {
  return launch_global(qs, qmax, qlens, ts, t_stride, tmax, tlens,
                       Scores{M, X, O, E}, moves, offs, score, n,
                       kWarpsGlobal, stream);
}

int ccsx_banded_local(const uint8_t* qs, int qmax, const int* qlens,
                      const uint8_t* ts, int tmax, const int* tlens,
                      const int* lines, int M, int X, int O, int E, int* out,
                      int n, cudaStream_t stream) {
  return launch_local(qs, qmax, qlens, ts, tmax, tlens, lines,
                      Scores{M, X, O, E}, out, n, kWarpsLocal, stream);
}

// The same kernels at a chosen number of problems per block: what
// chip_smoke.py times to choose the defaults above.
int ccsx_banded_global_warps(const uint8_t* qs, int qmax, const int* qlens,
                             const uint8_t* ts, long long t_stride, int tmax,
                             const int* tlens, int M, int X, int O, int E,
                             uint8_t* moves, int* offs, int* score, int n,
                             int warps, cudaStream_t stream) {
  return launch_global(qs, qmax, qlens, ts, t_stride, tmax, tlens,
                       Scores{M, X, O, E}, moves, offs, score, n, warps,
                       stream);
}

int ccsx_banded_local_warps(const uint8_t* qs, int qmax, const int* qlens,
                            const uint8_t* ts, int tmax, const int* tlens,
                            const int* lines, int M, int X, int O, int E,
                            int* out, int n, int warps, cudaStream_t stream) {
  return launch_local(qs, qmax, qlens, ts, tmax, tlens, lines,
                      Scores{M, X, O, E}, out, n, warps, stream);
}

}  // extern "C"
