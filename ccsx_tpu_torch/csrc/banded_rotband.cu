// Rotating-band global fill with move bytes for Hopper (sm_90a).
//
// Replaces: the JAX package's Pallas kernel
// ccsx_tpu/ops/banded_rotband.py::_kernel_rot (launched by its
// _batched_align_impl, with the helper compute_ismatch_rot, the un-rotate
// gather of the moves and the final-row take).  The plain PyTorch version
// ccsx_tpu_torch/ops/banded_rotband.py::rotband_global_moves is the spec it
// is held against, bit for bit; both give the values of the band-local
// kernel in banded_fill.cu (global_fill_kernel).
//
// The layout: residue k (0..127) holds template column j with j = k mod 128
// for the whole fill.  With OFF the row's band offset, d its advance over
// the previous row and krel = (k - OFF) & 127 residue k's band position:
//   * residue k's H and E stay where they are from row to row: the
//     vertical predecessor is its own previous value, NEG where
//     krel >= 128 - d (the residue was recycled for a new column);
//   * the diagonal predecessor is residue k-1's previous H (cyclic), NEG
//     where krel > 128 - d or (krel == 0 and d == 0);
//   * the horizontal gap F is a max-plus prefix scan in krel order, that
//     is residues OFF&127 .. 127 and then 0 .. OFF&127 - 1, exclusive by
//     one (NEG at krel 0).  Only the max of the values is carried (no
//     statistics), so the scan's tie rule cannot show;
//   * the move byte of residue k belongs to band position krel;
//   * the final score is column tlen's H, in residue tlen & 127, masked by
//     reachability (0 <= tlen - OFF < 128).
//
// What bounds it: as for global_fill_kernel, the chain of qlen dependent
// rows.  Bytes are few (one query byte and 128 template bytes in, one
// 128-byte move row out per query row), so whenever a launch's problems fit
// the SMs' warp slots the time is qlen times the latency of one row, and
// with one warp per problem that latency is the warp's own instruction
// stream (a 32-lane integer instruction holds a sub-partition's 16 integer
// lanes for two cycles) plus the exposed latency of the F scan's dependent
// shuffles.
//
// What the design does about it: one warp per problem, no block barrier,
// no shared memory.  Lane L owns residues 4L..4L+3 (its cells c = 0..3) and
// keeps their H and E in registers, and the carry never moves: the up
// operand of a cell is its own register, the diagonal one register c-1 or,
// for c = 0, lane L-1's register 3 (one shuffle, cyclic), and the band's
// advance d enters only the masks: no d-dependent shuffle of the carry and
// no per-d body (what banded_fill.cu pays to shift its carry).  The band
// starts at residue k0 = OFF & 127, in lane Ls = k0 >> 2 at cell
// cs = k0 & 3; with lr = (L - Ls) & 31 a lane's place in band order, lane
// Ls (lr 0, the split lane) holds the band's head (cells c >= cs, krel 0..)
// and, when cs > 0, its tail (cells c < cs, krel 128 - cs .. 127).  F is a
// cyclic two-level scan: a serial prefix in each lane in krel order
// (restarted at cell cs in the split lane, whose total is its head alone);
// the lane totals shuffled into band order (lane r takes lane Ls + r's) and
// scanned there with 5 shuffles up, no mask; and one shuffle from band lane
// lr - 1 for each lane's exclusive value: NEG at the head, while the split
// lane's tail takes the value of band lane 31 that this shuffle brought,
// which covers every krel before the tail.  The change of layout is paid
// on two 4-byte words a row, not on the carry: lane w fetches the template
// bytes of band positions 4w..4w+3 as one word (template_word, as the
// band-local kernel does), and its match word goes to residue order with
// two shuffles and one byte permute (bytes 4 + c - cs of words lr - 1 and
// lr); the move row goes back the other way (band word w is bytes cs + b of
// lanes Ls + w and Ls + w + 1), one coalesced 128-byte store a row.  Each
// move byte's F bit is finished in the next row, where the left
// neighbour's H it needs is the diagonal operand's shuffle; band position
// 0's F bit is a constant (its F and its left neighbour are NEG).  The band
// offsets come 32 rows at a time off the chain, and the next row's offset,
// query byte and template word are fetched inside the row, as in
// banded_fill.cu.  The row body has no divergent branch.  No cap on the
// query or template length.
//
// Operations (counted as in banded_fill.cu: each integer add, sub, mul,
// compare, logic op, min/max, select, byte permute and shuffle of the
// source once; memory accesses and the 64-bit refill of the offsets every
// 32 rows left out).  A row is 22 operations once (shift and limits 4,
// band start 3, permute selectors 6, column-0 flag 1, loop and refill test
// 4, offset clip 4), 80 per lane (match word 4, fetch 33 of which the
// template word 28, band place 2, match word to residue order 5, left
// neighbour 1, the previous row's move word to band order and its band
// position 0 fix 9, store addresses 5, split cell 2, krel of cell 0 2,
// column 0 1, scan 14 (into band order 3, 5 steps 10, exclusive 1), F bits'
// part 2) and 44 per cell (krel 2, masks 3, up and diagonal operands 3,
// match bit 2, E 4, diag 3, move bits 4, invalid 3, E x krel 1, scan value
// 2, in-lane scan 3, F 6, F-wins bits 3, H 1, F bit 4).  Per row that is
// 22 + 32 x 80 + 128 x 44 = 8,214 against the band-local kernel's 6,345,
// which computes the same function: this layout's own cost (the split
// lane's masks and restart, the krel arithmetic, the permutes), so
// chip_smoke.py bounds both global fills by the smaller tally.
//
// Tie rules (held by the tests): E opens on e_open >= e_ext; diag wins on
// diag >= E; Hd wins over F on Hd >= F.  Sums with NEG are never clamped;
// cells beyond tlen are reset to NEG.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBand = 128;
constexpr int kMask = kBand - 1;
constexpr int kMaxShift = 4;
constexpr int kPer = 4;                       // residues per lane
constexpr int kNeg = -(1 << 28);
constexpr int kIdent = -2147483647 - 1;       // identity of the max scan
constexpr uint32_t kPad4 = 0x05050505u;       // four PAD bytes
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
  int M, X, O, E;
};

// ---- copied from banded_fill.cu (LineStep, OffsetChunks, lane_id,
// template_word, match_bytes, clamp_len), so that this source builds alone
// and names its own library by its own hash ----

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

// The band offsets, 32 rows at a time: lane l computes row base + l's
// raised nominal line (the corner line less half the band, raised to the
// coverage floor tcap - (qlen - i) * kMaxShift) once per 32 rows in 64
// bits, clamped to [-1, tcap + kMaxShift] where the clip's result cannot
// change; a row takes it with one shuffle and clips it in 32 bits,
// min(max(x, off_prev), min(off_prev + kMaxShift, tcap)).
struct OffsetChunks {
  LineStep line;      // row base + lane
  int z;              // that row's clip input
  int qlen, tcap;

  __device__ __forceinline__ void refill(int base, int lane) {
    long long x = line.nominal() - kBand / 2;
    const long long lo = tcap - (long long)(qlen - base - lane) * kMaxShift;
    x = x > lo ? x : lo;
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

// ---- end of the copy ----

// register r of a lane's four (r the same for the whole warp, or not)
__device__ __forceinline__ int pick4(const int (&x)[kPer], int r) {
  const int lo = r & 1 ? x[1] : x[0];
  const int hi = r & 1 ? x[3] : x[2];
  return r & 2 ? hi : lo;
}

// What a row needs of the next one, fetched while it runs: the band offset
// and the input bytes (the query base, this lane's four template bases in
// band order), and the clip input of the row after.
struct Ahead {
  int off, qc;
  uint32_t tw;
  int x;
};

struct RotLane {
  const uint8_t* q;
  const uint8_t* t;
  int qmax, tmax, tlen, lane;
  OffsetChunks offs;
  uint32_t* mrow;     // this lane's word of move row 0
  int* orow;
  uint32_t f0;        // the F bit of band position 0 (NEG against NEG)
  int H[kPer], E[kPer];
  // the previous row's move bytes less their F bits, and its F, in residue
  // order: the F bit needs that row's H of the residue to the left, which
  // this row reads anyway
  uint32_t part;
  int F[kPer];

  // row r's offset and input bytes, and row r+1's clip input
  __device__ __forceinline__ void fetch(Ahead& a, int r, int off_prev) {
    a.off = offs.clip(a.x, off_prev);
    a.x = offs.input(r + 1);
    a.qc = __ldg(q + min(r - 1, qmax - 1));
    a.tw = template_word(t, tmax, a.off + kPer * lane);
  }

  // The previous row's move word, band word `lane` of it, given its H of
  // residue 4L - 1 (lane L-1's register 3) and its offset off_p: the F
  // bits in residue order, then bytes cs + b of lanes Ls + lane (lo) and
  // Ls + lane + 1 (hi).  Band position 0 (krel 0) takes the constant F bit.
  __device__ __forceinline__ uint32_t move_word(int pv, int off_p,
                                                const Scores& sc) {
    uint32_t w = part;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int H_left = c == 0 ? pv : H[c - 1];
      if (F[c] != H_left + sc.O + sc.E) w |= 8u << (8 * c);
    }
    const int k0 = off_p & kMask;
    const int src = (k0 >> 2) + lane;
    const uint32_t lo = __shfl_sync(kFull, w, src & 31);
    const uint32_t hi = __shfl_sync(kFull, w, (src + 1) & 31);
    const uint32_t band = __byte_perm(lo, hi, 0x3210u + (uint32_t)(k0 & 3) * 0x1111u);
    return lane == 0 ? (band & ~8u) | f0 : band;
  }

  // row i, its offset and inputs in a; leaves row i+1's in a
  __device__ __forceinline__ void row(int i, int off_prev, Ahead& a,
                                      const Scores& sc) {
    const int off = a.off;
    const int d = off - off_prev;
    const uint32_t eq_band = match_bytes(a.tw, a.qc);
    // the next row's offset and bytes first: their chain of latencies
    // (shuffle, clip, address, loads) overlaps this row's
    fetch(a, i + 1, off);  // past the last row it reads in bounds, unused
    const int k0 = off & kMask;
    const int cs = k0 & 3;
    const int lr = (lane - (k0 >> 2)) & 31;   // the lane's place in band order
    // the match word in residue order: bytes 4 + c - cs of (word lr - 1,
    // word lr)
    const uint32_t elo = __shfl_sync(kFull, eq_band, (lr - 1) & 31);
    const uint32_t ehi = __shfl_sync(kFull, eq_band, lr);
    const uint32_t eq = __byte_perm(elo, ehi, 0x7654u - (uint32_t)cs * 0x1111u);
    // residue 4L - 1's previous H: the diagonal operand of cell 0, and the
    // left neighbour of the previous row's move word
    const int pv = __shfl_sync(kFull, H[kPer - 1], (lane - 1) & 31);
    // (at row 1 a placeholder into row 0's word, which row 2 or the end
    // overwrites: a store without a branch)
    mrow[(size_t)max(i - 2, 0) * (kBand / 4)] = move_word(pv, off_prev, sc);
    if (lane == 0) orow[i - 1] = off;

    const int rc = lr == 0 ? cs : kPer;        // the cell at krel 0, if here
    const int kr0 = (kPer * lane - k0) & kMask;
    const int up_lim = kMask - d;              // up operand valid: krel <= it
    const int dm1 = d - 1;                     // diag valid: krel + d - 1 in 0..127
    const int lim = tlen - off;                // cell valid: krel <= lim
    const bool col0 = off == 0 && lane == 0;

    // the move bytes' E bit and diag-or-E bit (its H choice if Hd wins)
    uint32_t pre = 0u;
    int Hd[kPer], En[kPer], v[kPer], kr[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      kr[c] = (kr0 + c) & kMask;
      const bool up_ok = kr[c] <= up_lim;
      const bool dg_ok = (unsigned)(kr[c] + dm1) <= (unsigned)kMask;
      const int H_up = up_ok ? H[c] : kNeg;
      const int E_up = up_ok ? E[c] : kNeg;
      const int H_dg = dg_ok ? (c == 0 ? pv : H[c - 1]) : kNeg;
      const int sub = (eq >> (8 * c)) & 1 ? sc.M : sc.X;
      const int e_ext = E_up + sc.E;
      const int e_open = H_up + sc.O + sc.E;
      const bool eo = e_open >= e_ext;
      En[c] = eo ? e_open : e_ext;
      const int diag = H_dg + sub;
      const bool dw = diag >= En[c];
      Hd[c] = dw ? diag : En[c];
      pre |= ((dw ? 0u : 1u) | (eo ? 0u : 4u)) << (8 * c);
      if (c == 0 && col0) {                    // column 0: residue 0
        Hd[0] = sc.O + sc.E * i;
        En[0] = Hd[0];
      }
      if (kr[c] > lim) { Hd[c] = kNeg; En[c] = kNeg; }
      v[c] = Hd[c] + sc.O - sc.E * kr[c];
    }

    // F: the in-lane prefix in krel order (the split lane restarts at its
    // head), then the lane totals scanned in band order
    int p[kPer];
    p[0] = v[0];
#pragma unroll
    for (int c = 1; c < kPer; ++c) p[c] = max(c == rc ? kIdent : p[c - 1], v[c]);
    // the totals into band order (lane r takes lane Ls + r's), a scan in
    // lane order (a lane below s reads its own total), and each lane's
    // exclusive value from band lane lr - 1: for the split lane, band lane
    // 31's, all of the band before its tail
    int S = __shfl_sync(kFull, p[kPer - 1], (lane + (k0 >> 2)) & 31);
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) S = max(S, __shfl_up_sync(kFull, S, s));
    const int X = __shfl_sync(kFull, S, (lr - 1) & 31);

    // where F wins, the H choice bits become 2
    uint32_t fw = 0u;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int cross = c >= rc ? kIdent : X;
      const int inl = (c == 0 || c == rc) ? kIdent : p[c - 1];
      F[c] = c == rc ? kNeg : max(cross, inl) + sc.E * kr[c];
      fw |= (Hd[c] >= F[c] ? 0u : 3u) << (8 * c);
      H[c] = max(Hd[c], F[c]);
      E[c] = En[c];
    }
    part = (pre & ~fw) | (fw & 0x02020202u);
  }
};

__global__ void __launch_bounds__(32)
rotband_fill_kernel(const uint8_t* __restrict__ qs, int qmax,
                    const int* __restrict__ qlens,
                    const uint8_t* __restrict__ ts, long long t_stride,
                    int tmax, const int* __restrict__ tlens, Scores sc,
                    uint8_t* __restrict__ moves, int* __restrict__ offs,
                    int* __restrict__ score) {
  const int lane = lane_id();
  const int p = blockIdx.x;
  // lengths clamped to the padded widths: no input reads out of bounds
  const int qlen = clamp_len(qlens[p], qmax);
  const int tlen = clamp_len(tlens[p], tmax);
  const int tcap = tlen - kBand + 1 > 0 ? tlen - kBand + 1 : 0;
  RotLane g{qs + (size_t)p * qmax, ts + (size_t)p * t_stride, qmax, tmax,
            tlen, lane,
            OffsetChunks{LineStep(0, 0, qlen, tlen, 1 + lane, 32), 0, qlen,
                         tcap},
            (uint32_t*)(moves + (size_t)p * qmax * kBand) + lane,
            offs + (size_t)p * qmax,
            sc.O + sc.E == 0 ? 0u : 8u};
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int k = kPer * lane + c;
    // row 0 (OFF = 0, so residue k holds column k): H = 0 at j = 0, O + E*j
    // within tlen, NEG beyond; E = NEG
    g.H[c] = k <= tlen ? (k == 0 ? 0 : sc.O + sc.E * k) : kNeg;
    g.E[c] = kNeg;
    g.F[c] = 0;
  }
  g.part = 0u;

  g.offs.refill(1, lane);
  Ahead a{0, 0, 0u, g.offs.input(1)};
  if (qlen > 0) g.fetch(a, 1, 0);
  int off_prev = 0;
  for (int i = 1; i <= qlen; ++i) {
    const int off = a.off;
    if ((i & 31) == 31) g.offs.refill(i + 2, lane);
    g.row(i, off_prev, a, sc);
    off_prev = off;
  }
  if (qlen > 0)
    g.mrow[(size_t)(qlen - 1) * (kBand / 4)] = g.move_word(
        __shfl_sync(kFull, g.H[kPer - 1], (lane - 1) & 31), off_prev, sc);
  // rows beyond qlen: offsets frozen, moves zero
  for (int r = qlen + lane; r < qmax; r += 32) g.orow[r] = off_prev;
  for (int r = qlen; r < qmax; ++r) g.mrow[(size_t)r * (kBand / 4)] = 0u;
  // the score: H at column tlen, in residue tlen & 127
  const int res = tlen & kMask;
  const int val = __shfl_sync(kFull, pick4(g.H, res & 3), res >> 2);
  const int laneT = tlen - off_prev;
  if (lane == 0) score[p] = (laneT >= 0 && laneT < kBand) ? val : kNeg;
}

}  // namespace

extern "C" {

const char* ccsx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One warp per problem, one problem per block.
int ccsx_banded_rotband(const uint8_t* qs, int qmax, const int* qlens,
                        const uint8_t* ts, long long t_stride, int tmax,
                        const int* tlens, int M, int X, int O, int E,
                        uint8_t* moves, int* offs, int* score, int n,
                        cudaStream_t stream) {
  Scores sc{M, X, O, E};
  rotband_fill_kernel<<<n, 32, 0, stream>>>(qs, qmax, qlens, ts, t_stride,
                                            tmax, tlens, sc, moves, offs,
                                            score);
  return (int)cudaGetLastError();
}

}  // extern "C"
