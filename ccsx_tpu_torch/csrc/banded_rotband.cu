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
// The layout: lane k owns template column residue k (column j with
// j = k mod 128) for the whole fill.  With OFF the row's band offset, d its
// advance over the previous row and krel = (k - OFF) & 127 lane k's band
// position:
//   * the lane's H and E stay in its registers from row to row: the
//     vertical predecessor is its own previous value, NEG where
//     krel >= 128 - d (the lane was recycled for a new column);
//   * the diagonal predecessor is lane k-1's previous H (cyclic): a warp
//     shuffle, and for the first lane of a warp the last lane of the warp
//     before, through shared memory; NEG where krel > 128 - d or
//     (krel == 0 and d == 0);
//   * the horizontal gap F is a max-plus prefix scan in krel order, that
//     is lanes OFF&127 .. 127 and then 0 .. OFF&127 - 1.  It runs as two
//     masked lane-order scans (lanes at or past OFF&127, lanes before it)
//     of warp shuffles plus warp totals; a lane before OFF&127 adds the
//     whole first part.  Exclusive by one in krel order: lane k-1's
//     inclusive value, NEG at krel 0.  Only the max of the values is
//     carried (no statistics), so the scan's tie rule cannot show;
//   * each lane writes its move byte straight to band position krel, which
//     un-rotates the moves into the band-local layout in the store itself;
//   * the final score is column tlen's H, in lane tlen & 127, masked by
//     reachability (0 <= tlen - OFF < 128).
//
// What bounds it: as for global_fill_kernel, the chain of qlen dependent
// rows.  Counting each integer add, sub, mul, div, rem, compare, logic op,
// min/max, select and shuffle of the source below as one operation (memory
// accesses not counted), a row is 31 operations for the band offset, OFF's
// lane and the loop (done once per row) plus 122 per band lane: krel and j
// 3, template base 5, match 6, diagonal neighbour 3, predecessor masks and
// selects 10, E 5, diag 3, column-0 and beyond-tlen resets 8, F scan value
// 3, masked scan inputs 3, warp scans 5 x 5 = 25, warp totals 1, prefix of
// the warp totals 16, inclusive value 4, exclusive shift 4, F 3, H 2, left
// neighbour 5, move byte 10, store addresses 3.  That is 1.43x the 29 + 85
// of global_fill_kernel, which computes the same function: the excess is
// this layout's own overhead (the second scan, the krel arithmetic), so
// chip_smoke.py bounds this kernel by the smaller count.  Bytes are small
// (one 128-byte move row out per query row), so the limit is the
// row-to-row latency inside one block: two block barriers, shuffles and
// shared-memory round trips per row.
//
// What the design does about it: one block of 128 threads per problem, no
// carry in shared memory at all (the band-local kernel keeps a padded
// double-buffered carry there so the shift d becomes an index; here the
// carry never moves), the band offsets and match bits computed in-kernel,
// no cap on the query length.  A simple first version: several problems
// per block and fewer barriers per row are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBand = 128;
constexpr int kMask = kBand - 1;
constexpr int kMaxShift = 4;
constexpr int kWarps = kBand / 32;
constexpr int kNeg = -(1 << 28);
constexpr int kPad = 5;
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
  int M, X, O, E;
};

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Band offset of row i in global mode (the nominal line is the corner
// line (0, 0, qlen, tlen)): the line, a coverage floor, monotone, at most
// kMaxShift per row, capped at tcap; jnp.clip's min(max(x, lo), hi) order
// even when lo > hi, then max with off_prev.  As in banded_fill.cu.
__device__ __forceinline__ long long band_offset(long long i,
                                                 long long off_prev,
                                                 long long qlen,
                                                 long long tlen,
                                                 long long tcap) {
  long long denom = qlen < 1 ? 1 : qlen;
  long long desired = floor_div(i * tlen, denom) - kBand / 2;
  long long lo = tcap - (qlen - i) * kMaxShift;
  if (lo < 0) lo = 0;
  long long hi = off_prev + kMaxShift < tcap ? off_prev + kMaxShift : tcap;
  long long off = desired > lo ? desired : lo;
  off = off > off_prev ? off : off_prev;
  off = off < hi ? off : hi;
  return off > off_prev ? off : off_prev;
}

__device__ __forceinline__ int clamp_len(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kBand)
rotband_fill_kernel(const uint8_t* __restrict__ qs, int qmax,
                    const int* __restrict__ qlens,
                    const uint8_t* __restrict__ ts, long long t_stride,
                    int tmax, const int* __restrict__ tlens, Scores sc,
                    uint8_t* __restrict__ moves, int* __restrict__ offs,
                    int* __restrict__ score) {
  // the last lane's H of each warp, read by the first lane of the next
  // warp (cyclic), and the warp totals of the two masked scans
  __shared__ int edge[kWarps];
  __shared__ int totP[kWarps];
  __shared__ int totQ[kWarps];

  const int p = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int w = k >> 5;
  const int prev_w = (w + kWarps - 1) & (kWarps - 1);
  const uint8_t* q = qs + (size_t)p * qmax;
  const uint8_t* t = ts + (size_t)p * t_stride;
  // lengths clamped to the padded widths: no input reads out of bounds
  const int qlen = clamp_len(qlens[p], qmax);
  const int tlen = clamp_len(tlens[p], tmax);
  const long long tcap = tlen - kBand + 1 > 0 ? tlen - kBand + 1 : 0;
  uint8_t* mrow = moves + (size_t)p * qmax * kBand;
  int* orow = offs + (size_t)p * qmax;

  // row 0 (OFF = 0, so lane k holds column k): H = 0 at j = 0, O + E*j
  // within tlen, NEG beyond; E = NEG
  int H = k <= tlen ? (k == 0 ? 0 : sc.O + sc.E * k) : kNeg;
  int Ev = kNeg;
  if (lane == 31) edge[w] = H;
  __syncthreads();

  long long off_prev = 0;
  for (int i = 1; i <= qlen; ++i) {
    const long long off = band_offset(i, off_prev, qlen, tlen, tcap);
    const int d = (int)(off - off_prev);
    const int k0 = (int)(off & kMask);  // the lane at band position 0
    const int krel = (k - k0) & kMask;
    const int j = (int)off + krel;
    const int qi = q[i - 1];
    const int tb = (j >= 1 && j <= tmax) ? (int)t[j - 1] : kPad;
    const int sub = (qi == tb && qi < 4 && tb < 4) ? sc.M : sc.X;

    // predecessors: the lane's own carry (up), lane k-1's (diag)
    int H_nb = __shfl_up_sync(kFull, H, 1);
    if (lane == 0) H_nb = edge[prev_w];
    const bool up_bad = krel >= kBand - d;
    const bool diag_bad = krel > kBand - d || (krel == 0 && d == 0);
    const int H_up = up_bad ? kNeg : H;
    const int E_up = up_bad ? kNeg : Ev;
    const int H_diag = diag_bad ? kNeg : H_nb;

    const int e_ext = E_up + sc.E;
    const int e_open = H_up + sc.O + sc.E;
    const bool e_is_open = e_open >= e_ext;
    int Enew = e_is_open ? e_open : e_ext;
    const int diag_term = H_diag + sub;
    const bool d_wins = diag_term >= Enew;
    int Hd = d_wins ? diag_term : Enew;
    if (j == 0) { Hd = sc.O + sc.E * i; Enew = Hd; }
    if (j > tlen) { Hd = kNeg; Enew = kNeg; }

    // F: inclusive max scan in krel order as two masked lane-order scans,
    // P over lanes k0..127 and Q over lanes 0..k0-1
    const int v = Hd + sc.O - sc.E * krel;
    int cp = k >= k0 ? v : kNeg;
    int cq = k >= k0 ? kNeg : v;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int op = __shfl_up_sync(kFull, cp, s);
      const int oq = __shfl_up_sync(kFull, cq, s);
      if (lane >= s) { cp = imax(cp, op); cq = imax(cq, oq); }
    }
    if (lane == 31) { totP[w] = cp; totQ[w] = cq; }
    __syncthreads();
    int preP = kNeg, preQ = kNeg, allP = kNeg;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      if (ww < w) { preP = imax(preP, totP[ww]); preQ = imax(preQ, totQ[ww]); }
      allP = imax(allP, totP[ww]);
    }
    const int incl = k >= k0 ? imax(preP, cp) : imax(allP, imax(preQ, cq));
    // exclusive: the inclusive value of lane k-1 (cyclic); the first lane
    // of a warp builds it from the totals of the warps up to lane k-1
    int prev = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) {
      const int km1 = (k + kMask) & kMask;
      int pP = kNeg, pQ = kNeg;
      for (int ww = 0; ww <= (km1 >> 5); ++ww) {
        pP = imax(pP, totP[ww]);
        pQ = imax(pQ, totQ[ww]);
      }
      prev = km1 >= k0 ? pP : imax(allP, pQ);
    }
    const int F = (krel == 0 ? kNeg : prev) + sc.E * krel;
    const bool hd_wins = Hd >= F;
    const int Hnew = hd_wins ? Hd : F;

    // the left neighbour's new H, for the move byte and the next row
    int Hn_nb = __shfl_up_sync(kFull, Hnew, 1);
    if (lane == 31) edge[w] = Hnew;
    __syncthreads();
    if (lane == 0) Hn_nb = edge[prev_w];
    const int H_left = krel == 0 ? kNeg : Hn_nb;
    const int choice = (hd_wins && d_wins) ? 0 : (hd_wins ? 1 : 2);
    const int ebit = e_is_open ? 0 : 4;
    const int fbit = (F == H_left + sc.O + sc.E) ? 0 : 8;
    mrow[(size_t)(i - 1) * kBand + krel] = (uint8_t)(choice | ebit | fbit);
    if (k == 0) orow[i - 1] = (int)off;
    H = Hnew;
    Ev = Enew;
    off_prev = off;
  }
  // rows beyond qlen: offsets frozen, moves zero
  for (int r = qlen + k; r < qmax; r += kBand) orow[r] = (int)off_prev;
  for (int r = qlen; r < qmax; ++r) mrow[(size_t)r * kBand + k] = 0;
  if (k == (tlen & kMask)) {
    const long long laneT = tlen - off_prev;
    score[p] = (laneT >= 0 && laneT < kBand) ? H : kNeg;
  }
}

}  // namespace

extern "C" {

const char* ccsx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ccsx_banded_rotband(const uint8_t* qs, int qmax, const int* qlens,
                        const uint8_t* ts, long long t_stride, int tmax,
                        const int* tlens, int M, int X, int O, int E,
                        uint8_t* moves, int* offs, int* score, int n,
                        cudaStream_t stream) {
  Scores sc{M, X, O, E};
  rotband_fill_kernel<<<n, kBand, 0, stream>>>(qs, qmax, qlens, ts, t_stride,
                                                tmax, tlens, sc, moves, offs,
                                                score);
  return (int)cudaGetLastError();
}

}  // extern "C"
