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
// What bounds it: the fill is a chain of qlen dependent rows.  Counting
// each integer add, sub, mul, div, rem, compare, logic op, min/max, select
// and shuffle of the source below as one operation (memory accesses not
// counted), a global-mode row is 29 operations for the band offset and
// loop (done once per row) plus 85 per band lane: j 1, template base 5,
// match 6, E 7, diag 4, column-0 and beyond-tlen resets 8, F scan value 3,
// warp scan 5 x 4 = 20, warp totals 7, exclusive shift 5, F and H 4, move
// byte 11, stores 4.  A local-mode row is 25 plus 125 per lane: indices 3,
// template base and match 12, E and its four channels 10, diag and its
// channels 10, reset 3, scan values 4, warp scan of (value, lane) 5 x 8 =
// 40, warp totals 10, exclusive shift 6, F and its channels 4, H select 6,
// clamp at 0 6, invalid 1, per-lane best 9, buffer swap 1.  chip_smoke.py
// uses these counts for the kernels' bounds.
// Bytes are small (one 128-byte move row out per query row, one query byte
// and 128 template bytes in), so neither the memory rate nor the integer
// rate of the card is the limit: the row-to-row latency inside one block
// is (two block barriers, shuffles and shared-memory round trips per row).
// A round of 32 passes fills only 32 of the 132 SMs.
//
// What the design does about it: one block of 128 threads per problem,
// thread k owning band lane k, so a row is one step of every thread with
// no cross-block traffic.  The carry (previous row's H/E and, in local
// mode, the statistic channels) lives in double-buffered shared memory,
// padded as the reference pads it ([NEG, row, NEG*maxshift]) so the band
// shift d in [0, 4] is a plain index (diag at k+d, up at k+d+1) instead of
// the TPU's select chain.  The band offsets are data-independent and every
// thread computes them in registers (exact int64 line interpolation), the
// match bit is formed in-kernel from q[i-1] and t[off+k-1], the horizontal
// gap F is a Hillis-Steele max scan (warp shuffles, then warp totals
// through shared memory), and each query row stores one coalesced 128-byte
// move row.  There is no cap on the query length: the TPU's VMEM and
// 8-row tiling limits do not exist here.
//
// Tie rules (held by the tests): E opens on e_open >= e_ext; diag wins on
// diag >= E; the F scan keeps the right operand on ties; Hd wins over F on
// Hd >= F.  Sums with NEG are never clamped, invalid lanes are reset to NEG.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBand = 128;
constexpr int kMaxShift = 4;
constexpr int kWarps = kBand / 32;
constexpr int kPadW = 1 + kBand + kMaxShift;  // [NEG, row, NEG * maxshift]
constexpr int kNeg = -(1 << 28);
constexpr int kPad = 5;
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
  int M, X, O, E;
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  long long q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Band offset of row i: the nominal line, a coverage floor in global mode,
// monotone, at most kMaxShift per row, capped at tcap; jnp.clip order
// min(max(x, lo), hi) even when lo > hi, then max with off_prev.
__device__ __forceinline__ long long band_offset(
    long long i, long long off_prev, long long qlen, long long tcap,
    long long li0, long long lj0, long long li1, long long lj1, bool local) {
  long long denom = li1 - li0;
  if (denom < 1) denom = 1;
  long long nom = lj0 + floor_div((i - li0) * (lj1 - lj0), denom);
  long long desired = nom - kBand / 2;
  long long lo = 0;
  if (!local) {
    lo = tcap - (qlen - i) * kMaxShift;
    if (lo < 0) lo = 0;
  }
  long long hi = off_prev + kMaxShift < tcap ? off_prev + kMaxShift : tcap;
  long long off = desired > lo ? desired : lo;
  off = off > off_prev ? off : off_prev;
  off = off < hi ? off : hi;
  return off > off_prev ? off : off_prev;
}

__device__ __forceinline__ int template_base(const uint8_t* t, int tmax, int j) {
  return (j >= 1 && j <= tmax) ? (int)t[j - 1] : kPad;
}

__device__ __forceinline__ int clamp_len(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kBand)
global_fill_kernel(const uint8_t* __restrict__ qs, int qmax,
                   const int* __restrict__ qlens,
                   const uint8_t* __restrict__ ts, long long t_stride, int tmax,
                   const int* __restrict__ tlens, Scores sc,
                   uint8_t* __restrict__ moves, int* __restrict__ offs,
                   int* __restrict__ score) {
  __shared__ int Hb[2][kPadW];
  __shared__ int Eb[2][kPadW];
  __shared__ int wtot[kWarps];

  const int p = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int w = k >> 5;
  const uint8_t* q = qs + (size_t)p * qmax;
  const uint8_t* t = ts + (size_t)p * t_stride;
  // lengths clamped to the padded widths: no input reads out of bounds
  const int qlen = clamp_len(qlens[p], qmax);
  const int tlen = clamp_len(tlens[p], tmax);
  const long long tcap = tlen - kBand + 1 > 0 ? tlen - kBand + 1 : 0;
  uint8_t* mrow = moves + (size_t)p * qmax * kBand;
  int* orow = offs + (size_t)p * qmax;

  for (int x = k; x < kPadW; x += kBand) {
    Hb[0][x] = kNeg; Hb[1][x] = kNeg; Eb[0][x] = kNeg; Eb[1][x] = kNeg;
  }
  __syncthreads();
  // row 0 (off = 0): H = 0 at j = 0, O + E*j within tlen, NEG beyond; E = NEG
  Hb[0][1 + k] = k <= tlen ? (k == 0 ? 0 : sc.O + sc.E * k) : kNeg;
  __syncthreads();

  long long off_prev = 0;
  int cur = 0;
  for (int i = 1; i <= qlen; ++i) {
    const long long off = band_offset(i, off_prev, qlen, tcap, 0, 0, qlen,
                                      tlen, false);
    const int d = (int)(off - off_prev);
    const int j = (int)off + k;
    const int qi = q[i - 1];
    const int tb = template_base(t, tmax, j);
    const int sub = (qi == tb && qi < 4 && tb < 4) ? sc.M : sc.X;

    const int* Hp = Hb[cur];
    const int* Ep = Eb[cur];
    const int e_ext = Ep[d + k + 1] + sc.E;
    const int e_open = Hp[d + k + 1] + sc.O + sc.E;
    const bool e_is_open = e_open >= e_ext;
    int Enew = e_is_open ? e_open : e_ext;
    const int diag_term = Hp[d + k] + sub;
    const bool d_wins = diag_term >= Enew;
    int Hd = d_wins ? diag_term : Enew;
    if (j == 0) { Hd = sc.O + sc.E * i; Enew = Hd; }
    if (j > tlen) { Hd = kNeg; Enew = kNeg; }

    // F: inclusive max scan of v = Hd + O - E*k over the lanes
    int cw = Hd + sc.O - sc.E * k;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int o = __shfl_up_sync(kFull, cw, s);
      if (lane >= s) cw = o > cw ? o : cw;
    }
    if (lane == 31) wtot[w] = cw;
    __syncthreads();
    int pre = wtot[0];
    for (int ww = 1; ww < w; ++ww) pre = wtot[ww] > pre ? wtot[ww] : pre;
    const int cin = (w == 0 || cw > pre) ? cw : pre;
    int cex = __shfl_up_sync(kFull, cin, 1);
    if (lane == 0) cex = (w == 0) ? kNeg : pre;
    const int F = cex + sc.E * k;
    const bool hd_wins = Hd >= F;
    const int Hnew = hd_wins ? Hd : F;

    const int nxt = cur ^ 1;
    Hb[nxt][1 + k] = Hnew;
    Eb[nxt][1 + k] = Enew;
    __syncthreads();
    const int H_left = Hb[nxt][k];  // lane 0 reads the NEG pad
    const int choice = (hd_wins && d_wins) ? 0 : (hd_wins ? 1 : 2);
    const int ebit = e_is_open ? 0 : 4;
    const int fbit = (F == H_left + sc.O + sc.E) ? 0 : 8;
    mrow[(size_t)(i - 1) * kBand + k] = (uint8_t)(choice | ebit | fbit);
    if (k == 0) orow[i - 1] = (int)off;
    off_prev = off;
    cur = nxt;
  }
  // rows beyond qlen: offsets frozen, moves zero
  for (int r = qlen + k; r < qmax; r += kBand) orow[r] = (int)off_prev;
  for (int r = qlen; r < qmax; ++r) mrow[(size_t)r * kBand + k] = 0;
  if (k == 0) {
    const long long laneT = tlen - off_prev;
    score[p] = (laneT >= 0 && laneT < kBand) ? Hb[cur][1 + laneT] : kNeg;
  }
}

// Local mode: the channels carried through the recurrence, in one array so
// the double buffers and the [NEG, row, NEG*maxshift] padding are shared.
enum { cH, cE, cMat, cAln, cEmat, cEaln, cQb, cTb, cEqb, cEtb, kCh };

__global__ void __launch_bounds__(kBand)
local_fill_kernel(const uint8_t* __restrict__ qs, int qmax,
                  const int* __restrict__ qlens,
                  const uint8_t* __restrict__ ts, int tmax,
                  const int* __restrict__ tlens,
                  const int* __restrict__ lines, Scores sc,
                  int* __restrict__ out, int n) {
  __shared__ int cb[2][kCh][kPadW];
  __shared__ int wv[kWarps];
  __shared__ int wi[kWarps];
  // this row's Hd-side stats, read by the lane the F scan points at
  __shared__ int sMat[kBand], sAlnK[kBand], sQb[kBand], sTb[kBand];
  // per-lane best records for the final reduction
  __shared__ int bv[kBand], bqe[kBand];

  const int p = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31;
  const int w = k >> 5;
  const uint8_t* q = qs + (size_t)p * qmax;
  const uint8_t* t = ts + (size_t)p * tmax;
  const int qlen = clamp_len(qlens[p], qmax);
  const int tlen = clamp_len(tlens[p], tmax);
  const long long tcap = tlen - kBand + 1 > 0 ? tlen - kBand + 1 : 0;
  const long long li0 = lines[4 * p], lj0 = lines[4 * p + 1];
  const long long li1 = lines[4 * p + 2], lj1 = lines[4 * p + 3];

  for (int x = k; x < kPadW; x += kBand)
    for (int c = 0; c < kCh; ++c) { cb[0][c][x] = kNeg; cb[1][c][x] = kNeg; }
  __syncthreads();
  cb[0][cH][1 + k] = k <= tlen ? 0 : kNeg;
  cb[0][cMat][1 + k] = 0; cb[0][cAln][1 + k] = 0;
  cb[0][cEmat][1 + k] = 0; cb[0][cEaln][1 + k] = 0;
  cb[0][cQb][1 + k] = 0; cb[0][cTb][1 + k] = k;
  cb[0][cEqb][1 + k] = 0; cb[0][cEtb][1 + k] = k;
  __syncthreads();

  // this lane's best cell: strict improvement keeps the earliest row
  int best_v = kNeg, best_qe = 0, best_mat = 0, best_aln = 0, best_qb = 0;
  int best_tb = 0, best_te = 0;
  long long off_prev = 0;
  int cur = 0;
  for (int i = 1; i <= qlen; ++i) {
    const long long off = band_offset(i, off_prev, qlen, tcap, li0, lj0, li1,
                                      lj1, true);
    const int d = (int)(off - off_prev);
    const int j = (int)off + k;
    const int qi = q[i - 1];
    const int tb = template_base(t, tmax, j);
    const int ism = (qi == tb && qi < 4 && tb < 4) ? 1 : 0;
    const int sub = ism ? sc.M : sc.X;
    int (*P)[kPadW] = cb[cur];
    const int dg = d + k, up = d + k + 1;

    // E (vertical: consume a query base, gap in the template)
    const int e_ext = P[cE][up] + sc.E;
    const int e_open = P[cH][up] + sc.O + sc.E;
    const bool e_is_open = e_open >= e_ext;
    int Enew = e_is_open ? e_open : e_ext;
    const int nEmat = e_is_open ? P[cMat][up] : P[cEmat][up];
    const int nEaln = (e_is_open ? P[cAln][up] : P[cEaln][up]) + 1;
    const int nEqb = e_is_open ? P[cQb][up] : P[cEqb][up];
    const int nEtb = e_is_open ? P[cTb][up] : P[cEtb][up];

    // Hd = best of diag / E
    const int diag_term = P[cH][dg] + sub;
    const bool d_wins = diag_term >= Enew;
    int Hd = d_wins ? diag_term : Enew;
    const int Hmat = d_wins ? P[cMat][dg] + ism : nEmat;
    const int Haln = (d_wins ? P[cAln][dg] : nEaln - 1) + 1;
    const int Hqb = d_wins ? P[cQb][dg] : nEqb;
    const int Htb = d_wins ? P[cTb][dg] : nEtb;
    const bool invalid = j > tlen;
    if (invalid) { Hd = kNeg; Enew = kNeg; }

    // F: inclusive scan of (v, lane) keeping the later lane on ties
    sMat[k] = Hmat; sAlnK[k] = Haln - k; sQb[k] = Hqb; sTb[k] = Htb;
    int cv = Hd + sc.O - sc.E * k;
    int ci = k;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int ov = __shfl_up_sync(kFull, cv, s);
      const int oi = __shfl_up_sync(kFull, ci, s);
      if (lane >= s && !(cv >= ov)) { cv = ov; ci = oi; }
    }
    if (lane == 31) { wv[w] = cv; wi[w] = ci; }
    __syncthreads();
    int pv = wv[0], pi = wi[0];
    for (int ww = 1; ww < w; ++ww)
      if (wv[ww] >= pv) { pv = wv[ww]; pi = wi[ww]; }
    int iv = cv, ii = ci;
    if (w > 0 && !(cv >= pv)) { iv = pv; ii = pi; }
    int ev = __shfl_up_sync(kFull, iv, 1);
    int ei = __shfl_up_sync(kFull, ii, 1);
    if (lane == 0) { ev = w == 0 ? kNeg : pv; ei = pi; }
    int F, Fmat, Faln, Fqb, Ftb;
    if (k == 0) {
      F = kNeg; Fmat = 0; Faln = 0; Fqb = 0; Ftb = 0;
    } else {
      F = ev + sc.E * k;
      Fmat = sMat[ei]; Faln = sAlnK[ei] + k; Fqb = sQb[ei]; Ftb = sTb[ei];
    }

    const bool hd_wins = Hd >= F;
    int Hnew = hd_wins ? Hd : F;
    int mat_new = hd_wins ? Hmat : Fmat;
    int aln_new = hd_wins ? Haln : Faln;
    int qb_new = hd_wins ? Hqb : Fqb;
    int tb_new = hd_wins ? Htb : Ftb;
    if (Hnew < 0) { Hnew = 0; mat_new = 0; aln_new = 0; qb_new = i; tb_new = j; }
    if (invalid) Hnew = kNeg;

    if (Hnew > best_v) {
      best_v = Hnew; best_qe = i; best_mat = mat_new; best_aln = aln_new;
      best_qb = qb_new; best_tb = tb_new; best_te = (int)off + k;
    }

    const int nx = cur ^ 1;
    int (*N)[kPadW] = cb[nx];
    N[cH][1 + k] = Hnew; N[cE][1 + k] = Enew;
    N[cMat][1 + k] = mat_new; N[cAln][1 + k] = aln_new;
    N[cEmat][1 + k] = nEmat; N[cEaln][1 + k] = nEaln;
    N[cQb][1 + k] = qb_new; N[cTb][1 + k] = tb_new;
    N[cEqb][1 + k] = nEqb; N[cEtb][1 + k] = nEtb;
    __syncthreads();
    off_prev = off;
    cur = nx;
  }

  // the reference's sequence of per-row first-argmax candidates with strict
  // improvement is the cell with the largest value, then the earliest row,
  // then the lowest lane
  bv[k] = best_v;
  bqe[k] = best_qe;
  __syncthreads();
  __shared__ int win;
  if (k == 0) {
    int b = 0;
    for (int x = 1; x < kBand; ++x)
      if (bv[x] > bv[b] || (bv[x] == bv[b] && bqe[x] < bqe[b])) b = x;
    win = bv[b] > kNeg ? b : -1;
  }
  __syncthreads();
  if (win < 0 && k == 0) {
    out[0 * n + p] = kNeg;
    for (int f = 1; f < 7; ++f) out[f * n + p] = 0;
  } else if (k == win) {
    // field order of BandedResult: score, qb, qe, tb, te, aln, mat
    out[0 * n + p] = best_v; out[1 * n + p] = best_qb;
    out[2 * n + p] = best_qe; out[3 * n + p] = best_tb;
    out[4 * n + p] = best_te; out[5 * n + p] = best_aln;
    out[6 * n + p] = best_mat;
  }
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
  Scores sc{M, X, O, E};
  global_fill_kernel<<<n, kBand, 0, stream>>>(qs, qmax, qlens, ts, t_stride,
                                               tmax, tlens, sc, moves, offs,
                                               score);
  return (int)cudaGetLastError();
}

int ccsx_banded_local(const uint8_t* qs, int qmax, const int* qlens,
                      const uint8_t* ts, int tmax, const int* tlens,
                      const int* lines, int M, int X, int O, int E, int* out,
                      int n, cudaStream_t stream) {
  Scores sc{M, X, O, E};
  local_fill_kernel<<<n, kBand, 0, stream>>>(qs, qmax, qlens, ts, tmax, tlens,
                                              lines, sc, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
