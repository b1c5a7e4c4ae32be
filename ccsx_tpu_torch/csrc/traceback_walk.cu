// Traceback walk for Hopper (sm_90a): move bytes -> star-MSA projection.
//
// Replaces: no Pallas original.  It replaces the lax.while_loop of the JAX
// package's ccsx_tpu/ops/traceback.py::make_projector_reference (its default
// projector), which walks one pass from (qlen, tlen) back to (0, 0) in
// qlen + tlen steps.  The plain version in ccsx_tpu_torch/ops/traceback.py
// (project_plain) is the spec it is held against.
//
// What bounds it: the walk is a chain of dependent steps, each a move-byte
// load whose address depends on the previous step.  Counting each integer
// operation of the loop below as one, a step is 27 (loop test 3, row clamp
// 5, lane 5, address 2, op decision 12) plus 5 for a diagonal move, 19 for
// an insertion and 7 for a deletion (chip_smoke.py uses these counts for
// the bound).  A pass moves a few KB and does some 30 operations per step
// on one thread, so neither bandwidth nor arithmetic is the limit: the
// latency of the dependent loads is.
//
// What the design does about it: one block per pass.  Its threads fill the
// pass's outputs with PAD/0 in parallel, one thread walks (the state machine
// of the reference: forced up/left moves at the matrix edges, E/F extension
// bits, the right-aligned insertion fill), and then the threads left-justify
// the insertion cells and write them back in parallel.  The walk keeps the
// insertion count of the current slot in a register (each slot's insertions
// are one contiguous run of up moves, since j never grows), so it only
// stores; the moves it reads are one 128-byte row per query row and stay in
// L1 while the walk moves left along the row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBand = 128;
constexpr int kThreads = 128;
constexpr int kGap = 4;
constexpr int kPad = 5;
constexpr int kMaxIns = 16;
enum { sH, sE, sF };

__global__ void __launch_bounds__(kThreads)
walk_kernel(const uint8_t* __restrict__ moves, const int* __restrict__ offs,
            const uint8_t* __restrict__ qs, int qmax,
            const int* __restrict__ qlens, const int* __restrict__ tlens,
            int tmax, int max_ins, uint8_t* __restrict__ aligned,
            int* __restrict__ ins_cnt, uint8_t* __restrict__ ins_b,
            int* __restrict__ lead_ins) {
  const int p = blockIdx.x;
  const int tid = threadIdx.x;
  uint8_t* al = aligned + (size_t)p * tmax;
  int* ic = ins_cnt + (size_t)p * tmax;
  uint8_t* ib = ins_b + (size_t)p * tmax * max_ins;

  for (int x = tid; x < tmax; x += kThreads) { al[x] = kPad; ic[x] = 0; }
  for (int x = tid; x < tmax * max_ins; x += kThreads) ib[x] = kPad;
  __syncthreads();

  if (tid == 0) {
    const uint8_t* mv = moves + (size_t)p * qmax * kBand;
    const int* of = offs + (size_t)p * qmax;
    const uint8_t* q = qs + (size_t)p * qmax;
    // lengths clamped to the padded widths: no input reads out of bounds
    const int ql = qlens[p], tl = tlens[p];
    int i = ql < 0 ? 0 : (ql > qmax ? qmax : ql);
    int j = tl < 0 ? 0 : (tl > tmax ? tmax : tl);
    int state = sH;
    int slot = -1, cnt = 0, lead = 0;
    while (i > 0 || j > 0) {
      int row = i - 1 < 0 ? 0 : (i - 1 > qmax - 1 ? qmax - 1 : i - 1);
      int ln = j - of[row];
      ln = ln < 0 ? 0 : (ln > kBand - 1 ? kBand - 1 : ln);
      const int m = mv[(size_t)row * kBand + ln];
      int op;
      if (j == 0 && i > 0) op = 1;
      else if (i == 0 && j > 0) op = 2;
      else if (state == sE) op = 1;
      else if (state == sF) op = 2;
      else op = (m & 3) == 0 ? 0 : ((m & 3) == 1 ? 1 : 2);
      if (op == 0) {
        al[j - 1] = q[i - 1];
        --i; --j;
        state = sH;
      } else if (op == 1) {
        // one query base inserted after column j-1 (slot j, 0 = leading)
        if (j != slot) { slot = j; cnt = 0; }
        const int pos = max_ins - 1 - cnt;
        if (pos >= 0 && j > 0) ib[(size_t)(j - 1) * max_ins + pos] = q[i - 1];
        ++cnt;
        if (j > 0) ic[j - 1] = cnt; else lead = cnt;
        state = ((m & 4) != 0 || j == 0) ? sE : sH;
        --i;
      } else {
        al[j - 1] = kGap;
        state = ((m & 8) != 0 || i == 0) ? sF : sH;
        --j;
      }
    }
    lead_ins[p] = lead;
  }
  __syncthreads();

  // left-justify the right-aligned insertion cells
  for (int s = tid; s < tmax; s += kThreads) {
    const int c = ic[s];
    if (c <= 0 || c >= max_ins) continue;
    uint8_t cell[kMaxIns];
    uint8_t* b = ib + (size_t)s * max_ins;
    for (int r = 0; r < max_ins; ++r) cell[r] = b[r];
    const int shift = max_ins - c;
    for (int r = 0; r < max_ins; ++r) b[r] = r < c ? cell[r + shift] : kPad;
  }
}

}  // namespace

extern "C" {

const char* ccsx_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int ccsx_traceback_walk(const uint8_t* moves, const int* offs,
                        const uint8_t* qs, int qmax, const int* qlens,
                        const int* tlens, int tmax, int max_ins,
                        uint8_t* aligned, int* ins_cnt, uint8_t* ins_b,
                        int* lead_ins, int n, cudaStream_t stream) {
  if (max_ins < 1 || max_ins > kMaxIns) return (int)cudaErrorInvalidValue;
  walk_kernel<<<n, kThreads, 0, stream>>>(moves, offs, qs, qmax, qlens, tlens,
                                           tmax, max_ins, aligned, ins_cnt,
                                           ins_b, lead_ins);
  return (int)cudaGetLastError();
}

}  // extern "C"
