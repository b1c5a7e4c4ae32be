// Banded affine-gap FILL kernel for the CPU baseline measurement
// (benchmarks/cpu_baseline.py; VERDICT r4 item 4).
//
// The north-star comparison (BASELINE.md) needs an honest per-core CPU
// cells/s for the workload the reference actually runs: bsalign's
// banded-striped SIMD fill (reference main.c:849 band=128; reference
// Makefile:6-17 builds SSE4.2/AVX2 dispatch).  bsalign itself is not
// buildable offline, so this file measures the SAME banded recurrence
// the TPU path computes (ops/banded.py: band=128, affine Gotoh,
// horizontal gap via max-plus prefix scan, deterministic nominal band
// line), compiled TWICE from identical source (Makefile):
//
//   * ccsx_banded_fill_vec    — -O3 -march=native: every per-row step
//     is an elementwise/shifted-pointer loop over a fixed 128-wide
//     int16 band (the shape compilers vectorize to AVX2/AVX-512), the
//     horizontal scan is log2(128) ping-pong Hillis-Steele passes
//   * ccsx_banded_fill_scalar — -O2 -fno-tree-vectorize: the "1 lane"
//     control (CCSX_VARIANT_SCALAR translation unit)
//
// vec/scalar on identical source + bit-identical output IS the
// measured SIMD factor that replaces the old guessed 8x credit.  A
// thread-pool driver (ccsx_banded_fill_many) measures pair-level
// scaling — the reference's own parallel shape (kthread.c:48-65,
// atomic work claiming over holes) — though on 1-core hosts the curve
// measures the host.
//
// Fill only, no traceback: the baseline unit is DP cells/s and the
// fill dominates bsalign's runtime; both variants return the final
// band row so the differential test (tests/test_native_align.py) can
// assert bit-equality and the compiler cannot dead-code the loop.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <thread>
#include <vector>

namespace {

constexpr int kBand = 128;           // == reference bandwidth, main.c:849
constexpr int16_t kNeg = -16384;     // safe: |scores| < band*|weights| << 16k

}  // namespace

#if defined(CCSX_VARIANT_SCALAR)
#define FILL_NAME ccsx_banded_fill_scalar
#else
#define FILL_NAME ccsx_banded_fill_vec
#endif

extern "C" int FILL_NAME(const uint8_t* q, int64_t qlen, const uint8_t* t,
                         int64_t tlen, int match, int mismatch, int gap_open,
                         int gap_ext, int16_t* h_final) {
  if (!q || !t || !h_final || qlen <= 0 || tlen <= 0) return -1;
  const int16_t mat = (int16_t)match, mis = (int16_t)mismatch;
  const int16_t oe = (int16_t)(gap_open + gap_ext), ge = (int16_t)gap_ext;

  // band arrays padded [1 left, 3 right] so vertical/diag predecessors
  // at shift d in [0,2] are plain shifted-pointer reads, no clamping
  alignas(64) int16_t Hp[kBand + 4], Ep[kBand + 4];
  alignas(64) int16_t H[kBand], E[kBand], tq[kBand], jge[kBand];
  alignas(64) int16_t b0[kBand], b1[kBand];

  for (int j = 0; j < kBand; j++) jge[j] = (int16_t)(j * ge);

  // row 0: band at template col 0; global init H(0,col) = open + col*ext
  int64_t off = 0;
  for (int j = 0; j < kBand; j++) {
    int64_t col = off + j;
    H[j] = col == 0 ? 0
         : (col <= tlen ? (int16_t)(oe + (col - 1) * ge) : kNeg);
    E[j] = kNeg;
  }

  for (int64_t i = 1; i <= qlen; i++) {
    // deterministic nominal line (i*tlen/qlen), shift bounded [0,2]
    // (ops/banded.py's band walk; argmax adaptation deliberately absent
    // there and here)
    int64_t center = (i * tlen) / qlen;
    int64_t noff = std::min(std::max(center - kBand / 2, (int64_t)0),
                            std::max(tlen + 1 - kBand, (int64_t)0));
    int d = (int)std::min(std::max(noff - off, (int64_t)0), (int64_t)2);
    noff = off + d;

    Hp[0] = kNeg; Ep[0] = kNeg;
    std::memcpy(Hp + 1, H, sizeof H);
    std::memcpy(Ep + 1, E, sizeof E);
    for (int j = 0; j < 3; j++) {
      Hp[kBand + 1 + j] = kNeg;
      Ep[kBand + 1 + j] = kNeg;
    }

    // template lanes: contiguous widening copy + sentinel edges
    // (lane j is template col noff+j; sentinel never matches)
    {
      int64_t lo = std::max((int64_t)1 - noff, (int64_t)0);
      int64_t hi = std::min((int64_t)kBand, tlen + 1 - noff);
      for (int64_t j = 0; j < lo; j++) tq[j] = 0x7fff;
      for (int64_t j = lo; j < hi; j++) tq[j] = t[noff + j - 1];
      for (int64_t j = std::max(hi, lo); j < kBand; j++) tq[j] = 0x7fff;
    }

    // E (vertical), diag, h0 = max(diag, E), scan input — elementwise
    const int16_t qi = q[i - 1] < 4 ? (int16_t)q[i - 1] : (int16_t)0x7ffe;
    const int16_t* hv = Hp + 1 + d;  // vertical pred of lane j
    const int16_t* ev = Ep + 1 + d;
    const int16_t* hd = Hp + d;      // diagonal pred of lane j
    for (int j = 0; j < kBand; j++) {
      int16_t e1 = (int16_t)(hv[j] + oe), e2 = (int16_t)(ev[j] + ge);
      int16_t e = e1 > e2 ? e1 : e2;
      E[j] = e;
      int16_t s = tq[j] == qi ? mat : mis;
      int16_t h0 = (int16_t)(hd[j] + s);
      if (e > h0) h0 = e;
      H[j] = h0;
      b0[j] = (int16_t)(h0 + oe - jge[j]);
    }
    if (noff == 0) b0[0] = kNeg;  // col 0 opens no horizontal gap

    // F[j] = ge*j + max_{k<j} b[k]: exclusive max-prefix-scan as
    // log2(128) ping-pong Hillis-Steele passes (each elementwise over
    // disjoint src/dst, so the compiler can vectorize every pass)
    {
      int16_t *src = b0, *dst = b1;
      for (int s = 1; s < kBand; s <<= 1) {
        std::memcpy(dst, src, (size_t)s * sizeof(int16_t));
        for (int j = s; j < kBand; j++)
          dst[j] = src[j] > src[j - s] ? src[j] : src[j - s];
        std::swap(src, dst);
      }
      for (int j = 1; j < kBand; j++) {
        int16_t f = (int16_t)(src[j - 1] + jge[j]);
        if (f > H[j]) H[j] = f;
      }
    }
    if (noff == 0) {  // reinstate the global first-column init
      H[0] = (int16_t)(oe + (i - 1) * ge);
      E[0] = (int16_t)(oe + (i - 1) * ge);
    }
    off = noff;
  }
  std::memcpy(h_final, H, sizeof H);
  return 0;
}

#if !defined(CCSX_VARIANT_SCALAR)

extern "C" int ccsx_banded_fill_scalar(const uint8_t*, int64_t,
                                       const uint8_t*, int64_t, int, int,
                                       int, int, int16_t*);

// Thread pool over independent pairs (the reference's hole-level
// parallelism, kthread.c:48-65: atomic work claiming, no ordering).
// qs/ts: npairs sequences of qlen/tlen each, row-major.  h_finals:
// npairs * 128 int16 (may be null -> scratch).  Returns cells filled.
extern "C" int64_t ccsx_banded_fill_many(
    const uint8_t* qs, const uint8_t* ts, int64_t qlen, int64_t tlen,
    int64_t npairs, int nthreads, int vectorized, int match, int mismatch,
    int gap_open, int gap_ext, int16_t* h_finals) {
  if (!qs || !ts || qlen <= 0 || tlen <= 0 || npairs <= 0 || nthreads <= 0)
    return -1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<int16_t> scratch(kBand);
    for (;;) {
      int64_t k = next.fetch_add(1);
      if (k >= npairs) return;
      int16_t* hf = h_finals ? h_finals + k * kBand : scratch.data();
      if (vectorized)
        ccsx_banded_fill_vec(qs + k * qlen, qlen, ts + k * tlen, tlen,
                             match, mismatch, gap_open, gap_ext, hf);
      else
        ccsx_banded_fill_scalar(qs + k * qlen, qlen, ts + k * tlen, tlen,
                                match, mismatch, gap_open, gap_ext, hf);
    }
  };
  std::vector<std::thread> pool;
  for (int n = 1; n < nthreads; n++) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return npairs * qlen * kBand;
}

#endif  // !CCSX_VARIANT_SCALAR
