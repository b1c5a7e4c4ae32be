// Scalar affine-gap pairwise aligner (C++), the native reference
// implementation for differential testing (SURVEY.md §7.2 step 2).
//
// Semantics are pinned to the NumPy oracle (ccsx_tpu/ops/oracle.py), which
// itself replicates what ccsx consumes from bsalign's
// kmer_striped_seqedit_pairwise (main.c:264, result fields main.c:272-280):
// Gotoh affine-gap DP, modes global / qfree (query ends free) / local,
// traceback preferring diagonal, then vertical (E), then horizontal (F) on
// ties; first-occurrence argmax for free end cells.  The differential test
// (tests/test_native_align.py) requires exact equality of score, spans,
// counts and cigar against the oracle.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kNeg = -(1 << 29);

enum Mode { kGlobal = 0, kQfree = 1, kLocal = 2 };

struct Dp {
  int64_t Q, T, W;  // W = T + 1 row stride
  std::vector<int32_t> H, E, F;
  int32_t& h(int64_t i, int64_t j) { return H[i * W + j]; }
  int32_t& e(int64_t i, int64_t j) { return E[i * W + j]; }
  int32_t& f(int64_t i, int64_t j) { return F[i * W + j]; }
};

}  // namespace

extern "C" {

// out[10] = score qb qe tb te aln mat mis ins del.
// cigar (optional, may be null): expanded per-column ops 'M'/'I'/'D';
// *cigar_n receives the op count, or -1 when cigar_cap was too small
// (stats in `out` remain valid).
// Returns 0 ok, -1 bad args / problem too large for the scalar path.
int ccsx_align_scalar(const uint8_t* q, int64_t qlen, const uint8_t* t,
                      int64_t tlen, int mode, int match, int mismatch,
                      int gap_open, int gap_ext, int64_t* out, uint8_t* cigar,
                      int64_t cigar_cap, int64_t* cigar_n) {
  if (qlen < 0 || tlen < 0 || !out) return -1;
  if ((qlen + 1) * (tlen + 1) > (int64_t)1 << 26) return -1;  // 3x256MB cap
  const int oe = gap_open + gap_ext;
  Dp dp;
  dp.Q = qlen;
  dp.T = tlen;
  dp.W = tlen + 1;
  size_t cells = (size_t)((qlen + 1) * (tlen + 1));
  dp.H.assign(cells, kNeg);
  dp.E.assign(cells, kNeg);
  dp.F.assign(cells, kNeg);

  dp.h(0, 0) = 0;
  if (mode == kGlobal) {
    for (int64_t i = 1; i <= qlen; i++)
      dp.h(i, 0) = dp.e(i, 0) = gap_open + (int32_t)i * gap_ext;
    for (int64_t j = 1; j <= tlen; j++)
      dp.h(0, j) = dp.f(0, j) = gap_open + (int32_t)j * gap_ext;
  } else if (mode == kQfree) {
    for (int64_t i = 1; i <= qlen; i++) dp.h(i, 0) = 0;
    for (int64_t j = 1; j <= tlen; j++)
      dp.h(0, j) = dp.f(0, j) = gap_open + (int32_t)j * gap_ext;
  } else if (mode == kLocal) {
    for (int64_t i = 1; i <= qlen; i++) dp.h(i, 0) = 0;
    for (int64_t j = 1; j <= tlen; j++) dp.h(0, j) = 0;
  } else {
    return -1;
  }

  auto subst = [&](int64_t i, int64_t j) -> int32_t {
    // N (code >= 4) never matches anything, including itself
    return (q[i] == t[j] && q[i] < 4 && t[j] < 4) ? match : mismatch;
  };

  for (int64_t i = 1; i <= qlen; i++) {
    for (int64_t j = 0; j <= tlen; j++) {
      int32_t e1 = dp.h(i - 1, j) + oe, e2 = dp.e(i - 1, j) + gap_ext;
      dp.e(i, j) = e1 > e2 ? e1 : e2;
    }
    for (int64_t j = 1; j <= tlen; j++) {
      int32_t f1 = dp.h(i, j - 1) + oe, f2 = dp.f(i, j - 1) + gap_ext;
      int32_t f = f1 > f2 ? f1 : f2;
      dp.f(i, j) = f;
      int32_t h = dp.h(i - 1, j - 1) + subst(i - 1, j - 1);
      if (dp.e(i, j) > h) h = dp.e(i, j);
      if (f > h) h = f;
      if (mode == kLocal && h < 0) h = 0;
      if (h > dp.h(i, j)) dp.h(i, j) = h;
    }
  }

  // --- end cell (first-occurrence argmax, matching numpy) ---
  int64_t ei = qlen, ej = tlen;
  if (mode == kQfree) {
    int32_t best = kNeg - 1;
    for (int64_t i = 0; i <= qlen; i++)
      if (dp.h(i, tlen) > best) { best = dp.h(i, tlen); ei = i; }
    ej = tlen;
  } else if (mode == kLocal) {
    int32_t best = kNeg - 1;
    for (int64_t i = 0; i <= qlen; i++)
      for (int64_t j = 0; j <= tlen; j++)
        if (dp.h(i, j) > best) { best = dp.h(i, j); ei = i; ej = j; }
  }
  int32_t score = dp.h(ei, ej);

  // --- traceback (diag > E > F on ties, like the oracle) ---
  int64_t i = ei, j = ej;
  int64_t mat = 0, mis = 0, ins = 0, del = 0;
  std::vector<uint8_t> ops;  // reversed
  char state = 'H';
  for (;;) {
    if (state == 'H') {
      if (mode == kLocal && dp.h(i, j) == 0) break;
      if (mode == kQfree && j == 0) break;
      if (mode == kGlobal && i == 0 && j == 0) break;
      if (i > 0 && j > 0 &&
          dp.h(i, j) == dp.h(i - 1, j - 1) + subst(i - 1, j - 1)) {
        ops.push_back('M');
        if (q[i - 1] == t[j - 1] && q[i - 1] < 4) mat++; else mis++;
        i--; j--;
      } else if (i > 0 && dp.h(i, j) == dp.e(i, j)) {
        state = 'E';
      } else if (j > 0 && dp.h(i, j) == dp.f(i, j)) {
        state = 'F';
      } else {
        state = i > 0 ? 'E' : 'F';
      }
    } else if (state == 'E') {
      ops.push_back('I');
      ins++;
      if (dp.e(i, j) == dp.e(i - 1, j) + gap_ext && i > 1) { i--; }
      else { i--; state = 'H'; }
    } else {
      ops.push_back('D');
      del++;
      if (dp.f(i, j) == dp.f(i, j - 1) + gap_ext && j > 1) { j--; }
      else { j--; state = 'H'; }
    }
  }

  out[0] = score;
  out[1] = i;   // qb
  out[2] = ei;  // qe
  out[3] = j;   // tb
  out[4] = ej;  // te
  out[5] = mat + mis + ins + del;
  out[6] = mat;
  out[7] = mis;
  out[8] = ins;
  out[9] = del;
  if (cigar_n) {
    if (cigar && (int64_t)ops.size() <= cigar_cap) {
      for (size_t k = 0; k < ops.size(); k++)
        cigar[k] = ops[ops.size() - 1 - k];
      *cigar_n = (int64_t)ops.size();
    } else {
      *cigar_n = -1;
    }
  }
  return 0;
}

}  // extern "C"
