// Fast Levenshtein distance over int32 token sequences.
// Host-side eval kernel: the reference computes edit distance in pure
// Python (reference metrics.py:56-73); this is the C++ equivalent exposed
// through ctypes (see utils/edit_distance.py). Two-row DP, O(min(n,m)) memory.
// Built on first use by the host's C++ compiler (ops/cuda_build.py
// host_library); a copy of native/editdist.cpp of the JAX package.
#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

int64_t levenshtein_i32(const int32_t* a, int64_t n, const int32_t* b, int64_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  if (n > m) {
    std::swap(a, b);
    std::swap(n, m);
  }
  std::vector<int32_t> row(static_cast<size_t>(n) + 1);
  for (int64_t j = 0; j <= n; ++j) row[j] = static_cast<int32_t>(j);
  for (int64_t i = 1; i <= m; ++i) {
    int32_t diag = row[0];
    row[0] = static_cast<int32_t>(i);
    const int32_t bi = b[i - 1];
    for (int64_t j = 1; j <= n; ++j) {
      const int32_t up = row[j];
      const int32_t sub = diag + (a[j - 1] != bi);
      const int32_t ins = row[j - 1] + 1;
      const int32_t del = up + 1;
      row[j] = std::min(sub, std::min(ins, del));
      diag = up;
    }
  }
  return row[n];
}

// Smith-Waterman local alignment with affine gaps (Gotoh) + traceback.
// Used by the late-fusion pipeline (fusion/smith_waterman.py). Gap model
// matches swalign.LocalAlignment: a gap of length L scores
// gap_open + (L-1)*gap_extend (both negative).
// Returns the cigar as (op, count) pairs written into out_ops/out_counts
// (caller-allocated, capacity cap); fills r_pos/q_pos with the alignment
// start (0-based) in ref/query. Returns number of cigar entries, or -1 if
// capacity was insufficient. Ops: 0='M', 1='I' (consumes query), 2='D'
// (consumes ref).
int64_t smith_waterman_i32(const int32_t* ref, int64_t n, const int32_t* query, int64_t m,
                           double match, double mismatch, double gap_open, double gap_extend,
                           int32_t* out_ops, int32_t* out_counts, int64_t cap,
                           int64_t* r_pos, int64_t* q_pos) {
  const int64_t w = n + 1;
  const double kNegInf = -1e30;
  std::vector<double> h(static_cast<size_t>((n + 1) * (m + 1)), 0.0);
  std::vector<double> e(static_cast<size_t>((n + 1) * (m + 1)), kNegInf);  // gap in query (D: consume ref)
  std::vector<double> f(static_cast<size_t>((n + 1) * (m + 1)), kNegInf);  // gap in ref (I: consume query)
  // traceback for H: 0 stop, 1 diag, 2 from E (D), 3 from F (I)
  std::vector<int8_t> tb(static_cast<size_t>((n + 1) * (m + 1)), 0);
  std::vector<int8_t> te(static_cast<size_t>((n + 1) * (m + 1)), 0);  // 1: E extends
  std::vector<int8_t> tf(static_cast<size_t>((n + 1) * (m + 1)), 0);  // 1: F extends
  double best = 0.0;
  int64_t bi = 0, bj = 0;
  for (int64_t j = 1; j <= m; ++j) {
    for (int64_t i = 1; i <= n; ++i) {
      const size_t c = j * w + i;
      const double eo = h[c - 1] + gap_open;
      const double ee = e[c - 1] + gap_extend;
      e[c] = std::max(eo, ee);
      te[c] = (ee > eo) ? 1 : 0;
      const double fo = h[c - w] + gap_open;
      const double fe = f[c - w] + gap_extend;
      f[c] = std::max(fo, fe);
      tf[c] = (fe > fo) ? 1 : 0;
      const double s = (ref[i - 1] == query[j - 1]) ? match : mismatch;
      const double diag = h[c - w - 1] + s;
      double v = 0.0;
      int8_t t = 0;
      if (diag > v) { v = diag; t = 1; }
      if (e[c] > v) { v = e[c]; t = 2; }
      if (f[c] > v) { v = f[c]; t = 3; }
      h[c] = v;
      tb[c] = t;
      if (v > best) { best = v; bi = i; bj = j; }
    }
  }
  // Traceback from (bi, bj) to a zero cell, collecting ops in reverse.
  std::vector<int32_t> ops_rev, cnt_rev;
  auto push = [&](int32_t op) {
    if (!ops_rev.empty() && ops_rev.back() == op) cnt_rev.back() += 1;
    else { ops_rev.push_back(op); cnt_rev.push_back(1); }
  };
  int64_t i = bi, j = bj;
  int state = 0;  // 0: in H, 2: in E, 3: in F
  while (i > 0 && j > 0) {
    const size_t c = j * w + i;
    if (state == 0) {
      const int8_t t = tb[c];
      if (t == 0) break;
      if (t == 1) { push(0); --i; --j; }
      else state = t;
    } else if (state == 2) {
      push(2);
      const int8_t ext = te[c];
      --i;
      if (!ext) state = 0;
    } else {
      push(1);
      const int8_t ext = tf[c];
      --j;
      if (!ext) state = 0;
    }
  }
  *r_pos = i;
  *q_pos = j;
  const int64_t k = static_cast<int64_t>(ops_rev.size());
  if (k > cap) return -1;
  for (int64_t x = 0; x < k; ++x) {
    out_ops[x] = ops_rev[k - 1 - x];
    out_counts[x] = cnt_rev[k - 1 - x];
  }
  return k;
}

}  // extern "C"
