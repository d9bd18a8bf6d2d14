// Multi-threaded CPU Gustavson SpGEMM baseline (C ABI, OpenMP).
//
// bench.py's vs_baseline previously compared only against single-threaded
// scipy; the reference's flagship CPU kernel is multi-threaded
// (static_omp_CSR_SpMM, /root/reference/nlibs/static_omp_csr_kernel.cc:
// 98-206 — equal-cost static partition + dense-accumulator rows).  This
// is a fresh implementation of that ALGORITHM CLASS — two-phase
// Gustavson, per-thread dense accumulator, equal-flops row partition —
// so the device number can be stated relative to a reference-class
// multi-thread CPU run on this host.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (io/native.py).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
static double omp_get_wtime() { return 0.0; }
#endif

extern "C" {

// C = A(m x k) * B(k x n), CSR in/out counts only (the baseline is a
// timing yardstick: it does the full symbolic + numeric work and writes
// the output arrays, then frees them).  Returns 0 on success.
// out_ms: wall-clock milliseconds of one full multiply (symbolic +
// alloc + numeric), best of `iters` runs.  out_nnzc: exact nnz(C).
int smf_spgemm_mt(const int32_t* arp, const int32_t* aci, const float* av,
                  int64_t m, int64_t k, int64_t n, const int32_t* brp,
                  const int32_t* bci, const float* bv, int iters,
                  double* out_ms, int64_t* out_nnzc) {
  if (m <= 0 || n <= 0 || iters <= 0) return 1;
  const int nt = omp_get_max_threads();

  // equal-flops contiguous row partition (the reference's
  // arrayEqualPartition law): cut points on the per-row flops prefix sum
  std::vector<int64_t> pref(m + 1, 0);
  for (int64_t i = 0; i < m; ++i) {
    int64_t f = 0;
    for (int32_t e = arp[i]; e < arp[i + 1]; ++e) {
      const int32_t c = aci[e];
      if (c >= 0 && c < k) f += brp[c + 1] - brp[c];
    }
    pref[i + 1] = pref[i] + f;
  }
  const int64_t total = pref[m];
  std::vector<int64_t> cut(nt + 1, m);
  cut[0] = 0;
  for (int t = 1; t < nt; ++t) {
    const int64_t want = total * t / nt;
    int64_t lo = cut[t - 1], hi = m;
    while (lo < hi) {
      const int64_t mid = (lo + hi) / 2;
      if (pref[mid] < want)
        lo = mid + 1;
      else
        hi = mid;
    }
    cut[t] = lo;
  }

  double best = 1e30;
  int64_t nnzc = 0;
  for (int rep = 0; rep < iters; ++rep) {
    // int64 row pointers: nnz(C) can exceed 2^31 at corpus scales
    std::vector<int64_t> ic(m + 1, 0);
    int32_t* jc = nullptr;
    float* cv = nullptr;
    const double t0 = omp_get_wtime();
#pragma omp parallel
    {
      const int t = omp_get_thread_num();
      const int64_t r0 = cut[t], r1 = cut[t + 1];
      // dense accumulator + touched-column list per thread
      std::vector<float> x(n, 0.0f);
      std::vector<int32_t> touched(n);
      std::vector<uint8_t> used(n, 0);
      // phase 1: symbolic per-row counts
      for (int64_t i = r0; i < r1; ++i) {
        int32_t cnt = 0;
        for (int32_t e = arp[i]; e < arp[i + 1]; ++e) {
          const int32_t c = aci[e];
          if (c < 0 || c >= k) continue;
          for (int32_t f = brp[c]; f < brp[c + 1]; ++f) {
            const int32_t col = bci[f];
            if (!used[col]) {
              used[col] = 1;
              touched[cnt++] = col;
            }
          }
        }
        ic[i + 1] = cnt;
        for (int32_t s = 0; s < cnt; ++s) used[touched[s]] = 0;
      }
#pragma omp barrier
#pragma omp single
      {
        for (int64_t i = 0; i < m; ++i) ic[i + 1] += ic[i];
        jc = static_cast<int32_t*>(malloc(sizeof(int32_t) * ic[m]));
        cv = static_cast<float*>(malloc(sizeof(float) * ic[m]));
      }
      // phase 2: numeric scatter/gather into the exact-size output
      for (int64_t i = r0; i < r1; ++i) {
        int32_t cnt = 0;
        for (int32_t e = arp[i]; e < arp[i + 1]; ++e) {
          const int32_t c = aci[e];
          if (c < 0 || c >= k) continue;
          const float a = av[e];
          for (int32_t f = brp[c]; f < brp[c + 1]; ++f) {
            const int32_t col = bci[f];
            if (!used[col]) {
              used[col] = 1;
              touched[cnt++] = col;
            }
            x[col] += a * bv[f];
          }
        }
        const int64_t base = ic[i];
        for (int32_t s = 0; s < cnt; ++s) {
          const int32_t col = touched[s];
          jc[base + s] = col;
          cv[base + s] = x[col];
          x[col] = 0.0f;
          used[col] = 0;
        }
      }
    }
    const double ms = (omp_get_wtime() - t0) * 1e3;
    if (ms < best) best = ms;
    nnzc = ic[m];
    free(jc);
    free(cv);
  }
  *out_ms = best;
  *out_nnzc = nnzc;
  return 0;
}

}  // extern "C"
