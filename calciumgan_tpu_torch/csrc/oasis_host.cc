// Exact float64 OASIS AR(1) on the host: the redo of the traces that the
// float32 machines flag on CPU tensors, the reference that the card's redo
// (csrc/oasis_ar1.cu) equals bit for bit, and the g^l it reads (its one
// library call). A copy of `cg_oasis_ar1` and `cg_deconvolve_batch`
// from the JAX package's calciumgan_tpu/native/calciumgan_native.cc, the
// same arithmetic in the same order (pool-adjacency algorithm, Friedrich et
// al. 2017; the spec of calciumgan_tpu_torch/ops/golden.py).
//
// The JAX package fans the batch over OpenMP threads; this copy has no
// OpenMP (a GPU host's toolchain may lack libgomp) and the caller,
// calciumgan_tpu_torch/ops/oasis.py, spreads rows over Python threads
// (ctypes releases the GIL). Built by kernels/build.py:load_host with
// -ffp-contract=off, so every product and sum rounds as numpy's does.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Single trace; c and s must hold T doubles.
void cg_oasis_ar1(const double* y, int64_t T, double g, double lam,
                  double s_min, double* c, double* s) {
  if (T <= 0) return;
  std::vector<double> v(T), w(T);
  std::vector<int64_t> t0(T), len(T);

  int64_t p = -1;
  for (int64_t t = 0; t < T; ++t) {
    double yt = (t == T - 1) ? y[t] - lam : y[t] - lam * (1.0 - g);
    ++p;
    v[p] = yt;
    w[p] = 1.0;
    t0[p] = t;
    len[p] = 1;
    while (p > 0) {
      double gl = std::pow(g, static_cast<double>(len[p - 1]));
      if (v[p] / w[p] >= gl * (v[p - 1] / w[p - 1]) + s_min) break;
      v[p - 1] += gl * v[p];
      w[p - 1] += gl * gl * w[p];
      len[p - 1] += len[p];
      --p;
    }
  }

  for (int64_t i = 0; i <= p; ++i) {
    double h = std::max(v[i] / w[i], 0.0);
    double dec = h;
    for (int64_t k = 0; k < len[i]; ++k) {
      c[t0[i] + k] = dec;
      dec *= g;
    }
  }
  s[0] = 0.0;
  for (int64_t t = 1; t < T; ++t) s[t] = c[t] - g * c[t - 1];
}

// out[l] = g^l for l = 0..T, by the very std::pow call of cg_oasis_ar1: the
// table from which the CUDA redo (csrc/oasis_ar1.cu, oasis_exact_f64_kernel)
// and its plain twin read g^l, so that neither depends on its own pow.
void cg_pow_table(double g, int64_t T, double* out) {
  for (int64_t l = 0; l <= T; ++l) {
    out[l] = std::pow(g, static_cast<double>(l));
  }
}

// signals (N, T) float32 row-major -> binary spikes (N, T) float32,
// s > threshold (the reference pipeline's recipe), one trace after another.
void cg_deconvolve_batch(const float* signals, int64_t N, int64_t T, double g,
                         double s_min, double threshold, float* out) {
  std::vector<double> y(T), c(T), s(T);
  for (int64_t i = 0; i < N; ++i) {
    const float* row = signals + i * T;
    for (int64_t t = 0; t < T; ++t) y[t] = static_cast<double>(row[t]);
    cg_oasis_ar1(y.data(), T, g, 0.0, s_min, c.data(), s.data());
    float* orow = out + i * T;
    for (int64_t t = 0; t < T; ++t) orow[t] = s[t] > threshold ? 1.0f : 0.0f;
  }
}

}  // extern "C"
