// Soft-DTW forward + backward, CPU reference implementation.
//
// CPU twin of the card's soft-DTW (ops/soft_dtw.py, csrc/soft_dtw.cu); the
// reference ships this as numba-JIT'd Python (reference
// litfass/third_party/softdtw/__init__.py:7-51) used for eval metrics.
// Classic O(N*M) dynamic program (Cuturi & Blondel 2017): forward fills
// R with the soft-min recursion, backward fills the expectation matrix E.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 softdtw.cpp -o libsoftdtw.so
// (native/__init__.py builds it at first use and loads it with ctypes).

#include <cmath>
#include <cstddef>
#include <vector>

namespace {

constexpr double kInf = 1e30;

inline double softmin3(double a, double b, double c, double gamma) {
  a /= -gamma;
  b /= -gamma;
  c /= -gamma;
  double mx = a > b ? (a > c ? a : c) : (b > c ? b : c);
  double sum = std::exp(a - mx) + std::exp(b - mx) + std::exp(c - mx);
  return -gamma * (std::log(sum) + mx);
}

}  // namespace

extern "C" {

// D: (n, m) row-major pairwise distances. R_out: (n+2, m+2) workspace
// (may be null -> internal). Returns soft-DTW value.
double softdtw_forward(const double* D, int n, int m, double gamma,
                       double* R_out) {
  std::vector<double> storage;
  double* R = R_out;
  size_t stride = static_cast<size_t>(m) + 2;
  if (R == nullptr) {
    storage.assign((static_cast<size_t>(n) + 2) * stride, kInf);
    R = storage.data();
  } else {
    for (size_t i = 0; i < (static_cast<size_t>(n) + 2) * stride; ++i)
      R[i] = kInf;
  }
  R[0] = 0.0;  // R[0][0]
  for (int i = 1; i <= n; ++i) {
    for (int j = 1; j <= m; ++j) {
      double d = D[(i - 1) * m + (j - 1)];
      R[i * stride + j] =
          d + softmin3(R[(i - 1) * stride + j], R[i * stride + (j - 1)],
                       R[(i - 1) * stride + (j - 1)], gamma);
    }
  }
  return R[static_cast<size_t>(n) * stride + m];
}

// Backward: fills E (n, m) with dLoss/dD given R from the forward pass
// (with R workspace of shape (n+2, m+2)).
void softdtw_backward(const double* D, double* R, int n, int m, double gamma,
                      double* E) {
  size_t stride = static_cast<size_t>(m) + 2;
  std::vector<double> Ework((static_cast<size_t>(n) + 2) * stride, 0.0);
  // boundary setup (Cuturi & Blondel Alg. 2)
  for (int i = 1; i <= n; ++i) R[i * stride + (m + 1)] = -kInf;
  for (int j = 1; j <= m; ++j) R[(n + 1) * stride + j] = -kInf;
  R[(n + 1) * stride + (m + 1)] = R[static_cast<size_t>(n) * stride + m];
  Ework[(static_cast<size_t>(n) + 1) * stride + (m + 1)] = 1.0;

  for (int j = m; j >= 1; --j) {
    for (int i = n; i >= 1; --i) {
      double r = R[i * stride + j];
      double d_right = (i + 1 <= n) ? D[i * m + (j - 1)] : 0.0;     // D[i+1,j]
      double d_down = (j + 1 <= m) ? D[(i - 1) * m + j] : 0.0;      // D[i,j+1]
      double d_diag = (i + 1 <= n && j + 1 <= m) ? D[i * m + j] : 0.0;
      double a = std::exp((R[(i + 1) * stride + j] - r - d_right) / gamma);
      double b = std::exp((R[i * stride + (j + 1)] - r - d_down) / gamma);
      double c =
          std::exp((R[(i + 1) * stride + (j + 1)] - r - d_diag) / gamma);
      Ework[i * stride + j] = Ework[(i + 1) * stride + j] * a +
                              Ework[i * stride + (j + 1)] * b +
                              Ework[(i + 1) * stride + (j + 1)] * c;
    }
  }
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j)
      E[i * m + j] = Ework[(i + 1) * stride + (j + 1)];
}

// Convenience: batched forward over (B, n, m) distance matrices.
void softdtw_forward_batch(const double* D, int batch, int n, int m,
                           double gamma, double* out) {
  for (int b = 0; b < batch; ++b) {
    out[b] = softdtw_forward(D + static_cast<size_t>(b) * n * m, n, m, gamma,
                             nullptr);
  }
}

}  // extern "C"
