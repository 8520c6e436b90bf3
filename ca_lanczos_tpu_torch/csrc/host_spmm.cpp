// Row-parallel CSR x dense-panel product on the host, f64: Y = A X, the
// apply of the host polish (solvers/polish.py rayleigh_ritz_polish_host,
// through ops/_spmm_native.py).  scipy's CSR product runs on one thread.
//
// Every column is computed for any k: the row loop walks the panel in
// column blocks of at most 8, each summed in registers.  Each
// Y[i, j] is the sum of A[i, e] * X[col(e), j] over the row's entries in
// their stored order, starting from 0.0, which is the order of scipy's
// csr_matvec / csr_matvecs; built with -ffp-contract=off (no fused
// multiply-add), the result equals scipy's a @ X bit for bit.
//
// C ABI (ctypes):
//   csr_spmm_f64(n_rows, indptr i64[n_rows + 1], indices i32[nnz],
//                data f64[nnz], X f64[n_cols x k] row-major, k,
//                Y f64[n_rows x k] row-major (overwritten), threads)
//   threads <= 0 takes OpenMP's default.
//
// Build: g++ -O3 -fopenmp -ffp-contract=off -shared -fPIC host_spmm.cpp

#include <omp.h>

#include <cstdint>

namespace {

// Columns [j0, j0 + W) of row i.  W is a compile-time width, so the
// accumulators live in registers.
template <int W>
inline void row_panel(int64_t e0, int64_t e1, const int32_t* indices,
                      const double* data, const double* X, int64_t k,
                      int64_t j0, double* yr) {
  double acc[W];
  for (int j = 0; j < W; ++j) acc[j] = 0.0;
  for (int64_t e = e0; e < e1; ++e) {
    const double v = data[e];
    const double* xr = X + static_cast<int64_t>(indices[e]) * k + j0;
    for (int j = 0; j < W; ++j) acc[j] += v * xr[j];
  }
  for (int j = 0; j < W; ++j) yr[j0 + j] = acc[j];
}

constexpr int64_t kPanel = 8;

}  // namespace

extern "C" {

void csr_spmm_f64(int64_t n, const int64_t* indptr, const int32_t* indices,
                  const double* data, const double* X, int64_t k, double* Y,
                  int threads) {
  const int nt = threads > 0 ? threads : omp_get_max_threads();
#pragma omp parallel for schedule(dynamic, 2048) num_threads(nt)
  for (int64_t i = 0; i < n; ++i) {
    const int64_t e0 = indptr[i], e1 = indptr[i + 1];
    double* yr = Y + i * k;
    for (int64_t j0 = 0; j0 < k; j0 += kPanel) {
      switch (k - j0 < kPanel ? k - j0 : kPanel) {
        case 8: row_panel<8>(e0, e1, indices, data, X, k, j0, yr); break;
        case 7: row_panel<7>(e0, e1, indices, data, X, k, j0, yr); break;
        case 6: row_panel<6>(e0, e1, indices, data, X, k, j0, yr); break;
        case 5: row_panel<5>(e0, e1, indices, data, X, k, j0, yr); break;
        case 4: row_panel<4>(e0, e1, indices, data, X, k, j0, yr); break;
        case 3: row_panel<3>(e0, e1, indices, data, X, k, j0, yr); break;
        case 2: row_panel<2>(e0, e1, indices, data, X, k, j0, yr); break;
        default: row_panel<1>(e0, e1, indices, data, X, k, j0, yr); break;
      }
    }
  }
}

}  // extern "C"
