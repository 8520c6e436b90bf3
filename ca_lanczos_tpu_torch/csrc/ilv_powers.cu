// Interleaved-layout banded matrix-powers kernel for Hopper (sm_90a): K3.
//
// Replaces ca_lanczos_tpu/ops/pallas_ilv.py `dia_powers_ilv` (pallas_call
// at :301).  Vectors and data planes are J=8 row-interleaved,
// x_il[r*nq + q] = x[8q + r] with nq = n/8, i.e. the kernel applies
// P A P^T.  Output row p = r*nq + q of a step reads, for each diagonal
// offset o, source row (r+o) mod 8 at q-offset q + floor((r+o)/8) (floor
// also for negative r+o), zero outside [0, nq).  It runs K1's three-term
// recurrence for s steps
//     w_{j+1} = A w_j - c[j,0] w_j - c[j,1] w_{j-1},  w_0 = x, w_{-1} = x_prev (or 0)
// and writes V_il (s, n) and last_il (n,) in the interleaved space itself:
// encoding/decoding around K1 would add two full vector passes per call.
//
// What bounds it on an H100: bytes, as for K1.  Each block owns a q-tile
// of Tq columns in all 8 rows and stages the 8 x (Tq + 2*Hq) windows of
// the matrix planes and of x in shared memory, with Hq = s*max ceil(|o|/8)
// (a diagonal moves at most that many q-columns per step), runs the s
// steps there and writes only the owned centres, so the matrix and x are
// read from device memory once per s steps.  Every row of the window is a
// contiguous run of each plane, so the loads coalesce.  The TPU kernel's
// tile-major, halo-duplicated plane layout and its 1024-element DMA
// alignment are Mosaic artifacts and are not used: the planes are plain
// interleaved (nd, n) arrays.  `x_prev` lets a caller chain launches
// (s single steps) when the s-step window does not fit shared memory.
#include "dia_common.cuh"

static __device__ __forceinline__ int floor_div8(int v) {
  return v >= 0 ? v / 8 : -((-v + 7) / 8);
}

template <typename T>
__global__ void ilv_powers_kernel(const T* __restrict__ data, DiaOffsets offs, int nd,
                                  const T* __restrict__ x, const T* __restrict__ xprev,
                                  StepCoefs coefs, int with_coefs, T* __restrict__ V,
                                  T* __restrict__ last, long long n, int s, int tq, int hq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const long long nq = n / 8;
  const int Lq = tq + 2 * hq;
  const int LW = 8 * Lq;
  T* dat = smem;                   // nd * 8 * Lq: plane d, row r at dat[d*LW + r*Lq]
  T* cur = smem + (size_t)nd * LW; // w_j
  T* oth = cur + LW;               // w_{j-1}, overwritten by w_{j+1}
  const long long q0 = (long long)blockIdx.x * tq - hq;

  for (int e = threadIdx.x; e < LW; e += blockDim.x) {
    const int r = e / Lq;
    const long long q = q0 + (e - r * Lq);
    const bool in = q >= 0 && q < nq;
    const long long gi = r * nq + q;
    for (int d = 0; d < nd; ++d) dat[d * LW + e] = in ? data[(long long)d * n + gi] : T(0);
    cur[e] = in ? x[gi] : T(0);
    oth[e] = (in && xprev) ? xprev[gi] : T(0);
  }
  __syncthreads();

  for (int j = 0; j < s; ++j) {
    const T c0 = (T)coefs.v[2 * j];
    const T c1 = (T)coefs.v[2 * j + 1];
    for (int e = threadIdx.x; e < LW; e += blockDim.x) {
      const int r = e / Lq;
      const int qq = e - r * Lq;
      T acc = T(0);
      for (int d = 0; d < nd; ++d) {
        const int src = r + offs.v[d];
        const int carry = floor_div8(src);
        const int qs = qq + carry;
        const T v = (qs >= 0 && qs < Lq) ? cur[(src - 8 * carry) * Lq + qs] : T(0);
        acc += dat[d * LW + e] * v;
      }
      oth[e] = with_coefs ? acc - c0 * cur[e] - c1 * oth[e] : acc;
    }
    __syncthreads();
    T* t = cur;
    cur = oth;
    oth = t;
    T* out = V + (long long)j * n;
    for (int e = threadIdx.x; e < 8 * tq; e += blockDim.x) {
      const int r = e / tq;
      const int qo = e - r * tq;
      const long long q = (long long)blockIdx.x * tq + qo;
      if (q < nq) out[r * nq + q] = cur[r * Lq + hq + qo];
    }
  }
  for (int e = threadIdx.x; e < 8 * tq; e += blockDim.x) {
    const int r = e / tq;
    const int qo = e - r * tq;
    const long long q = (long long)blockIdx.x * tq + qo;
    if (q < nq) last[r * nq + q] = cur[r * Lq + hq + qo];
  }
}

template <typename T>
static int ilv(const T* data, const int* offsets, int nd, const T* x, const T* xprev,
               const double* coefs, T* V, T* last, long long n, int s, int tq, int hq,
               void* stream) {
  DiaOffsets o;
  StepCoefs c;
  if (!fill_params(offsets, nd, coefs, s, &o, &c) || s < 1 || tq < 1 || hq < 0 || n % 8)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)(nd + 2) * 8 * (tq + 2 * hq) * sizeof(T);
  const long long nq = n / 8;
  const int blocks = (int)((nq + tq - 1) / tq);
  return launch_with_smem(ilv_powers_kernel<T>, blocks, 512, bytes, stream, data, o, nd, x,
                          xprev, c, coefs != nullptr ? 1 : 0, V, last, n, s, tq, hq);
}

extern "C" {

int dia_powers_ilv_f32(const float* data, const int* offsets, int nd, const float* x,
                       const float* xprev, const double* coefs, float* V, float* last,
                       long long n, int s, int tq, int hq, void* stream) {
  return ilv<float>(data, offsets, nd, x, xprev, coefs, V, last, n, s, tq, hq, stream);
}

int dia_powers_ilv_f64(const double* data, const int* offsets, int nd, const double* x,
                       const double* xprev, const double* coefs, double* V, double* last,
                       long long n, int s, int tq, int hq, void* stream) {
  return ilv<double>(data, offsets, nd, x, xprev, coefs, V, last, n, s, tq, hq, stream);
}

}  // extern "C"
