// Banded (DIA) matrix-powers kernels for Hopper (sm_90a): K1 and K2.
//
// K1 `dia_powers_fused` replaces ca_lanczos_tpu/ops/pallas_spmv.py
// `_dia_powers_fused` (pallas_call at :403).  It runs s steps of the
// three-term recurrence
//     w_{j+1}[i] = sum_d data[d,i] * w_j[i+off_d] - c[j,0] w_j[i] - c[j,1] w_{j-1}[i]
// with w_0 = x, w_{-1} = 0 and zero outside [0, n), and writes every
// step to V (s, n) and the last one again to `last` (n,).
//
// K2 `dia_power_step` replaces `_dia_step_kernel` / `_dia_power_step`
// (pallas_call at :113): one step y = sum_d data[d]*x[i+off_d] - c0 x - c1 v_prev.
//
// What bounds them on an H100: bytes.  A step does nd multiply-adds per
// row against nd+2 elements of traffic (planes, x, y), far below the
// card's ~20 flop/byte (f32) balance point.  K2 streams the matrix once
// per step.  K1 makes the communication-avoiding trade of the TPU kernel:
// each block stages its matrix tile and an x window with an s*max|off|
// halo on each side in shared memory, runs all s steps there, and writes
// only the owned centre of each step, so the matrix and x are read from
// device memory once per s steps (nd+1+s+1 elements per row per call
// instead of s*(nd+2)).  Halo rows are recomputed by both neighbours;
// their values go stale inward by max|off| per step, which the s*max|off|
// halo absorbs.  The two vector buffers hold w_j and w_{j-1}; w_{j+1}
// overwrites w_{j-1} in place (each thread reads and writes only its own
// positions of that buffer), so one barrier per step suffices.
//
// The Mosaic-specific parts of the TPU kernel are not carried over: no
// flat W-padded plane layout, no 1024-element alignment (the ragged edge
// is masked), no f64->f32 cast at the seam (both types are instantiated).
#include "dia_common.cuh"

template <typename T>
__global__ void dia_powers_fused_kernel(const T* __restrict__ data, DiaOffsets offs, int nd,
                                        const T* __restrict__ x, StepCoefs coefs,
                                        int with_coefs, T* __restrict__ V,
                                        T* __restrict__ last, long long n, int s, int tile,
                                        int halo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int L = tile + 2 * halo;
  T* dat = smem;                  // nd * L matrix tile
  T* cur = smem + (size_t)nd * L; // w_j
  T* oth = cur + L;               // w_{j-1}, overwritten by w_{j+1}
  const long long t0 = (long long)blockIdx.x * tile;
  const long long w0 = t0 - halo;

  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    const long long g = w0 + p;
    const bool in = g >= 0 && g < n;
    for (int d = 0; d < nd; ++d) dat[d * L + p] = in ? data[(long long)d * n + g] : T(0);
    cur[p] = in ? x[g] : T(0);
    oth[p] = T(0);
  }
  __syncthreads();

  for (int j = 0; j < s; ++j) {
    const T c0 = (T)coefs.v[2 * j];
    const T c1 = (T)coefs.v[2 * j + 1];
    for (int p = threadIdx.x; p < L; p += blockDim.x) {
      T acc = T(0);
      for (int d = 0; d < nd; ++d) {
        const int q = p + offs.v[d];
        const T v = (q >= 0 && q < L) ? cur[q] : T(0);
        acc += dat[d * L + p] * v;
      }
      oth[p] = with_coefs ? acc - c0 * cur[p] - c1 * oth[p] : acc;
    }
    __syncthreads();
    T* t = cur;
    cur = oth;
    oth = t;
    T* out = V + (long long)j * n;
    for (int p = threadIdx.x; p < tile; p += blockDim.x) {
      const long long g = t0 + p;
      if (g < n) out[g] = cur[halo + p];
    }
  }
  for (int p = threadIdx.x; p < tile; p += blockDim.x) {
    const long long g = t0 + p;
    if (g < n) last[g] = cur[halo + p];
  }
}

template <typename T>
__global__ void dia_power_step_kernel(const T* __restrict__ data, DiaOffsets offs, int nd,
                                      const T* __restrict__ x, const T* __restrict__ vprev,
                                      T c0, T c1, int with_coefs, T* __restrict__ y,
                                      long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    T acc = T(0);
    for (int d = 0; d < nd; ++d) {
      const long long k = i + offs.v[d];
      if (k >= 0 && k < n) acc += data[(long long)d * n + i] * x[k];
    }
    if (with_coefs) {
      acc = acc - c0 * x[i];
      if (vprev) acc = acc - c1 * vprev[i];
    }
    y[i] = acc;
  }
}

template <typename T>
static int fused(const T* data, const int* offsets, int nd, const T* x, const double* coefs,
                 T* V, T* last, long long n, int s, int tile, int halo, void* stream) {
  DiaOffsets o;
  StepCoefs c;
  if (!fill_params(offsets, nd, coefs, s, &o, &c) || s < 1 || tile < 1 || halo < 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)(nd + 2) * (tile + 2 * halo) * sizeof(T);
  const int blocks = (int)((n + tile - 1) / tile);
  return launch_with_smem(dia_powers_fused_kernel<T>, blocks, 512, bytes, stream, data, o, nd,
                          x, c, coefs != nullptr ? 1 : 0, V, last, n, s, tile, halo);
}

template <typename T>
static int step(const T* data, const int* offsets, int nd, const T* x, const T* vprev,
                const double* coefs, T* y, long long n, void* stream) {
  DiaOffsets o;
  StepCoefs c;
  if (!fill_params(offsets, nd, coefs, 1, &o, &c)) return (int)cudaErrorInvalidValue;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  dia_power_step_kernel<T><<<blocks, 256, 0, (cudaStream_t)stream>>>(
      data, o, nd, x, vprev, (T)c.v[0], (T)c.v[1], coefs != nullptr ? 1 : 0, y, n);
  return (int)cudaGetLastError();
}

extern "C" {

int dia_powers_fused_f32(const float* data, const int* offsets, int nd, const float* x,
                         const double* coefs, float* V, float* last, long long n, int s,
                         int tile, int halo, void* stream) {
  return fused<float>(data, offsets, nd, x, coefs, V, last, n, s, tile, halo, stream);
}

int dia_powers_fused_f64(const double* data, const int* offsets, int nd, const double* x,
                         const double* coefs, double* V, double* last, long long n, int s,
                         int tile, int halo, void* stream) {
  return fused<double>(data, offsets, nd, x, coefs, V, last, n, s, tile, halo, stream);
}

int dia_power_step_f32(const float* data, const int* offsets, int nd, const float* x,
                       const float* vprev, const double* coefs, float* y, long long n,
                       void* stream) {
  return step<float>(data, offsets, nd, x, vprev, coefs, y, n, stream);
}

int dia_power_step_f64(const double* data, const int* offsets, int nd, const double* x,
                       const double* vprev, const double* coefs, double* y, long long n,
                       void* stream) {
  return step<double>(data, offsets, nd, x, vprev, coefs, y, n, stream);
}

}  // extern "C"
