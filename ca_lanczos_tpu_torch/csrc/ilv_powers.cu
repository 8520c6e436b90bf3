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
// What bounds it on an H100: bytes, as for K1 (at 4.2M rows, 9 diagonals,
// s = 8: 319 MB, 0.095 ms at 3.35 TB/s).  A q-tile of Tq columns in all 8
// rows is computed from a window of Lq = Tq + 2*Hq columns, Hq = s*mc with
// mc = max ceil(|o|/8) (a diagonal moves at most mc q-columns per step), so
// the planes and x are read from device memory once per s steps and only
// the owned centre is written.  The TPU kernel's tile-major,
// halo-duplicated plane layout and its 1024-element DMA alignment are
// Mosaic artifacts and are not used: the planes are plain interleaved
// (nd, n) arrays.
//
// Design (`ilv_powers_reg`, nd <= 16, Lq = 64*CPT).  512 threads = 8 rows x
// 64 lanes; thread (r, l) owns window columns l + 64k (k < CPT) of row r
// for all s steps.  Its row fixes each diagonal's (source row, carry), so
// the per-diagonal offsets into the step buffer are computed once per
// thread (carry = (r+o) >> 3, an arithmetic shift, no division and no
// branch); its plane coefficients, w_j and w_{j-1} live in registers, and
// a step reads only the neighbours' w_j from shared memory, one buffer of
// a ping-pong pair (one barrier per step).  Reads past the window edge land
// in mc guard columns instead of being tested: they feed only halo columns,
// which the Hq = s*mc halo already discards.  The grid is persistent (as
// many blocks as fit on the SMs) and walks q-tiles; while a tile runs its s
// steps, cp.async copies stage the next tile's planes, x and x_prev into
// shared memory (zero-filled outside [0, nq); 16-byte pieces where the
// window is aligned), so staging overlaps compute.  Each lane stores
// consecutive q of one row, so a warp's V and `last` stores cover whole
// 128-byte lines; vector stores would need a lane to own consecutive
// columns, which makes the shared-memory reads bank-conflicted.  Measured
// on the H100 at the main path's shape, the s steps (shared-memory reads,
// multiply-adds and V stores) take most of the time, not the staging:
// staging a second tile ahead, 1024 threads or 128-column windows were
// each slower (PERF.md).
//
// `ilv_powers_smem` is the fallback for more diagonals or a wider window:
// one tile per block, coefficients read from the staged planes in shared
// memory, (source row, carry) from a per-block table, reads past the
// window edge clamped.  `x_prev` lets a caller chain launches (s single
// steps) when no s-step window fits.
#include <stdint.h>

#include "dia_common.cuh"

namespace {

constexpr int THREADS = 512;  // 8 interleaved rows x 64 lanes
constexpr int ROW_LANES = 64;

// Stage window columns [q0, q0 + Lq) of the 8 rows of one interleaved
// vector or plane `src` into dst[r*stride + c]: zero outside [0, nq) and
// for a null src.  Thread (r, l) copies columns l, l + 64, ... of row r,
// or, when `wide` (nq, q0, Lq, stride and the arrays' starts are multiples
// of 16 bytes), the 16-byte pieces l, l + 64, ... of it: a piece then lies
// wholly inside or wholly outside [0, nq).
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int stride, const T* src, const T* any,
                                           long long nq, long long q0, int Lq, bool wide) {
  constexpr int VE = 16 / (int)sizeof(T);
  const int r = threadIdx.x / ROW_LANES;
  const long long g0 = (long long)r * nq + q0;
  dst += r * stride;
  if (wide) {
    for (int c = (int)(threadIdx.x % ROW_LANES) * VE; c < Lq; c += ROW_LANES * VE) {
      const bool valid = src != nullptr && q0 + c >= 0 && q0 + c < nq;
      copy_async16(dst + c, valid ? src + g0 + c : any, valid);
    }
    return;
  }
  for (int c = threadIdx.x % ROW_LANES; c < Lq; c += ROW_LANES) {
    const bool valid = src != nullptr && q0 + c >= 0 && q0 + c < nq;
    copy_async(dst + c, valid ? src + g0 + c : any, valid);
  }
}

// The nd planes of a window: st[(d*8 + r)*Lq + c].
template <typename T>
__device__ __forceinline__ void stage_planes(T* st, const T* data, int nd, long long n,
                                             long long nq, long long q0, int Lq, bool wide) {
  for (int d = 0; d < nd; ++d)
    stage_rows(st + d * 8 * Lq, Lq, data + (long long)d * n, data, nq, q0, Lq, wide);
}

// The register kernel's staging area: the nd planes, then x, then x_prev.
template <typename T>
__device__ __forceinline__ void stage_window(T* st, const T* data, int nd, const T* x,
                                             const T* xprev, long long n, long long nq,
                                             long long q0, int Lq, bool wide) {
  stage_planes(st, data, nd, n, nq, q0, Lq, wide);
  stage_rows(st + nd * 8 * Lq, Lq, x, data, nq, q0, Lq, wide);
  stage_rows(st + (nd + 1) * 8 * Lq, Lq, xprev, data, nq, q0, Lq, wide);
  copy_commit();
}

// Offset of diagonal d's source in a step buffer (row stride LS, G guard
// columns), for a thread of row r at window column 0.
__device__ __forceinline__ int diag_offset(int r, int o, int LS, int G) {
  const int src = r + o;
  return (src & 7) * LS + G + (src >> 3);  // >> 3 is floor(src / 8), also below 0
}

template <typename T, int NDM, int CPT>
__global__ void __launch_bounds__(THREADS)
    ilv_powers_reg(const T* __restrict__ data, DiaOffsets offs, int nd,
                   const T* __restrict__ x, const T* __restrict__ xprev, StepCoefs coefs,
                   int with_coefs, T* __restrict__ V, T* __restrict__ last, long long n, int s,
                   int tq, int hq, int G, int ntiles, int wide) {
  constexpr int LQ = ROW_LANES * CPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);  // (nd + 2) * 8 * LQ: stage_window
  const int LS = LQ + 2 * G;
  T* buf0 = st + (nd + 2) * 8 * LQ;  // w_j of even steps, 8 rows of LS
  T* buf1 = buf0 + 8 * LS;           // w_j of odd steps
  const long long nq = n / 8;
  const int r = threadIdx.x / ROW_LANES;
  const int l = threadIdx.x % ROW_LANES;

  int off[NDM];
#pragma unroll
  for (int d = 0; d < NDM; ++d) off[d] = diag_offset(r, d < nd ? offs.v[d] : 0, LS, G) + l;
  for (int e = threadIdx.x; e < 16 * LS; e += THREADS) buf0[e] = T(0);  // the guards

  const T* st_x = st + nd * 8 * LQ;
  const T* st_xp = st_x + 8 * LQ;
  int tile = blockIdx.x;
  if (tile < ntiles)
    stage_window(st, data, nd, x, xprev, n, nq, (long long)tile * tq - hq, LQ, wide != 0);
  T coef[NDM][CPT], cur[CPT], prv[CPT];
  for (; tile < ntiles; tile += gridDim.x) {
    copy_wait_all();
    __syncthreads();  // the staged tile is visible; the last tile's steps are done
    const long long q0 = (long long)tile * tq - hq;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = l + ROW_LANES * k;
#pragma unroll
      for (int d = 0; d < NDM; ++d) coef[d][k] = d < nd ? st[(d * 8 + r) * LQ + c] : T(0);
      cur[k] = st_x[r * LQ + c];
      prv[k] = st_xp[r * LQ + c];
    }
    __syncthreads();  // every thread has its copy: the buffer may be refilled
    if (tile + gridDim.x < ntiles)
      stage_window(st, data, nd, x, xprev, n, nq, (long long)(tile + gridDim.x) * tq - hq, LQ,
                   wide != 0);
#pragma unroll
    for (int k = 0; k < CPT; ++k) buf0[r * LS + G + l + ROW_LANES * k] = cur[k];
    __syncthreads();

    for (int j = 0; j < s; ++j) {
      const T* rd = (j & 1) ? buf1 : buf0;
      T* wr = (j & 1) ? buf0 : buf1;
      const T c0 = (T)coefs.v[2 * j];
      const T c1 = (T)coefs.v[2 * j + 1];
      T* out = V + (long long)j * n + (long long)r * nq;
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        T acc = T(0);
#pragma unroll
        for (int d = 0; d < NDM; ++d)
          if (d < nd) acc += coef[d][k] * rd[off[d] + ROW_LANES * k];
        const T nv = with_coefs ? acc - c0 * cur[k] - c1 * prv[k] : acc;
        prv[k] = cur[k];
        cur[k] = nv;
        const int c = l + ROW_LANES * k;
        wr[r * LS + G + c] = nv;
        if (c >= hq && c < hq + tq && q0 + c < nq) {
          out[q0 + c] = nv;
          if (j == s - 1) last[(long long)r * nq + q0 + c] = nv;
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ilv_powers_smem(const T* __restrict__ data, DiaOffsets offs, int nd,
                    const T* __restrict__ x, const T* __restrict__ xprev, StepCoefs coefs,
                    int with_coefs, T* __restrict__ V, T* __restrict__ last, long long n, int s,
                    int tq, int hq, int Lq, int wide) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);  // nd * 8 * Lq: the planes
  T* cur = st + nd * 8 * Lq;               // w_j, 8 rows of Lq
  T* oth = cur + 8 * Lq;                   // w_{j-1}, overwritten by w_{j+1}
  int* s_row = reinterpret_cast<int*>(oth + 8 * Lq);  // (8, nd) source row * Lq
  int* s_carry = s_row + 8 * nd;                      // (8, nd) carry
  const long long nq = n / 8;
  const long long q0 = (long long)blockIdx.x * tq - hq;
  const int r = threadIdx.x / ROW_LANES;
  const int l = threadIdx.x % ROW_LANES;

  stage_planes(st, data, nd, n, nq, q0, Lq, wide != 0);
  stage_rows(cur, Lq, x, data, nq, q0, Lq, wide != 0);
  stage_rows(oth, Lq, xprev, data, nq, q0, Lq, wide != 0);
  copy_commit();
  for (int e = threadIdx.x; e < 8 * nd; e += THREADS) {
    const int src = e / nd + offs.v[e % nd];
    s_row[e] = (src & 7) * Lq;
    s_carry[e] = src >> 3;
  }
  copy_wait_all();
  __syncthreads();

  const int* row = s_row + r * nd;
  const int* carry = s_carry + r * nd;
  for (int j = 0; j < s; ++j) {
    const T c0 = (T)coefs.v[2 * j];
    const T c1 = (T)coefs.v[2 * j + 1];
    T* out = V + (long long)j * n + (long long)r * nq;
    for (int c = l; c < Lq; c += ROW_LANES) {
      T acc = T(0);
      for (int d = 0; d < nd; ++d) {
        // a read past the window edge feeds only a halo column: clamp it
        const int qs = min(max(c + carry[d], 0), Lq - 1);
        acc += st[(d * 8 + r) * Lq + c] * cur[row[d] + qs];
      }
      const int e = r * Lq + c;
      const T nv = with_coefs ? acc - c0 * cur[e] - c1 * oth[e] : acc;
      oth[e] = nv;
      if (c >= hq && c < hq + tq && q0 + c < nq) {
        out[q0 + c] = nv;
        if (j == s - 1) last[(long long)r * nq + q0 + c] = nv;
      }
    }
    __syncthreads();
    T* t = cur;
    cur = oth;
    oth = t;
  }
}

// Shared memory of a launch: the staged planes and two step buffers;
// the register kernel adds the next tile's x and x_prev and the buffers'
// guard columns, the fallback its (8, nd) row and carry tables.
template <typename T>
size_t smem_bytes(int nd, int lq, int g, bool reg) {
  if (reg) return ((size_t)(nd + 2) * 8 * lq + (size_t)16 * (lq + 2 * g)) * sizeof(T);
  return ((size_t)nd * 8 * lq + (size_t)16 * lq) * sizeof(T) + (size_t)16 * nd * sizeof(int);
}

// The instantiated register kernels: (NDM, CPT) per dtype, mirrored by
// ops/cuda_ilv.py REG_CPT.  Null if (ndm, cpt) is not one of them.
template <typename T>
using RegKernel = void (*)(const T*, DiaOffsets, int, const T*, const T*, StepCoefs, int, T*,
                           T*, long long, int, int, int, int, int, int);

template <typename T>
RegKernel<T> reg_kernel(int ndm, int cpt) {
  constexpr bool f32 = sizeof(T) == 4;
  if (ndm == 3 && cpt == 4) return ilv_powers_reg<T, 3, 4>;
  if (ndm == 5 && cpt == 4) return ilv_powers_reg<T, 5, 4>;
  if (ndm == 9 && cpt == (f32 ? 4 : 2)) return ilv_powers_reg<T, 9, f32 ? 4 : 2>;
  if (ndm == 16 && cpt == 2) return ilv_powers_reg<T, 16, 2>;
  return nullptr;
}

template <typename T>
int ilv(const T* data, const int* offsets, int nd, const T* x, const T* xprev,
        const double* coefs, T* V, T* last, long long n, int s, int lq, int tq, int hq, int g,
        int reg, void* stream) {
  DiaOffsets o;
  StepCoefs c;
  if (!fill_params(offsets, nd, coefs, s, &o, &c) || s < 1 || tq < 1 || hq < 0 || g < 0 ||
      n % 8 || lq != tq + 2 * hq)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nd; ++i) {  // guards and halo must cover the widest diagonal
    const int mc = (abs(offsets[i]) + 7) / 8;
    if ((reg && mc > g) || hq < s * mc) return (int)cudaErrorInvalidValue;
  }
  const long long ntiles = (n / 8 + tq - 1) / tq;
  if (ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<T>(nd, lq, g, reg != 0);
  constexpr int VE = 16 / (int)sizeof(T);
  const int wide = (n / 8) % VE == 0 && tq % VE == 0 && hq % VE == 0 && lq % VE == 0 &&
                   ((uintptr_t)data | (uintptr_t)x | (uintptr_t)xprev) % 16 == 0;
  if (!reg)
    return launch_with_smem(ilv_powers_smem<T>, (int)ntiles, THREADS, bytes, stream, data, o,
                            nd, x, xprev, c, coefs != nullptr ? 1 : 0, V, last, n, s, tq, hq, lq,
                            wide);
  const int ndm = nd <= 3 ? 3 : nd <= 5 ? 5 : nd <= 9 ? 9 : nd <= 16 ? 16 : 0;
  const RegKernel<T> kernel = lq % ROW_LANES ? nullptr : reg_kernel<T>(ndm, lq / ROW_LANES);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  const int e = persistent_blocks(kernel, THREADS, bytes, ntiles, &blocks);
  if (e != 0) return e;
  kernel<<<blocks, THREADS, bytes, (cudaStream_t)stream>>>(data, o, nd, x, xprev, c,
                                                           coefs != nullptr ? 1 : 0, V, last,
                                                           n, s, tq, hq, g, (int)ntiles, wide);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dia_powers_ilv_f32(const float* data, const int* offsets, int nd, const float* x,
                       const float* xprev, const double* coefs, float* V, float* last,
                       long long n, int s, int lq, int tq, int hq, int g, int reg,
                       void* stream) {
  return ilv<float>(data, offsets, nd, x, xprev, coefs, V, last, n, s, lq, tq, hq, g, reg,
                    stream);
}

int dia_powers_ilv_f64(const double* data, const int* offsets, int nd, const double* x,
                       const double* xprev, const double* coefs, double* V, double* last,
                       long long n, int s, int lq, int tq, int hq, int g, int reg,
                       void* stream) {
  return ilv<double>(data, offsets, nd, x, xprev, coefs, V, last, n, s, lq, tq, hq, g, reg,
                     stream);
}

}  // extern "C"
