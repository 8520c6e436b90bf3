// Banded (DIA) matrix-powers kernels for Hopper (sm_90a): K1 and K2.
//
// K1 replaces ca_lanczos_tpu/ops/pallas_spmv.py `_dia_powers_fused`
// (pallas_call at :403).  It runs s steps of the three-term recurrence
//     w_{j+1}[i] = sum_d data[d,i] * w_j[i+off_d] - c[j,0] w_j[i] - c[j,1] w_{j-1}[i]
// with w_0 = x, w_{-1} = 0 and zero outside [0, n), and writes every
// step to V (s, n) and the last one again to `last` (n,).
//
// K2 `dia_power_step` replaces `_dia_step_kernel` / `_dia_power_step`
// (pallas_call at :113): one step y = sum_d data[d]*x[i+off_d] - c0 x - c1 v_prev.
//
// What bounds them on an H100: bytes.  A step does nd multiply-adds per
// row against nd+2 elements of traffic, far below the card's ~20 flop/byte
// (f32) balance point.  K2 streams the matrix once per step.  K1 makes the
// communication-avoiding trade of the TPU kernel: a tile of rows is
// computed from a window that adds a halo H >= s*max|off| on each side, so
// the planes and x are read from device memory once per s steps and only
// the owned rows of each step are written: (nd + 1 + s + 1) elements per
// row per call (bench.py's 4,194,304 rows x 9 diagonals, s = 8, f32: 319
// MB, 0.095 ms at 3.35 TB/s).  Halo rows are recomputed by both
// neighbours; their values go stale inward by max|off| per step, which the
// halo absorbs.
//
// K1's register kernel `dia_powers_reg<T, BW, QPT, RC>` (offsets inside
// +-BW, BW in {1, 2, 4, 8, 16}; repeated offsets allowed).  What it does
// about the four faults of the first port (one block per tile, everything
// in shared memory):
// - Shared-memory traffic.  A thread owns QPT vectors of RC consecutive
//   window rows (quads; pairs in f64 at BW = 16) for all s steps; its
//   plane coefficients, w_j and w_{j-1} live in registers.  A step reads
//   only the neighbours' w_j, as whole 16-byte vectors (ceil(BW/RC) a
//   side; its own vector comes from registers), and writes its new vector
//   as one 16-byte store, to one buffer of a ping-pong pair: one barrier
//   per step.  Picking a diagonal's value out of the vectors needs a
//   compile-time register index, so the coefficients are held per band
//   slot (2*BW + 1 per row, zero where the band has no diagonal; the host
//   maps offsets to slots, and the planes of a repeated offset are summed
//   into its slot when a tile's coefficients are loaded) rather than per
//   diagonal.  Zero guard vectors at both ends of each step buffer replace
//   the bounds test; they feed only halo rows.
// - Idle passes.  The window is RC * 256 * QPT rows, a whole number of
//   vectors for every thread; the halo is rounded up to a vector, so the
//   owned tile starts on one.
// - Unhidden staging.  The grid is persistent (as many blocks as fit) and
//   walks the tiles.  Once a tile's coefficients and x sit in registers,
//   the staging area is free, and cp.async copies bring the next tile's
//   planes and x window into it (16-byte pieces when n % 4 == 0, zero-
//   filled outside [0, n)) while the current tile runs its s steps.
// - Coefficients re-read every step: loaded once per tile into registers.
// Stores: when n % 4 == 0 and the arrays are 16-byte aligned, the owned
// rows of each step leave the step buffer in one bulk copy (sm_90
// cp.async.bulk, issued by one thread after the step's barrier) to V and,
// at the last step, to `last`; else each thread stores its owned rows.
// A band slot without a diagonal multiplies a finite neighbour by zero, so
// finite inputs give the plain recurrence's values; a non-finite input
// value spreads BW rather than max|off| rows a step.
//
// Measured on the H100 (PERF.md, chip_compare.py --k1-split): the kernel
// runs at 85-93% of the rate of a device copy that moves the same bytes,
// at bench.py's shape and at the tridiagonal main path's; a build without
// the steps' reads and arithmetic is no faster, so the steps hide behind
// the memory traffic, and the staging and the V stores share the time by
// their bytes.  Tried and dropped: staging with one bulk copy per array
// completing on an mbarrier (within 5% of cp.async either way), shortening
// the tiles so that every block of the persistent grid gets the same
// number (slower at three of four shapes), 4 quads a thread (slower, over
// 200 registers), and V stored by the threads (0.6 against 0.4 ms in f64
// on the tridiagonal path: two 16-byte stores a quad half-fill each sector).
//
// The wide-band kernel (plan variant "band", BW = 16: phase H's 31
// diagonals inside +-15) replaced the first port's kernel at those bands:
// that kept the planes and both vectors in shared memory, so its window
// stayed near the halo (1.1x to 2.9x the owned rows recomputed at s = 2
// to 16) and each multiply-add cost two shared-memory loads and a bounds
// test.  Here a row's 33 coefficients sit in registers (a quad's 132 in
// f32, a pair's in f64, where a quad's would need 264), so the window is
// 1024 rows in f32 and 512 in f64 with the halo s*max|off| a side, and a
// multiply-add costs about a quarter of a shared-memory load.  Each row's
// 33 multiply-adds run as two partial sums, and V leaves by thread stores:
// measured on the H100 (chip_compare.py --k1-split), bulk copies were
// slower here (0.69 against 0.62 ms at H's form, f32, s = 4; 1.45 against
// 1.36 ms at K(c)'s f64 shard), thread 0's wait on the copy unit before
// each step's barrier costing more than the heavier steps hide.  At s = 4
// the steps hide behind the staging (a build without them is no faster);
// at s = 16 they take about half the time.  Tried and dropped: each thread
// staging exactly the rows it reads, so that a tile starts without
// barriers (no faster at s = 4).
//
// `dia_powers_smem` is the first port's kernel, kept for the bands wider
// than +-16, a staging area past shared memory (many repeated offsets) or
// a halo that leaves a register window no tile: one tile per block, the
// planes and both vectors in shared memory.  K2's s launches are the last
// fallback (ops/cuda_spmv.py k1_plan decides).
//
// DIA_K1_DROP (0 in the library) builds timing variants of the register
// kernel that drop or replace one part: 1 never re-stages (every tile
// computes on the first tile's data), 2 skips the steps' shared-memory
// reads and arithmetic, 3 skips the V stores of steps 1..s-1, 4 stores V
// from the threads (one 16-byte store per quad, two in f64) instead of a
// bulk copy (chip_compare.py --k1-split times them).
//
// The Mosaic-specific parts of the TPU kernel are not carried over: no
// flat W-padded plane layout, no 1024-element alignment (the ragged edge
// is masked), no f64->f32 cast at the seam (both types are instantiated).
#include <stdint.h>

#include "dia_common.cuh"

#ifndef DIA_K1_DROP
#define DIA_K1_DROP 0
#endif

namespace {

constexpr int K1_THREADS = 256;
constexpr int K1_MAX_BW = 16;

// Register kernels: band slot b (offset b - BW) -> its first plane, or -1;
// next[d] -> the next plane with d's offset, or -1.  A repeated offset's
// planes are summed into their slot's coefficients when a tile is loaded.
struct BandSlots {
  int v[2 * K1_MAX_BW + 1];
  int next[DIA_MAX_DIAGS];
};

// Rows a register kernel holds per 16-byte vector: quads, except f64 at the
// widest band, where a quad's 4 * 33 coefficients would not fit in
// registers and a thread owns pairs.
template <typename T>
constexpr int reg_rows(int bw) {
  return bw > 8 && sizeof(T) == 8 ? 2 : 4;
}

// RC consecutive elements at a 16-byte aligned address: one 16-byte access
// (f32 quads, f64 pairs) or two (f64 quads).
__device__ __forceinline__ void loadv(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}

__device__ __forceinline__ void loadv(const double* p, double (&o)[4]) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ void loadv(const double* p, double (&o)[2]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  o[0] = a.x;
  o[1] = a.y;
}

__device__ __forceinline__ void storev(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void storev(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

__device__ __forceinline__ void storev(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// Rows g..g+RC-1 of an output (g >= 0): one vector store when `wide` (n %
// 4 == 0, so the vector lies wholly inside or outside [0, n)), else per
// element.
template <typename T, int RC>
__device__ __forceinline__ void putv(T* dst, long long g, long long n, const T (&v)[RC],
                                     bool wide) {
  if (wide) {
    if (g < n) storev(dst + g, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < RC; ++i)
    if (g + i < n) dst[g + i] = v[i];
}

// Stage window rows [w0, w0 + L) of the nd planes and of x into st[a*L + c]
// (plane a, x at a = nd), zero outside [0, n), as one cp.async commit
// group.  With `wide` (n and w0 multiples of 4, 16-byte aligned arrays)
// the copies are 16-byte pieces, each wholly inside or outside [0, n).
template <typename T, int L>
__device__ __forceinline__ void stage_tile(T* st, const T* data, int nd, const T* x,
                                           long long n, long long w0, bool wide) {
  constexpr int VE = 16 / (int)sizeof(T);
  for (int a = 0; a <= nd; ++a) {
    const T* src = a < nd ? data + (long long)a * n : x;
    T* dst = st + (size_t)a * L;
    if (wide) {
#pragma unroll
      for (int k = 0; k < L / (VE * K1_THREADS); ++k) {
        const int c = (threadIdx.x + k * K1_THREADS) * VE;
        const bool valid = w0 + c >= 0 && w0 + c < n;
        copy_async16(dst + c, valid ? src + w0 + c : data, valid);
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < L / K1_THREADS; ++k) {
        const int c = threadIdx.x + k * K1_THREADS;
        const bool valid = w0 + c >= 0 && w0 + c < n;
        copy_async(dst + c, valid ? src + w0 + c : data, valid);
      }
    }
  }
  copy_commit();
}

template <typename T, int BW, int QPT, int RC>
__global__ void __launch_bounds__(K1_THREADS)
    dia_powers_reg(const T* __restrict__ data, BandSlots slots, int nd, const T* __restrict__ x,
                   StepCoefs coefs, int with_coefs, T* __restrict__ V, T* __restrict__ last,
                   long long n, int s, int tile, int halo, int ntiles, int wide) {
  constexpr int L = RC * K1_THREADS * QPT;  // window rows
  constexpr int NB = 2 * BW + 1;            // band slots per row
  constexpr int R = (BW + RC - 1) / RC;     // neighbour vectors a side
  constexpr int G = RC * R;                 // guard rows a side of a step buffer
  constexpr int kDrop = DIA_K1_DROP;
  // V leaves in bulk copies, except at the wide band, whose heavier steps
  // do better without thread 0 waiting on the copy unit before each barrier
  const bool bulk = wide && kDrop != 4 && BW <= 8;
  // independent partial sums per row: the wide band's 33 multiply-adds a
  // row in two chains
  constexpr int NACC = NB > 17 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* st = reinterpret_cast<T*>(smem_raw);  // (nd + 1) * L: stage_tile
  T* buf0 = st + (size_t)(nd + 1) * L;     // w_j of even steps: G + L + G rows
  T* buf1 = buf0 + L + 2 * G;              // w_j of odd steps
  for (int e = threadIdx.x; e < 2 * G; e += K1_THREADS) {
    const int at = e < G ? e : L + e;  // the guards
    buf0[at] = T(0);
    buf1[at] = T(0);
  }

  int t = blockIdx.x;
  if (t < ntiles) stage_tile<T, L>(st, data, nd, x, n, (long long)t * tile - halo, wide != 0);
  T coef[QPT][NB][RC], cur[QPT][RC], prv[QPT][RC];
  for (; t < ntiles; t += gridDim.x) {
    copy_wait_all();
    if (bulk && threadIdx.x == 0) bulk_wait_read();  // the last tile's V copies read buf0/1
    __syncthreads();  // the staged tile is visible; the last tile's steps are done
    const long long w0 = (long long)t * tile - halo;
#pragma unroll
    for (int q = 0; q < QPT; ++q) {
      const int p = RC * (threadIdx.x + K1_THREADS * q);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int d = slots.v[b];
        if (d >= 0) {
          loadv(st + (size_t)d * L + p, coef[q][b]);
          for (int e = slots.next[d]; e >= 0; e = slots.next[e]) {  // a repeated offset
            T more[RC];
            loadv(st + (size_t)e * L + p, more);
#pragma unroll
            for (int i = 0; i < RC; ++i) coef[q][b][i] += more[i];
          }
        } else {
#pragma unroll
          for (int i = 0; i < RC; ++i) coef[q][b][i] = T(0);
        }
      }
      loadv(st + (size_t)nd * L + p, cur[q]);
#pragma unroll
      for (int i = 0; i < RC; ++i) prv[q][i] = T(0);
    }
    __syncthreads();  // every thread has its copy: the staging area may be refilled
    if (kDrop != 1 && t + (int)gridDim.x < ntiles)
      stage_tile<T, L>(st, data, nd, x, n, (long long)(t + gridDim.x) * tile - halo, wide != 0);
#pragma unroll
    for (int q = 0; q < QPT; ++q) storev(buf0 + G + RC * (threadIdx.x + K1_THREADS * q), cur[q]);
    __syncthreads();

    for (int j = 0; j < s; ++j) {
      const T* rd = (j & 1) ? buf1 : buf0;
      T* wr = (j & 1) ? buf0 : buf1;
      const T c0 = (T)coefs.v[2 * j];
      const T c1 = (T)coefs.v[2 * j + 1];
#pragma unroll
      for (int q = 0; q < QPT; ++q) {
        const int p = RC * (threadIdx.x + K1_THREADS * q);
        T nv[RC];
        if (kDrop == 2) {  // a timing build: no reads, no arithmetic
#pragma unroll
          for (int i = 0; i < RC; ++i) nv[i] = cur[q][i];
        } else {
          T nb[2 * R + 1][RC];  // window rows p - RC*R .. p + RC*R + RC - 1
#pragma unroll
          for (int r = 0; r < R; ++r) {
            loadv(rd + G + p - RC * (R - r), nb[r]);
            loadv(rd + G + p + RC * (r + 1), nb[R + 1 + r]);
          }
#pragma unroll
          for (int i = 0; i < RC; ++i) nb[R][i] = cur[q][i];
#pragma unroll
          for (int i = 0; i < RC; ++i) {
            T part[NACC];
#pragma unroll
            for (int a = 0; a < NACC; ++a) part[a] = T(0);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              const int k = RC * R + i + b - BW;  // row p + i + (b - BW)
              part[b % NACC] += coef[q][b][i] * nb[k / RC][k % RC];
            }
            T acc = part[0];
#pragma unroll
            for (int a = 1; a < NACC; ++a) acc += part[a];
            nv[i] = with_coefs ? acc - c0 * cur[q][i] - c1 * prv[q][i] : acc;
          }
          storev(wr + G + p, nv);
        }
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          prv[q][i] = cur[q][i];
          cur[q][i] = nv[i];
        }
        if (!bulk && p >= halo && p < halo + tile) {
          const long long g = w0 + p;
          if (kDrop != 3 || j == s - 1) putv<T, RC>(V + (long long)j * n, g, n, nv, wide != 0);
          if (j == s - 1) putv<T, RC>(last, g, n, nv, wide != 0);
        }
      }
      if (bulk) {
        fence_async_shared();  // this step's writes to wr are visible to the copy unit
        if (threadIdx.x == 0) bulk_wait_read();  // step j-1's copies have read what j+1 writes
      }
      __syncthreads();
      if (bulk && threadIdx.x == 0) {
        // the owned rows of step j leave in one copy per output
        const long long g0 = (long long)t * tile;
        const int bytes = (int)((n - g0 < tile ? n - g0 : tile) * (long long)sizeof(T));
        if (kDrop != 3 || j == s - 1) bulk_store(V + (long long)j * n + g0, wr + G + halo, bytes);
        if (j == s - 1) bulk_store(last + g0, wr + G + halo, bytes);
        bulk_commit();
      }
    }
  }
  if (bulk && threadIdx.x == 0) bulk_wait_all();
}

template <typename T>
__global__ void dia_powers_smem(const T* __restrict__ data, DiaOffsets offs, int nd,
                                const T* __restrict__ x, StepCoefs coefs, int with_coefs,
                                T* __restrict__ V, T* __restrict__ last, long long n, int s,
                                int tile, int halo) {
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

// The instantiated register kernels: band capacity BW in {1, 2, 4, 8} with
// quads per thread QPT in {1, 2}, and BW = 16 (the wide-band kernel) with
// one vector of reg_rows<T>(16) rows per thread; ops/cuda_spmv.py K1_REG
// picks one per element size and BW.  Null otherwise.
template <typename T>
using RegKernel = void (*)(const T*, BandSlots, int, const T*, StepCoefs, int, T*, T*,
                           long long, int, int, int, int, int);

template <typename T, int BW>
RegKernel<T> reg_kernel_bw(int qpt) {
  return qpt == 1 ? dia_powers_reg<T, BW, 1, 4> : qpt == 2 ? dia_powers_reg<T, BW, 2, 4> : nullptr;
}

template <typename T>
RegKernel<T> reg_kernel(int bw, int qpt) {
  switch (bw) {
    case 1: return reg_kernel_bw<T, 1>(qpt);
    case 2: return reg_kernel_bw<T, 2>(qpt);
    case 4: return reg_kernel_bw<T, 4>(qpt);
    case 8: return reg_kernel_bw<T, 8>(qpt);
    case 16: return qpt == 1 ? dia_powers_reg<T, 16, 1, reg_rows<T>(16)> : nullptr;
    default: return nullptr;
  }
}

// K1.  bw == 0: the shared-memory kernel, one block per tile of `tile`
// rows with a `halo` a side.  bw > 0: the register kernel of band capacity
// bw and qpt vectors of reg_rows<T>(bw) rows per thread, whose window tile
// + 2*halo must be reg_rows * K1_THREADS * qpt rows with tile and halo
// whole vectors.
template <typename T>
int fused(const T* data, const int* offsets, int nd, const T* x, const double* coefs, T* V,
          T* last, long long n, int s, int tile, int halo, int bw, int qpt, void* stream) {
  DiaOffsets o;
  StepCoefs c;
  if (!fill_params(offsets, nd, coefs, s, &o, &c) || s < 1 || n < 1 || tile < 1 || halo < 0)
    return (int)cudaErrorInvalidValue;
  int wmax = 0;
  for (int i = 0; i < nd; ++i) wmax = abs(offsets[i]) > wmax ? abs(offsets[i]) : wmax;
  const long long ntiles = (n + tile - 1) / tile;
  if (halo < s * wmax || ntiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int with_coefs = coefs != nullptr ? 1 : 0;
  if (bw == 0) {
    const size_t bytes = (size_t)(nd + 2) * (tile + 2 * halo) * sizeof(T);
    return launch_with_smem(dia_powers_smem<T>, (int)ntiles, 512, bytes, stream, data, o, nd,
                            x, c, with_coefs, V, last, n, s, tile, halo);
  }
  const RegKernel<T> kernel = reg_kernel<T>(bw, qpt);
  const int rc = reg_rows<T>(bw);
  const int L = tile + 2 * halo;
  if (kernel == nullptr || wmax > bw || tile % rc || halo % rc || L != rc * K1_THREADS * qpt)
    return (int)cudaErrorInvalidValue;
  BandSlots slots;
  for (int b = 0; b < 2 * K1_MAX_BW + 1; ++b) slots.v[b] = -1;
  for (int i = 0; i < nd; ++i) {
    slots.next[i] = -1;
    int* at = &slots.v[offsets[i] + bw];  // append plane i to its offset's chain
    while (*at >= 0) at = &slots.next[*at];
    *at = i;
  }
  const int G = rc * ((bw + rc - 1) / rc);
  const size_t bytes = ((size_t)(nd + 1) * L + 2 * (size_t)(L + 2 * G)) * sizeof(T);
  int blocks = 0;
  const int e = persistent_blocks(kernel, K1_THREADS, bytes, ntiles, &blocks);
  if (e != 0) return e;
  const int wide =
      n % 4 == 0 && ((uintptr_t)data | (uintptr_t)x | (uintptr_t)V | (uintptr_t)last) % 16 == 0;
  kernel<<<blocks, K1_THREADS, bytes, (cudaStream_t)stream>>>(
      data, slots, nd, x, c, with_coefs, V, last, n, s, tile, halo, (int)ntiles, wide);
  return (int)cudaGetLastError();
}

template <typename T>
int step(const T* data, const int* offsets, int nd, const T* x, const T* vprev,
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

}  // namespace

extern "C" {

int dia_powers_fused_f32(const float* data, const int* offsets, int nd, const float* x,
                         const double* coefs, float* V, float* last, long long n, int s,
                         int tile, int halo, int bw, int qpt, void* stream) {
  return fused<float>(data, offsets, nd, x, coefs, V, last, n, s, tile, halo, bw, qpt, stream);
}

int dia_powers_fused_f64(const double* data, const int* offsets, int nd, const double* x,
                         const double* coefs, double* V, double* last, long long n, int s,
                         int tile, int halo, int bw, int qpt, void* stream) {
  return fused<double>(data, offsets, nd, x, coefs, V, last, n, s, tile, halo, bw, qpt,
                       stream);
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
