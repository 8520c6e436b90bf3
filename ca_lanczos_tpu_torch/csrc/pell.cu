// General-sparsity (PELL) step kernels for Hopper (sm_90a): K4 and K5.
//
// Both compute one step of the three-term recurrence on a PELL operator
// (ca_lanczos_tpu_torch/ops/pell.py describes the planes):
//     y[row] = sum_u vals[u, row] * x[col(u, row)] - d * x[row] - sb * v_prev[row]
// for every row < n_pad; x and v_prev are zero-padded to n_x.
//
// K4 `pell_unit_kernel` replaces ca_lanczos_tpu/ops/pell.py `_pell_kernel`
// (pallas_call at :1030 through `_pell_step`, enc="unit"): slot u of a
// 128-row group is bound to one chunk, cbase[t, b*K+u]; lidx (int8) holds
// each element's lane.
// K5 `pell_grouped_kernel<NW, SP>` replaces `_pell_kernel_g2` (the same
// pallas_call, enc in GROUPED_GEOM; NW=2, SP=4 is "grouped", NW=4, SP=2
// "grouped4"): each element carries an int16 sub<<7 | lane, and the sub
// that places it is stored at its SOURCE lane of the same slot row.
//
// Decoding follows PellMatrix.to_dense: scratch-relative chunk scr,
// (w, rel) = divmod(scr, SR), col = (span_row[t, w] + rel) * 128 + lane.
// w >= W can only come from a zero padding entry; it is clamped to the
// last window so every x read stays inside n_x.
//
// What bounds them on an H100: bytes.  Per slot and row a step reads one
// value (4 or 8 B) and one index (1 or 2 B) and does one multiply-add;
// the planes dominate the traffic (at 11M rows, K=16 grouped: 1.06 GB of
// planes against 0.13 GB of vectors).  The TPU kernels' x-span staging (W
// windows of SW elements double-buffered in VMEM) is not carried over: SW
// can be 64K elements and W up to 16, far past shared memory, so x is
// gathered from global memory through L1/L2 (an 11M-row f32 x is 44 MB,
// inside the 50 MB L2); the planes, read once, are loaded with the
// streaming (evict-first) hint so that they do not push x out of L2.
//
// K4 design.  The unit encoder gives a group's units the ordinals 0..u-1,
// so its unused slots are a trailing run of zeros: at 11M rows a group
// fills ~20 of its K = 32 slots.  `slot_count[g]` (PellMatrix.slot_count)
// bounds the slot loop, so those bytes are never read.  One block of 128
// threads per 128-row group, one row per thread (so that ~32 registers
// leave the SM full of warps to hide the gathers' latency); the first
// `cnt` threads decode one slot's window base each (the division by SR)
// into shared memory, so the slot loop adds the lane and does no division;
// the loop is unrolled by 4, so each thread keeps 4 value/index loads in
// flight before their gathers.  Measured on the H100 at 11M rows, the full
// SM of small blocks is what hides the latency: one warp per group with 4
// rows a lane (~100 registers), a cp.async ring of staged slabs, or an
// 8-deep unroll (~100 registers) were each slower (PERF.md).
//
// K5 design.  Any encoding's slots past `slot_count[g]` hold zero values,
// and an element's sub sits at its source lane of the SAME slot row, so
// the prefix of `cnt` slots is all the step needs: at 11M rows a grouped
// group occupies ~12 of its K = 16 slots.  One block of 128 threads per
// 128-row group, one row per thread (at most 32 registers, so 16 blocks
// fill an SM).  Thread 0 stages the prefix's rows of vals and idx (512 B /
// 1 KB and 256 B each, 16 rows a pass) into shared memory with one bulk
// copy per row, all in flight at once, evict-first in L2, completing on an
// mbarrier.  Meanwhile the other warps decode the 8 (window, sub) x
// offsets of every slot-tile once (the division by SR happens there; all
// K / 8 slot-tiles, so that these loads do not wait for the count), so
// that an element's x index is base[slot-tile][sub] + lane.  Measured on
// the H100 at 11M rows (chip_compare.py): the same prefix read by per-
// thread loads (four slots in flight, 40 registers: 12 blocks an SM)
// reached 66% of the prefix's bound in f32; the bulk staging 74%, and 81%
// once the base loads no longer waited for the count (f64: 83%).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int SLOTS = 8;
constexpr int GROUPED_CHUNK = 16;  // K5: slot rows staged per pass

template <typename T>
__global__ void __launch_bounds__(LANES)
    pell_unit_kernel(const T* __restrict__ vals, const int8_t* __restrict__ lidx,
                     const int* __restrict__ cbase, const int* __restrict__ span_row,
                     const int* __restrict__ slot_count, const T* __restrict__ x,
                     const T* __restrict__ vprev, T d, T sb, T* __restrict__ y, int tile, int K,
                     int sr, int W) {
  extern __shared__ int s_base[];  // x offset of each occupied slot's chunk
  const int B = tile / LANES;
  const long long g = blockIdx.x;  // group; row t of cbase holds its B groups' K bindings
  const long long t = g / B;
  const int b = (int)(g - t * B);
  const int r = threadIdx.x;
  const int cnt = min(slot_count[g], K);
  for (int u = r; u < cnt; u += LANES) {
    const int scr = cbase[g * K + u];
    int w = scr / sr;
    const int rel = scr - w * sr;
    if (w >= W) w = W - 1;
    s_base[u] = (span_row[t * W + w] + rel) * LANES;
  }
  __syncthreads();

  const long long e0 = t * K * tile + (long long)b * LANES + r;
  const T* vr = vals + e0;
  const int8_t* lr = lidx + e0;
  T acc = T(0);
  int u = 0;
  for (; u + 4 <= cnt; u += 4) {
    T v[4];
    int l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = __ldcs(vr + (long long)(u + j) * tile);
      l[j] = __ldcs(lr + (long long)(u + j) * tile);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc += v[j] * __ldg(x + s_base[u + j] + l[j]);
  }
  for (; u < cnt; ++u)
    acc += __ldcs(vr + (long long)u * tile) * __ldg(x + s_base[u] + __ldcs(lr + (long long)u * tile));
  const long long row = t * tile + (long long)b * LANES + r;
  T out = acc - d * x[row];
  if (vprev != nullptr) out -= sb * vprev[row];
  y[row] = out;
}

// Shared-memory barrier and bulk copies (sm_90) for K5's staging: one
// thread issues a copy per plane row, completion is counted in bytes on
// an mbarrier.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared, evict-first in L2, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

template <typename T, int NW, int SP>
__global__ void __launch_bounds__(LANES, 16)
    pell_grouped_kernel(const T* __restrict__ vals, const int16_t* __restrict__ idx,
                        const int* __restrict__ cbase, const int* __restrict__ span_row,
                        const int* __restrict__ slot_count, const T* __restrict__ x,
                        const T* __restrict__ vprev, T d, T sb, T* __restrict__ y, int tile,
                        int K, int sr, int W, int chunk) {
  static_assert(NW * SP == SLOTS, "NW windows of spread SP cover one slot-tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_vals = reinterpret_cast<T*>(smem_raw);                 // chunk slot rows of vals
  int16_t* s_idx = reinterpret_cast<int16_t*>(s_vals + chunk * LANES);  // ... and of idx
  int* s_base = reinterpret_cast<int*>(s_idx + chunk * LANES);  // x offset per (slot-tile, sub)
  int* s_span = s_base + K;                                       // the tile's W window starts
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_span + ((W + 1) & ~1));
  const int B = tile / LANES;
  const long long g = blockIdx.x;  // group; row t of cbase holds its B groups' bases
  const long long t = g / B;
  const int b = (int)(g - t * B);
  const int r = threadIdx.x;
  const int cnt = min(slot_count[g], K);
  const long long row = t * tile + (long long)b * LANES + r;
  const long long e0 = t * K * tile + (long long)b * LANES;  // the group's slot 0
  // one pass stages slot rows [u0, u1) of vals and idx (thread 0)
  uint64_t policy = 0;
  auto stage = [&](int u0, int u1) {
    mbar_expect(bar, (unsigned)((u1 - u0) * LANES * (sizeof(T) + sizeof(int16_t))));
    for (int u = u0; u < u1; ++u) {
      bulk_load(s_vals + (u - u0) * LANES, vals + e0 + (long long)u * tile, LANES * sizeof(T),
                bar, policy);
      bulk_load(s_idx + (u - u0) * LANES, idx + e0 + (long long)u * tile,
                LANES * sizeof(int16_t), bar, policy);
    }
  };
  if (r == 0) {
    if (cnt > 0) {
      mbar_init(bar);
      asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
      stage(0, min(cnt, chunk));
    }
  } else if (r >= 32) {
    // warps 1-3, waiting for no count: every slot-tile's scratch-relative
    // chunks and the tile's window starts
    const int* cb = cbase + g * (K / SLOTS) * NW;
    for (int i = r - 32; i < K || i < W; i += LANES - 32) {
      const int scr = i < K ? cb[i / SLOTS * NW + i % SLOTS / SP] + i % SLOTS % SP : 0;
      const int start = i < W ? span_row[t * W + i] : 0;
      if (i < K) s_base[i] = scr;
      if (i < W) s_span[i] = start;
    }
  }
  __syncthreads();  // the chunks, window starts and the barrier's initialisation are visible
  for (int i = r; i < K; i += LANES) {  // the x offsets
    const int scr = s_base[i];
    int w = scr / sr;
    const int rel = scr - w * sr;
    if (w >= W) w = W - 1;
    s_base[i] = (s_span[w] + rel) * LANES;
  }
  __syncthreads();
  T acc = T(0);
  for (int u0 = 0, pass = 0; u0 < cnt; u0 += chunk, ++pass) {
    const int u1 = min(cnt, u0 + chunk);
    mbar_wait(bar, pass & 1);
#pragma unroll 8
    for (int u = u0; u < u1; ++u) {
      const int16_t* rw = s_idx + (u - u0) * LANES;
      const int lane = rw[r] & 127;
      const int sub = (rw[lane] >> 7) & 7;  // stored at the source lane
      acc += s_vals[(u - u0) * LANES + r] * __ldg(x + s_base[(u & ~(SLOTS - 1)) + sub] + lane);
    }
    if (u1 < cnt) {
      __syncthreads();  // every thread is done with this pass's rows
      if (r == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        stage(u1, min(cnt, u1 + chunk));
      }
    }
  }
  T out = acc - d * x[row];
  if (vprev != nullptr) out -= sb * vprev[row];
  y[row] = out;
}

bool bad_shape(int ntiles, int tile, int K, int sr, int W) {
  return ntiles < 1 || tile < LANES || tile % LANES || K < SLOTS || K % SLOTS || sr < 1 ||
         W < 1 || (long long)ntiles * (tile / LANES) > 0x7fffffffLL;
}

template <typename T>
int unit(const T* vals, const int8_t* lidx, const int* cbase, const int* span_row,
         const int* slot_count, const T* x, const T* vprev, double d, double sb, T* y,
         int ntiles, int tile, int K, int sr, int W, void* stream) {
  // x offsets are 32-bit: every chunk * 128 + lane must stay below 2^31
  if (bad_shape(ntiles, tile, K, sr, W) ||
      (long long)ntiles * tile + (long long)sr * LANES >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)K * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = ntiles * (tile / LANES);
  pell_unit_kernel<T><<<blocks, LANES, smem, (cudaStream_t)stream>>>(
      vals, lidx, cbase, span_row, slot_count, x, vprev, (T)d, (T)sb, y, tile, K, sr, W);
  return (int)cudaGetLastError();
}

template <typename T>
int grouped(const T* vals, const int16_t* idx, const int* cbase, const int* span_row,
            const int* slot_count, const T* x, const T* vprev, double d, double sb, T* y,
            int ntiles, int tile, int K, int sr, int W, int nw, void* stream) {
  if (bad_shape(ntiles, tile, K, sr, W) || (nw != 2 && nw != 4) ||
      (long long)ntiles * tile + (long long)sr * LANES >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // slot rows staged per pass: all K for the usual K <= 16; bulk copies
  // need 16-byte aligned planes
  const int chunk = K < GROUPED_CHUNK ? K : GROUPED_CHUNK;
  const size_t smem = (size_t)chunk * LANES * (sizeof(T) + sizeof(int16_t)) +
                      (size_t)(K + ((W + 1) & ~1)) * sizeof(int) + sizeof(uint64_t);
  if (smem > 48 * 1024 || ((uintptr_t)vals | (uintptr_t)idx) % 16)
    return (int)cudaErrorInvalidValue;
  const int blocks = ntiles * (tile / LANES);
  if (nw == 2)
    pell_grouped_kernel<T, 2, 4><<<blocks, LANES, smem, (cudaStream_t)stream>>>(
        vals, idx, cbase, span_row, slot_count, x, vprev, (T)d, (T)sb, y, tile, K, sr, W,
        chunk);
  else
    pell_grouped_kernel<T, 4, 2><<<blocks, LANES, smem, (cudaStream_t)stream>>>(
        vals, idx, cbase, span_row, slot_count, x, vprev, (T)d, (T)sb, y, tile, K, sr, W,
        chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pell_unit_f32(const float* vals, const int8_t* lidx, const int* cbase, const int* span_row,
                  const int* slot_count, const float* x, const float* vprev, double d,
                  double sb, float* y, int ntiles, int tile, int K, int sr, int W,
                  void* stream) {
  return unit<float>(vals, lidx, cbase, span_row, slot_count, x, vprev, d, sb, y, ntiles, tile,
                     K, sr, W, stream);
}

int pell_unit_f64(const double* vals, const int8_t* lidx, const int* cbase,
                  const int* span_row, const int* slot_count, const double* x,
                  const double* vprev, double d, double sb, double* y, int ntiles, int tile,
                  int K, int sr, int W, void* stream) {
  return unit<double>(vals, lidx, cbase, span_row, slot_count, x, vprev, d, sb, y, ntiles,
                      tile, K, sr, W, stream);
}

int pell_grouped_f32(const float* vals, const int16_t* idx, const int* cbase,
                     const int* span_row, const int* slot_count, const float* x,
                     const float* vprev, double d, double sb, float* y, int ntiles, int tile,
                     int K, int sr, int W, int nw, void* stream) {
  return grouped<float>(vals, idx, cbase, span_row, slot_count, x, vprev, d, sb, y, ntiles,
                        tile, K, sr, W, nw, stream);
}

int pell_grouped_f64(const double* vals, const int16_t* idx, const int* cbase,
                     const int* span_row, const int* slot_count, const double* x,
                     const double* vprev, double d, double sb, double* y, int ntiles, int tile,
                     int K, int sr, int W, int nw, void* stream) {
  return grouped<double>(vals, idx, cbase, span_row, slot_count, x, vprev, d, sb, y, ntiles,
                         tile, K, sr, W, nw, stream);
}

}  // extern "C"
