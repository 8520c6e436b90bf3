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
// K5 (the same block shape) stages each (8, 128) slot-tile of its index
// plane in shared memory, because an element's sub is read at another
// thread's position.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int SLOTS = 8;

__device__ __forceinline__ long long column(int scr, int sr, int W, const int* span,
                                            int lane) {
  int w = scr / sr;
  const int rel = scr - w * sr;
  if (w >= W) w = W - 1;
  return (long long)(span[w] + rel) * LANES + lane;
}

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

template <typename T, int NW, int SP>
__global__ void __launch_bounds__(LANES)
    pell_grouped_kernel(const T* __restrict__ vals, const int16_t* __restrict__ idx,
                        const int* __restrict__ cbase, const int* __restrict__ span_row,
                        const T* __restrict__ x, const T* __restrict__ vprev, T d, T sb,
                        T* __restrict__ y, int tile, int K, int sr, int W) {
  static_assert(NW * SP == SLOTS, "NW windows of spread SP cover one slot-tile");
  extern __shared__ int smem[];
  __shared__ int16_t s_idx[SLOTS][LANES];  // one slot-tile of the index plane
  const int KT = K / SLOTS;
  int* s_cb = smem;            // KT*NW window bases of this group
  int* s_span = smem + KT * NW; // W window starts of this tile
  const int B = tile / LANES;
  const long long t = blockIdx.x / B;
  const int b = blockIdx.x % B;
  const int r = threadIdx.x;
  for (int i = r; i < KT * NW; i += LANES)
    s_cb[i] = cbase[t * B * KT * NW + (long long)b * KT * NW + i];
  for (int i = r; i < W; i += LANES) s_span[i] = span_row[t * W + i];

  const long long e0 = t * K * tile + (long long)b * LANES + r;
  T acc = T(0);
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();  // the previous slot-tile's reads (and the table loads) are done
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) s_idx[j][r] = idx[e0 + (long long)(kt * SLOTS + j) * tile];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int code = s_idx[j][r];
      const int lane = code & 127;
      const int sub = (s_idx[j][lane] >> 7) & 7;  // stored at the source lane
      const int scr = s_cb[kt * NW + sub / SP] + sub % SP;
      acc += vals[e0 + (long long)(kt * SLOTS + j) * tile] *
             x[column(scr, sr, W, s_span, lane)];
    }
  }
  const long long row = t * tile + (long long)b * LANES + r;
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
            const T* x, const T* vprev, double d, double sb, T* y, int ntiles, int tile, int K,
            int sr, int W, int nw, void* stream) {
  if (bad_shape(ntiles, tile, K, sr, W) || (nw != 2 && nw != 4))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(K / SLOTS * nw + W) * sizeof(int);
  if (smem > 40 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = ntiles * (tile / LANES);
  if (nw == 2)
    pell_grouped_kernel<T, 2, 4><<<blocks, LANES, smem, (cudaStream_t)stream>>>(
        vals, idx, cbase, span_row, x, vprev, (T)d, (T)sb, y, tile, K, sr, W);
  else
    pell_grouped_kernel<T, 4, 2><<<blocks, LANES, smem, (cudaStream_t)stream>>>(
        vals, idx, cbase, span_row, x, vprev, (T)d, (T)sb, y, tile, K, sr, W);
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
                     const int* span_row, const float* x, const float* vprev, double d,
                     double sb, float* y, int ntiles, int tile, int K, int sr, int W, int nw,
                     void* stream) {
  return grouped<float>(vals, idx, cbase, span_row, x, vprev, d, sb, y, ntiles, tile, K, sr, W,
                        nw, stream);
}

int pell_grouped_f64(const double* vals, const int16_t* idx, const int* cbase,
                     const int* span_row, const double* x, const double* vprev, double d,
                     double sb, double* y, int ntiles, int tile, int K, int sr, int W, int nw,
                     void* stream) {
  return grouped<double>(vals, idx, cbase, span_row, x, vprev, d, sb, y, ntiles, tile, K, sr,
                         W, nw, stream);
}

}  // extern "C"
