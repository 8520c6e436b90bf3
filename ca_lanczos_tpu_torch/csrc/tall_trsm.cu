// Tall-skinny right triangular solve for Hopper (sm_90a): Y = X R^{-1}.
//
// X is an (n, k) block with n in the millions and k <= 64, R a small
// upper-triangular (k, k) matrix (the R factor of a CholQR pass, read on
// the device: ops/qr.py `_chol_safe` picks its branch there, so no host
// read).  Each row of Y is a forward substitution over the columns:
//     y_j = (x_j - sum_{i<j} y_i R_ij) / R_jj,
// in the block's own dtype, as the library's TRSM computes it; only the
// rounding order differs.  Only R's upper triangle is read.
//
// It replaces no TPU kernel: the JAX package leaves the solve to XLA
// (ca_lanczos_tpu/ops/qr.py:66, jax.scipy.linalg.solve_triangular).
// It replaces cuBLAS's `batch_trsm_right_kernel`, which the port's CholQR
// passes reached through torch.linalg.solve_triangular and which ran at
// 7% of the byte bound below on the fused solve's (11M, 9) f32 blocks.
//
// What bounds it on an H100: bytes.  One read and one write of the block,
// 2 k (4 or 8) bytes a row, against k^2 / 2 multiply-adds and k divisions
// a row.
//
// Design.  A block of TR threads owns a run of TR rows at a time (a
// persistent grid walks the runs), one row per thread, two runs in
// shared memory: the next run's copy is in flight while the block solves
// and stores the current one.
// * R's upper triangle is staged once per block into shared memory,
//   packed column by column, so the substitution reads R_ij at a
//   compile-time offset, the same address in every thread (a broadcast).
// * The row's k values live in registers (the loops run to the k bucket
//   KB, unrolled, and stop at k); the results go back into the thread's
//   own row in shared memory.
// * `tall_trsm_bulk`, for a contiguous row-major X (row stride k, 16-byte
//   aligned; the blocks of the solve's CholQR passes): a run is TR k
//   contiguous values, moved by the copy unit in one bulk copy each way
//   (global -> shared completing on an mbarrier, shared -> global after
//   the solve), so the threads issue no per-element loads or stores.
//   Each thread reads its row at stride k in 16-, 8- or 4-byte pieces,
//   the widest that the row divides into (conflict-free for an odd k).
// * `tall_trsm_strided`, for the other layouts it takes: a row-major X
//   with row stride > k, or a column-major X (the transposed view of a
//   (k, n) row-major basis, as the PELL powers return it).  Each element
//   is copied by cp.async, consecutive threads on consecutive addresses,
//   into rows at an odd stride (k, or k + 1 for an even k: free of bank
//   conflicts); the results leave in coalesced per-element stores.  The
//   copy and store loops stay rolled: each element's offsets are the same
//   in every run, and unrolled they were all kept in registers.
// Measured on the H100 at (11,010,048, 9) f32 (PERF.md): runs loaded
// through registers, one buffer: 48% of the bound (116 registers a thread,
// two blocks an SM); per-element cp.async, two buffers (the strided
// kernel): 60%.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dia_common.cuh"

namespace {

constexpr int MAX_K = 64;

// Rows a block owns: one a thread; fewer for wide rows so that the two
// staged runs and R stay near 48 KB of shared memory.
template <typename T, int KB>
__host__ __device__ constexpr int tile_rows() {
  return KB <= 16 ? 256 : KB <= 32 ? 128 : (sizeof(T) == 8 ? 32 : 64);
}

// Shared memory: two mbarriers, R's packed triangle, two run buffers of
// TR (KB + 1) values (16-byte aligned at every bucket).
template <typename T, int KB>
struct Smem {
  static constexpr int TR = tile_rows<T, KB>();
  static constexpr size_t BYTES =
      2 * sizeof(uint64_t) + (KB * (KB + 1) / 2 + 2 * TR * (KB + 1)) * sizeof(T);
  uint64_t* bar;
  T* r;  // R_ij (i <= j) at j (j + 1) / 2 + i
  T* buf;
  __device__ explicit Smem(unsigned char* p)
      : bar(reinterpret_cast<uint64_t*>(p)),
        r(reinterpret_cast<T*>(p + 2 * sizeof(uint64_t))),
        buf(r + KB * (KB + 1) / 2) {}
  __device__ T* run(int b) const { return buf + b * TR * (KB + 1); }
};

template <typename T>
__device__ __forceinline__ void stage_r(T* s_r, const T* __restrict__ r, long long rs0,
                                        long long rs1, int k) {
  for (int e = threadIdx.x; e < k * k; e += blockDim.x) {
    const int i = e / k, j = e - i * k;
    if (i <= j) s_r[j * (j + 1) / 2 + i] = r[i * rs0 + j * rs1];
  }
}

template <typename T, int KB>
__device__ __forceinline__ void solve_row(T (&v)[KB], const T* s_r, int k) {
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    if (j >= k) break;
    T acc = v[j];
#pragma unroll
    for (int i = 0; i < j; ++i) acc -= v[i] * s_r[j * (j + 1) / 2 + i];
    v[j] = acc / s_r[j * (j + 1) / 2 + j];
  }
}

template <typename T, int V>
struct alignas(V * sizeof(T)) Pack {
  T e[V];
};

// The thread's row: k values at s (V-aligned) into v and back, V values
// an access.
template <int V, typename T, int KB>
__device__ __forceinline__ void row_in(T (&v)[KB], const T* s, int k) {
#pragma unroll
  for (int j = 0; j < KB; j += V) {
    if (j >= k) break;
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(s + j);
#pragma unroll
    for (int i = 0; i < V; ++i) v[j + i] = p.e[i];
  }
}

template <int V, typename T, int KB>
__device__ __forceinline__ void row_out(const T (&v)[KB], T* s, int k) {
#pragma unroll
  for (int j = 0; j < KB; j += V) {
    if (j >= k) break;
    Pack<T, V> p;
#pragma unroll
    for (int i = 0; i < V; ++i) p.e[i] = v[j + i];
    *reinterpret_cast<Pack<T, V>*>(s + j) = p;
  }
}

// mbarrier and bulk copies (sm_90): one thread issues a run's copy,
// completion is counted in bytes on the buffer's mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned; 0 copies
// nothing) global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  if (bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void copy_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Contiguous row-major X: bulk copies of whole runs.  The last run may
// end off a 16-byte boundary: its tail (under 16 bytes) moves by plain
// loads and stores.
template <typename T, int KB>
__global__ void __launch_bounds__(tile_rows<T, KB>())
    tall_trsm_bulk(const T* __restrict__ x, const T* __restrict__ r, long long rs0, long long rs1,
                   T* __restrict__ y, long long n, int k) {
  constexpr int TR = tile_rows<T, KB>();
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T, KB> sm(smem);
  const int tid = threadIdx.x;
  stage_r(sm.r, r, rs0, rs1, k);
  if (tid == 0) {
    mbar_init(sm.bar);
    mbar_init(sm.bar + 1);
  }
  __syncthreads();
  const long long runs = (n + TR - 1) / TR;
  const int run_vals = TR * k;  // a multiple of 4: every run starts 16-byte aligned
  auto vals_of = [&](long long t) {
    return (int)(t == runs - 1 ? n * k - t * run_vals : run_vals);
  };
  auto body_of = [&](long long t) { return vals_of(t) * (int)sizeof(T) & ~15; };  // bytes
  const int row_bytes = k * (int)sizeof(T);

  long long t = blockIdx.x;
  if (tid == 0 && t < runs) bulk_load(sm.run(0), x + t * run_vals, body_of(t), sm.bar);
  unsigned phase = 0;  // bit b: the parity of buffer b's next completion
  for (int b = 0; t < runs; t += gridDim.x, b ^= 1) {
    T* s = sm.run(b);
    const long long tn = t + gridDim.x;
    if (tid == 0 && tn < runs) {
      bulk_wait_read();  // the store two runs back has read the other buffer
      bulk_load(sm.run(b ^ 1), x + tn * run_vals, body_of(tn), sm.bar + (b ^ 1));
    }
    const int vals = vals_of(t);
    const int body = body_of(t) / (int)sizeof(T);
    mbar_wait(sm.bar + b, (phase >> b) & 1);
    phase ^= 1u << b;
    if (body < vals) {  // the ragged tail of the last run
      if (tid < vals - body) s[body + tid] = x[t * run_vals + body + tid];
      __syncthreads();
    }
    if (tid * k < vals) {
      T v[KB];
      T* row = s + tid * k;
      if (row_bytes % 16 == 0)
        row_in<16 / sizeof(T)>(v, row, k);
      else if (row_bytes % 8 == 0)
        row_in<8 / sizeof(T)>(v, row, k);
      else
        row_in<1>(v, row, k);
      solve_row(v, sm.r, k);
      if (row_bytes % 16 == 0)
        row_out<16 / sizeof(T)>(v, row, k);
      else if (row_bytes % 8 == 0)
        row_out<8 / sizeof(T)>(v, row, k);
      else
        row_out<1>(v, row, k);
    }
    fence_async_shared();  // the rows just written are visible to the copy unit
    __syncthreads();
    if (tid == 0) {
      if (body > 0) bulk_store(y + t * run_vals, s, body * (int)sizeof(T));
      bulk_commit();
    }
    if (tid < vals - body) y[t * run_vals + body + tid] = s[body + tid];
  }
  if (tid == 0) bulk_wait_all();  // shared memory outlives the stores' reads
}

// Issue the cp.async copies of the run at row0 (rows of it, the last one
// ragged) into s: element (row, col) at s[row * kp + col].  Row-major:
// element e = tid + u TR of the run sits at (row, col) = divmod(e, k),
// and TR = q k + rem gives each next one without a division.
template <typename T, int KB>
__device__ __forceinline__ void stage_strided(T* s, const T* __restrict__ x, long long ldx,
                                              bool cols, long long row0, int rows, int k, int kp,
                                              int q, int rem, int row_t, int col_t) {
  constexpr int TR = tile_rows<T, KB>();
  const int tid = threadIdx.x;
  if (cols) {
    if (tid < rows) {
#pragma unroll 1
      for (int j = 0; j < k; ++j) copy_async(s + tid * kp + j, x + row0 + tid + j * ldx, true);
    }
    return;
  }
  const int cnt = rows * k;
  int rr = row_t, cc = col_t;
#pragma unroll 1
  for (int u = 0; u < k; ++u) {
    if (tid + u * TR < cnt) copy_async(s + rr * kp + cc, x + (row0 + rr) * ldx + cc, true);
    rr += q;
    cc += rem;
    if (cc >= k) {
      cc -= k;
      ++rr;
    }
  }
}

template <typename T, int KB>
__global__ void __launch_bounds__(tile_rows<T, KB>())
    tall_trsm_strided(const T* __restrict__ x, long long ldx, int cols, const T* __restrict__ r,
                      long long rs0, long long rs1, T* __restrict__ y, long long n, int k) {
  constexpr int TR = tile_rows<T, KB>();
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T, KB> sm(smem);
  const int tid = threadIdx.x;
  stage_r(sm.r, r, rs0, rs1, k);
  const int kp = k | 1;
  const int q = TR / k, rem = TR - q * k;
  const int row_t = tid / k, col_t = tid - row_t * k;
  const long long runs = (n + TR - 1) / TR;
  auto rows_of = [&](long long t) { return (int)(n - t * TR < TR ? n - t * TR : TR); };

  long long t = blockIdx.x;
  if (t < runs)
    stage_strided<T, KB>(sm.run(0), x, ldx, cols, t * TR, rows_of(t), k, kp, q, rem, row_t,
                         col_t);
  copy_commit();
  for (int b = 0; t < runs; t += gridDim.x, b ^= 1) {
    const long long tn = t + gridDim.x;
    if (tn < runs)
      stage_strided<T, KB>(sm.run(b ^ 1), x, ldx, cols, tn * TR, rows_of(tn), k, kp, q, rem,
                           row_t, col_t);
    copy_commit();
    copy_wait_prior();  // this thread's copies of run t have landed
    __syncthreads();    // everyone's (and R, on the first run)
    T* s = sm.run(b);
    const int rows = rows_of(t);
    if (tid < rows) {
      T v[KB];
      row_in<1>(v, s + tid * kp, k);
      solve_row(v, sm.r, k);
      row_out<1>(v, s + tid * kp, k);
    }
    __syncthreads();
    const int cnt = rows * k;
    T* out = y + t * TR * k;
    int rr = row_t, cc = col_t;
#pragma unroll 1
    for (int u = 0; u < k; ++u) {
      const int e = tid + u * TR;
      if (e < cnt) out[e] = s[rr * kp + cc];
      rr += q;
      cc += rem;
      if (cc >= k) {
        cc -= k;
        ++rr;
      }
    }
    __syncthreads();  // s is staged again two runs on
  }
}

template <typename T, int KB>
int launch_bucket(const T* x, long long ldx, int cols, const T* r, long long rs0, long long rs1,
                  T* y, long long n, int k, void* stream) {
  constexpr int TR = tile_rows<T, KB>();
  constexpr size_t bytes = Smem<T, KB>::BYTES;
  const long long runs = (n + TR - 1) / TR;
  int blocks = 0, e;
  if (!cols && ldx == k && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    e = persistent_blocks(tall_trsm_bulk<T, KB>, TR, bytes, runs, &blocks);
    if (e != 0) return e;
    tall_trsm_bulk<T, KB><<<blocks, TR, bytes, (cudaStream_t)stream>>>(x, r, rs0, rs1, y, n, k);
  } else {
    e = persistent_blocks(tall_trsm_strided<T, KB>, TR, bytes, runs, &blocks);
    if (e != 0) return e;
    tall_trsm_strided<T, KB>
        <<<blocks, TR, bytes, (cudaStream_t)stream>>>(x, ldx, cols, r, rs0, rs1, y, n, k);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int tall_trsm(const T* x, long long ldx, int cols, const T* r, long long rs0, long long rs1,
              T* y, long long n, int k, void* stream) {
  if (n < 1 || k < 1 || k > MAX_K || ldx < (cols ? n : (n > 1 ? k : 1)))
    return (int)cudaErrorInvalidValue;
  if (k <= 8) return launch_bucket<T, 8>(x, ldx, cols, r, rs0, rs1, y, n, k, stream);
  if (k <= 16) return launch_bucket<T, 16>(x, ldx, cols, r, rs0, rs1, y, n, k, stream);
  if (k <= 32) return launch_bucket<T, 32>(x, ldx, cols, r, rs0, rs1, y, n, k, stream);
  return launch_bucket<T, 64>(x, ldx, cols, r, rs0, rs1, y, n, k, stream);
}

}  // namespace

extern "C" {

// Y (n, k) row-major contiguous = X R^{-1}.  X: row-major with row stride
// ldx >= k (cols = 0), or column-major with column stride ldx >= n (cols
// = 1).  R: element (i, j) at r[i * rs0 + j * rs1].  Returns a CUDA error
// code: cudaErrorInvalidValue for n < 1, k outside [1, 64] or a short ldx.
int tall_trsm_f32(const float* x, long long ldx, int cols, const float* r, long long rs0,
                  long long rs1, float* y, long long n, int k, void* stream) {
  return tall_trsm<float>(x, ldx, cols, r, rs0, rs1, y, n, k, stream);
}

int tall_trsm_f64(const double* x, long long ldx, int cols, const double* r, long long rs0,
                  long long rs1, double* y, long long n, int k, void* stream) {
  return tall_trsm<double>(x, ldx, cols, r, rs0, rs1, y, n, k, stream);
}

}  // extern "C"
