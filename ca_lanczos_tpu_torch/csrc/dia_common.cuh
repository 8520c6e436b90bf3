// Shared pieces of the banded (DIA) matrix-powers kernels.
//
// Offsets and per-step Newton coefficients travel by value in the kernel's
// parameter space (constant bank, read uniformly by every thread), so a
// launch needs no device allocation and no host-to-device copy.
#pragma once

#include <cuda_runtime.h>

#define DIA_MAX_DIAGS 128
#define DIA_MAX_STEPS 64

struct DiaOffsets {
  int v[DIA_MAX_DIAGS];
};

struct StepCoefs {
  double v[2 * DIA_MAX_STEPS];  // (s, 2) row-major: [shift, sub] per step
};

// Raise a kernel's dynamic shared-memory cap to `bytes` (needed above
// 48 KB), then launch; returns the first CUDA error of the two.
template <typename Kernel, typename... Args>
static int launch_with_smem(Kernel kernel, int blocks, int threads, size_t bytes,
                            void* stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, threads, bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// Blocks of a persistent grid: as many as fit on the card at once (the
// occupancy of `kernel` at `threads` and `bytes` of shared memory), at
// most `tiles`.  Raises the kernel's shared-memory cap first.  Returns a
// CUDA error, with *blocks set on success.
template <typename Kernel>
static int persistent_blocks(Kernel kernel, int threads, size_t bytes, long long tiles,
                             int* blocks) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = (int)(tiles < (long long)per_sm * sms ? tiles : (long long)per_sm * sms);
  return (int)cudaSuccess;
}

static inline bool fill_params(const int* offsets, int nd, const double* coefs, int s,
                               DiaOffsets* o, StepCoefs* c) {
  if (nd <= 0 || nd > DIA_MAX_DIAGS || s < 0 || s > DIA_MAX_STEPS) return false;
  for (int i = 0; i < nd; ++i) o->v[i] = offsets[i];
  for (int i = 0; i < 2 * s; ++i) c->v[i] = coefs ? coefs[i] : 0.0;
  return true;
}

// Device helpers: cp.async copies (K1, K3) and the sm_90 copy unit's bulk
// copies from shared to global memory (K1).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// One element global -> shared without passing through registers; src-size
// 0 writes a zero (PTX cp.async zero-fill).
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(sizeof(T)), "r"(valid ? (int)sizeof(T) : 0)
               : "memory");
}

// 16 bytes global -> shared (L1 bypassed); src-size 0 writes zeros.
__device__ __forceinline__ void copy_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared -> global copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) by the copy unit, in a bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until every committed bulk group has read its shared-memory source.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Wait until every committed bulk group has completed.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Order this thread's shared-memory writes before later bulk copies that
// read them (generic proxy -> async proxy).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
