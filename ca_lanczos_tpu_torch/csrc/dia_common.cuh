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

static inline bool fill_params(const int* offsets, int nd, const double* coefs, int s,
                               DiaOffsets* o, StepCoefs* c) {
  if (nd <= 0 || nd > DIA_MAX_DIAGS || s < 0 || s > DIA_MAX_STEPS) return false;
  for (int i = 0; i < nd; ++i) o->v[i] = offsets[i];
  for (int i = 0; i < 2 * s; ++i) c->v[i] = coefs ? coefs[i] : 0.0;
  return true;
}
