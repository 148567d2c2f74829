// Shared helpers of the port's hand-written kernels (plain C interface,
// loaded with ctypes by kai_scheduler_tpu_torch/kernels.py).
//
// Every kernel is compiled with --fmad=false and without fast math: the
// reference (JAX) rounds every product before the add, floor or compare
// that follows it, and these kernels must reproduce its f32 results bit
// for bit.  Booleans are torch.bool tensors: one byte, 0 or 1.
#pragma once
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <limits.h>
#include <stdint.h>

#define KAI_EXPORT extern "C" __attribute__((visibility("default")))

// negative return codes: arguments the kernel does not take (the Python
// wrappers check first; these guard direct callers)
#define KAI_ERR_ARGS (-1)

typedef unsigned char u8;

#define KAI_EPS 1e-6f
#define KAI_UNLIMITED_CUT (-0.5f)  // UNLIMITED (-1) + 0.5
#define KAI_BIG_NEG (-1e30f)

// (score desc, index asc) with -0.0 == +0.0: the first maximum of
// jnp.argmax over a score row
__device__ __forceinline__ bool kai_better(float a, int ia, float b, int ib) {
  return a > b || (a == b && ia < ib);
}

// (score desc, index asc) in the total order of f32, -0.0 below +0.0: the
// order of lax.top_k over a score row (XLA compares the scores'
// order-preserving integer keys)
__device__ __forceinline__ int kai_f32_key(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7FFFFFFF;
}
__device__ __forceinline__ bool kai_topk_better(float a, int ia, float b,
                                                int ib) {
  const int ka = kai_f32_key(a), kb = kai_f32_key(b);
  return ka > kb || (ka == kb && ia < ib);
}

// Python-style modulo (sign of the divisor), as jnp.mod on integers
__device__ __forceinline__ int kai_pymod(int x, int n) {
  int m = x % n;
  return m < 0 ? m + n : m;
}
