// K5 cumsum_ds — compensated (double-single) prefix sum along axis 0.
//
// Replaces kai_scheduler_tpu/utils/numerics.py:30 `cumsum_ds`, which the
// victim solver runs over its [U, R] and [U, Q*R] per-unit tables
// (ops/victims.py:460, :481; U = the padded running-pod count).
//
// The reference is jax.lax.associative_scan with a two-sum combine; its
// bits depend on that function's recursion tree, which this kernel runs
// level by level:
//   up:   level l+1 [i] = combine(level l [2i], level l [2i+1]),
//         for i < floor(n_l / 2), until a level holds < 2 elements;
//   down: result_l[2i+1] = result_{l+1}[i];
//         result_l[2i]   = combine(result_{l+1}[i-1], level l [2i]) (i >= 1);
//         result_l[0]    = level l [0].
// combine((sa, ea), (sb, eb)) = (s, (e + ea) + eb) with (s, e) the
// two-sum of sa and sb.  The output is s + e.
//
// One block per column; the (s, e) pairs of levels >= 1 live in a global
// scratch of 2*U floats per column (U reaches 40k rows, beyond shared
// memory), each level's down-sweep runs in place (a thread reads only its
// own even slot and the next level's results), __syncthreads() between
// levels.  Level 0 is the input itself with e = +0.0.  Every + and - is
// kept as written: --fmad=false, no reassociation.
// Bound: bytes (each element read once and written once; ~20 flops each).
#include "kai_common.cuh"

#define CS_THREADS 1024

__device__ __forceinline__ void cs_combine(float sa, float ea, float sb,
                                           float eb, float* s_out,
                                           float* e_out) {
  const float s = __fadd_rn(sa, sb);
  const float bb = __fsub_rn(s, sa);
  const float err = __fadd_rn(__fsub_rn(sa, __fsub_rn(s, bb)),
                              __fsub_rn(sb, bb));
  *s_out = s;
  *e_out = __fadd_rn(__fadd_rn(err, ea), eb);
}

__global__ void cumsum_ds_kernel(const float* __restrict__ x, int U, int C,
                                 float* __restrict__ scratch,
                                 float* __restrict__ out) {
  const int c = blockIdx.x;
  float* s_buf = scratch + (size_t)c * 2 * U;
  float* e_buf = s_buf + U;
  // level offsets inside the column's scratch (level 1 at 0)
  int off[32];
  int len[32];
  int levels = 0;  // number of scratch levels (>= 1)
  {
    int n = U, o = 0;
    while (n >= 2 && levels < 31) {
      const int h = n / 2;
      off[levels] = o;
      len[levels] = h;
      o += h;
      n = h;
      ++levels;
    }
  }
  // ---- up-sweep --------------------------------------------------------
  for (int l = 0; l < levels; ++l) {
    const int h = len[l];
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      float sa, ea, sb, eb;
      if (l == 0) {
        sa = x[(size_t)(2 * i) * C + c];
        sb = x[(size_t)(2 * i + 1) * C + c];
        ea = 0.0f;
        eb = 0.0f;
      } else {
        const int p = off[l - 1];
        sa = s_buf[p + 2 * i];
        ea = e_buf[p + 2 * i];
        sb = s_buf[p + 2 * i + 1];
        eb = e_buf[p + 2 * i + 1];
      }
      cs_combine(sa, ea, sb, eb, &s_buf[off[l] + i], &e_buf[off[l] + i]);
    }
    __syncthreads();
  }
  // ---- down-sweep: scratch levels (deepest first), in place -------------
  // the deepest level holds < 2 elements: its scan is itself
  for (int l = levels - 2; l >= 0; --l) {
    const int n = len[l];
    const int o = off[l];
    const int nx = off[l + 1];
    const int pairs = (n + 1) / 2;
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const float s_even = s_buf[o + 2 * i];
      const float e_even = e_buf[o + 2 * i];
      if (i >= 1) {
        cs_combine(s_buf[nx + i - 1], e_buf[nx + i - 1], s_even, e_even,
                   &s_buf[o + 2 * i], &e_buf[o + 2 * i]);
      }
      if (2 * i + 1 < n) {
        s_buf[o + 2 * i + 1] = s_buf[nx + i];
        e_buf[o + 2 * i + 1] = e_buf[nx + i];
      }
    }
    __syncthreads();
  }
  // ---- level 0: the input, written out as s + e -------------------------
  const int pairs = (U + 1) / 2;
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
    const float s_even = x[(size_t)(2 * i) * C + c];
    float s = s_even, e = 0.0f;
    if (i >= 1) cs_combine(s_buf[i - 1], e_buf[i - 1], s_even, 0.0f, &s, &e);
    out[(size_t)(2 * i) * C + c] = __fadd_rn(s, e);
    if (2 * i + 1 < U) {
      out[(size_t)(2 * i + 1) * C + c] = __fadd_rn(s_buf[i], e_buf[i]);
    }
  }
}

KAI_EXPORT int kai_cumsum_ds(const float* x, int U, int C, float* scratch,
                             float* out, cudaStream_t stream) {
  if (U < 1 || C < 1) return KAI_ERR_ARGS;
  cumsum_ds_kernel<<<C, CS_THREADS, 0, stream>>>(x, U, C, scratch, out);
  return static_cast<int>(cudaGetLastError());
}
