// K7 replace_victims — sequential greedy re-placement of a consolidation
// scenario's victims (the allPodsReallocated validator).
//
// Replaces kai_scheduler_tpu/ops/victims.py:644 `_replace_victims`, the
// reference's lax.fori_loop over the first K = max(1, min(M, max_pods))
// victims in nonzero order.  One CTA per call; per victim:
//   1. every thread tests its nodes: resources + EPS against the pod's
//      request over free + releasing, node validity, the pod's filter
//      class row, extended scalars, and either the fractional share (the
//      best device's free + releasing share against the node-relative
//      portion) or the whole devices (count of devices >= 1 - EPS);
//   2. a block argmax of -avail[:, accel] over fitting nodes, the LOWEST
//      node index on ties (jnp.argmax's rule); nothing fits -> node 0,
//      placed = false;
//   3. thread 0 debits the node's resources, extended scalars and
//      devices (a fraction joins its best device, the first such on ties;
//      whole devices take the first fully free ones up to round(req[0])).
// Only the n_vic real victims are visited: the reference's iterations
// past n_vic add -0.0 everywhere and leave `moves` as it was (its own
// note at :721-726), so skipping them changes no bit.  all_ok starts as
// n_vic <= K.  The wrapper copies the pools into the outputs and fills
// `moves` with -1 first; the kernel updates them in place.
// Bound: bytes (per victim, one pass over the node pools).
#include "kai_common.cuh"

#define RV_THREADS 1024

__global__ void replace_victims_kernel(
    const int* __restrict__ idxs, const int* __restrict__ n_vic_p, int K,
    const float* __restrict__ req, const int* __restrict__ device,
    const float* __restrict__ accel_mem, const float* __restrict__ held,
    const int* __restrict__ filter_class, const float* __restrict__ extended,
    const float* __restrict__ dev_mem, const u8* __restrict__ valid,
    const u8* __restrict__ fmask, const float* __restrict__ releasing,
    const float* __restrict__ dev_releasing,
    const float* __restrict__ ext_releasing, int N, int R, int D, int E,
    float* __restrict__ free_, float* __restrict__ dev,
    float* __restrict__ ext, int* __restrict__ moves, u8* __restrict__ all_ok) {
  __shared__ float s_score[RV_THREADS / 32];
  __shared__ int s_idx[RV_THREADS / 32];
  __shared__ int s_node;
  const float one_m_eps = (float)(1.0 - 1e-6);
  const int n_vic = *n_vic_p;
  const int loops = n_vic < K ? n_vic : K;
  bool ok = n_vic <= K;
  for (int kk = 0; kk < loops; ++kk) {
    const int m = idxs[kk];
    const bool is_frac = device[m] >= 0;
    const float mem = accel_mem[m];
    const int cls = filter_class[m];
    // ---- 1. fit + score per node, thread-local best -----------------------
    float best = -INFINITY;
    int best_i = INT_MAX;
    int any = 0;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      bool fit = valid[n] && fmask[(size_t)cls * N + n];
      float avail0 = 0.0f;
      for (int r = 0; r < R; ++r) {
        const float a = __fadd_rn(free_[(size_t)n * R + r],
                                  releasing[(size_t)n * R + r]);
        if (r == 0) avail0 = a;
        fit = fit && (__fadd_rn(a, KAI_EPS) >= req[(size_t)m * R + r]);
      }
      for (int x = 0; x < E; ++x) {
        const float a = __fadd_rn(__fadd_rn(ext[(size_t)n * E + x],
                                            ext_releasing[(size_t)n * E + x]),
                                  KAI_EPS);
        fit = fit && (a >= extended[(size_t)m * E + x]);
      }
      const float p_n =
          mem > 0.0f ? __fdiv_rn(mem, fmaxf(dev_mem[n], KAI_EPS)) : held[m];
      float dmax = -INFINITY, whole = 0.0f;
      for (int d = 0; d < D; ++d) {
        const float da = __fadd_rn(dev[(size_t)n * D + d],
                                   dev_releasing[(size_t)n * D + d]);
        dmax = fmaxf(dmax, da);
        whole = __fadd_rn(whole, da >= one_m_eps ? 1.0f : 0.0f);
      }
      const bool frac_fit = dmax >= __fsub_rn(p_n, KAI_EPS);
      const bool whole_fit = __fadd_rn(whole, KAI_EPS) >= req[(size_t)m * R];
      fit = fit && (is_frac ? frac_fit : whole_fit);
      const float score = fit ? -avail0 : -INFINITY;
      any |= fit ? 1 : 0;
      if (kai_better(score, n, best, best_i)) {
        best = score;
        best_i = n;
      }
    }
    // ---- 2. block argmax (score desc, index asc) --------------------------
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_down_sync(0xffffffffu, best, o);
      const int i2 = __shfl_down_sync(0xffffffffu, best_i, o);
      if (kai_better(s2, i2, best, best_i)) {
        best = s2;
        best_i = i2;
      }
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
      s_score[warp] = best;
      s_idx[warp] = best_i;
    }
    const int placed = __syncthreads_or(any);
    if (threadIdx.x == 0) {
      float b = s_score[0];
      int bi = s_idx[0];
      for (int w = 1; w < (int)(blockDim.x / 32); ++w) {
        if (kai_better(s_score[w], s_idx[w], b, bi)) {
          b = s_score[w];
          bi = s_idx[w];
        }
      }
      s_node = bi < N ? bi : 0;
    }
    __syncthreads();
    // ---- 3. debits --------------------------------------------------------
    if (threadIdx.x == 0) {
      const int node = s_node;
      if (placed) {
        const float p = mem > 0.0f
                            ? __fdiv_rn(mem, fmaxf(dev_mem[node], KAI_EPS))
                            : held[m];
        for (int r = 0; r < R; ++r) {
          const float dl = r == 0 ? (is_frac ? p : req[(size_t)m * R])
                                  : req[(size_t)m * R + r];
          free_[(size_t)node * R + r] = __fadd_rn(free_[(size_t)node * R + r],
                                                  -dl);
        }
        for (int x = 0; x < E; ++x) {
          ext[(size_t)node * E + x] = __fadd_rn(
              ext[(size_t)node * E + x], -extended[(size_t)m * E + x]);
        }
        // the device row as the fit test saw it (before this debit)
        int frac_dev = 0;
        float fbest = -INFINITY;
        for (int d = 0; d < D; ++d) {
          const float da = __fadd_rn(dev[(size_t)node * D + d],
                                     dev_releasing[(size_t)node * D + d]);
          if (d == 0 || da > fbest) {
            fbest = da;
            frac_dev = d;
          }
        }
        const int k = (int)rintf(req[(size_t)m * R]);
        int taken = 0;
        for (int d = 0; d < D; ++d) {
          const float da = __fadd_rn(dev[(size_t)node * D + d],
                                     dev_releasing[(size_t)node * D + d]);
          float dd;
          if (is_frac) {
            dd = __fmul_rn(p, d == frac_dev ? 1.0f : 0.0f);
          } else {
            const bool fully = da >= one_m_eps;
            taken += fully ? 1 : 0;
            dd = (fully && taken <= k) ? 1.0f : 0.0f;
          }
          dev[(size_t)node * D + d] = __fadd_rn(dev[(size_t)node * D + d],
                                                -dd);
        }
        moves[m] = node;
      } else {
        moves[m] = -1;
        ok = false;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *all_ok = ok ? 1 : 0;
}

KAI_EXPORT int kai_replace_victims(
    const int* idxs, const int* n_vic, int K, const float* req,
    const int* device, const float* accel_mem, const float* held,
    const int* filter_class, const float* extended, const float* dev_mem,
    const u8* valid, const u8* fmask, const float* releasing,
    const float* dev_releasing, const float* ext_releasing, int N, int R,
    int D, int E, float* free_, float* dev, float* ext, int* moves,
    u8* all_ok, cudaStream_t stream) {
  if (K < 1 || N < 1 || R < 1 || D < 0 || E < 0) return KAI_ERR_ARGS;
  replace_victims_kernel<<<1, RV_THREADS, 0, stream>>>(
      idxs, n_vic, K, req, device, accel_mem, held, filter_class, extended,
      dev_mem, valid, fmask, releasing, dev_releasing, ext_releasing, N, R, D,
      E, free_, dev, ext, moves, all_ok);
  return static_cast<int>(cudaGetLastError());
}
