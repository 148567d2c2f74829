// K2 type_tables — per (task type, node) fit, replica counts and score
// bands, once per wavefront chunk.
//
// Replaces kai_scheduler_tpu/ops/allocate.py:1552 `build_type_tables`
// (`feasible_nodes_dual` predicates.py:168 with devices=False,
// `_replica_count` :358 and `score_nodes_for_task` scoring.py:181 over
// the default tiers nodeplacement, resourcetype, nodeavailability), the
// reference's vmap over task types.
//
// One block per task type walks the node axis twice: first a block-wide
// min/max of the non-allocated amount of the type's dominant resource
// over the candidate nodes (the binpack/spread density range), then the
// fit, replica-count and score pass, writing five [Y, N] tables.
// Bound: bytes — it reads the [N, 3] pools and label/filter rows and
// writes 14 bytes per (type, node); there are a handful of flops per
// element.  Every f32 operation keeps the reference's order
// ((free + releasing) + extra, (avail + EPS) / max(req, EPS), floor,
// ((0 + placement) + resourcetype) + availability).
//
// `extra` is one [N, 3] pool for every type row, or (per_row) one pool per
// row, [Y, N, 3]: the chunked victim wavefront builds one row per lane, the
// lane's gang type over the chunk-start pool plus that lane's own freed
// capacity (ref victims.py:1314 extra_b, under the lane vmap).  Only the
// pipeline pool, its fit, its replica count and the density range of the
// row read it.
#include "kai_common.cuh"

#define TT_THREADS 512

__device__ __forceinline__ bool tt_selected(const u8* valid, const int* labels,
                                            const u8* fmask, const int* sel,
                                            int cls, int n, int N, int K) {
  if (!valid[n] || !fmask[(size_t)cls * N + n]) return false;
  for (int kk = 0; kk < K; ++kk) {
    const int s = sel[kk];
    if (s >= 0 && labels[(size_t)n * K + kk] != s) return false;
  }
  return true;
}

// whole replicas of req in avail, zero outside mask (ref _replica_count)
__device__ __forceinline__ int tt_replicas(const float* avail, const float* req,
                                           bool mask) {
  float c = INFINITY;
  for (int r = 0; r < 3; ++r) {
    const float cr = req[r] > KAI_EPS
                         ? __fdiv_rn(__fadd_rn(avail[r], KAI_EPS),
                                     fmaxf(req[r], KAI_EPS))
                         : INFINITY;
    c = fminf(c, cr);
  }
  c = floorf(c);
  return mask ? static_cast<int>(fminf(fmaxf(c, 0.0f), 1e9f)) : 0;
}

__global__ void type_tables_kernel(
    const float* __restrict__ free_, const float* __restrict__ rel,
    const float* __restrict__ extra, const float* __restrict__ alloc,
    const u8* __restrict__ valid, const int* __restrict__ labels,
    const u8* __restrict__ fmask, const float* __restrict__ type_req,
    const int* __restrict__ type_sel, const int* __restrict__ type_class,
    int N, int K, int binpack_accel, int binpack_cpu, int per_row,
    u8* __restrict__ fi, u8* __restrict__ fp, int* __restrict__ ci,
    int* __restrict__ cp, float* __restrict__ sc) {
  const int y = blockIdx.x;
  if (per_row) extra += (size_t)y * N * 3;
  const float req[3] = {type_req[y * 3], type_req[y * 3 + 1],
                        type_req[y * 3 + 2]};
  const int* sel = type_sel + (size_t)y * K;
  const int cls = type_class[y];
  const bool accel_task = req[0] > 0.0f;
  const int res = accel_task ? 0 : 1;
  const bool binpack = accel_task ? binpack_accel != 0 : binpack_cpu != 0;

  // ---- pass 1: density range over candidate nodes --------------------------
  float mn = FLT_MAX, mx = -FLT_MAX;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    if (!tt_selected(valid, labels, fmask, sel, cls, n, N, K)) continue;
    bool fit_pipe = true;
    for (int r = 0; r < 3; ++r) {
      const float avail = __fadd_rn(__fadd_rn(free_[n * 3 + r], rel[n * 3 + r]),
                                    extra[n * 3 + r]);
      fit_pipe = fit_pipe && (__fadd_rn(avail, KAI_EPS) >= req[r]);
    }
    if (fit_pipe && alloc[n * 3 + res] > 0.0f) {
      const float na = __fadd_rn(free_[n * 3 + res], rel[n * 3 + res]);
      mn = fminf(mn, na);
      mx = fmaxf(mx, na);
    }
  }
  __shared__ float s_mn[32], s_mx[32];
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      s_mn[0] = fminf(s_mn[0], s_mn[w]);
      s_mx[0] = fmaxf(s_mx[0], s_mx[w]);
    }
  }
  __syncthreads();
  mn = s_mn[0];
  mx = s_mx[0];
  const float span = __fsub_rn(mx, mn);

  // ---- pass 2: fit, replica counts, bands ----------------------------------
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const bool s_ok = tt_selected(valid, labels, fmask, sel, cls, n, N, K);
    float idle[3], avail[3];
    bool fit_idle = s_ok, fit_pipe = s_ok;
    for (int r = 0; r < 3; ++r) {
      idle[r] = free_[n * 3 + r];
      avail[r] = __fadd_rn(__fadd_rn(idle[r], rel[n * 3 + r]), extra[n * 3 + r]);
      fit_idle = fit_idle && (__fadd_rn(idle[r], KAI_EPS) >= req[r]);
      fit_pipe = fit_pipe && (__fadd_rn(avail[r], KAI_EPS) >= req[r]);
    }
    const size_t o = (size_t)y * N + n;
    fi[o] = fit_idle ? 1 : 0;
    fp[o] = fit_pipe ? 1 : 0;
    cp[o] = tt_replicas(avail, req, fit_pipe);
    ci[o] = tt_replicas(idle, req, fit_idle);
    // nodeplacement: density of the dominant resource (ref pack.go)
    const bool cand = fit_pipe && alloc[n * 3 + res] > 0.0f;
    float place = 0.0f;
    if (cand) {
      float raw = 1.0f;
      if (span > 0.0f) {
        const float na = __fadd_rn(idle[res], rel[n * 3 + res]);
        const float frac = __fdiv_rn(__fsub_rn(na, mn), fmaxf(span, 1e-30f));
        raw = binpack ? __fsub_rn(1.0f, frac) : frac;
      }
      place = __fmul_rn(9.0f, raw);
    }
    // resourcetype: cpu-only task on a cpu-only node
    const float rtype = (req[0] <= 0.0f && alloc[n * 3] <= 0.0f) ? 10.0f : 0.0f;
    // nodeavailability: fits on idle now
    const float avl = fit_idle ? 100.0f : 0.0f;
    sc[o] = __fadd_rn(__fadd_rn(__fadd_rn(0.0f, place), rtype), avl);
  }
}

KAI_EXPORT int kai_type_tables(const float* free_, const float* rel,
                               const float* extra, const float* alloc,
                               const u8* valid, const int* labels,
                               const u8* fmask, const float* type_req,
                               const int* type_sel, const int* type_class,
                               int N, int R, int K, int Y, int X,
                               int binpack_accel, int binpack_cpu,
                               int per_row, u8* fi, u8* fp, int* ci, int* cp,
                               float* sc, cudaStream_t stream) {
  if (N < 1 || R != 3 || K < 1 || Y < 1 || X < 1) return KAI_ERR_ARGS;
  type_tables_kernel<<<Y, TT_THREADS, 0, stream>>>(
      free_, rel, extra, alloc, valid, labels, fmask, type_req, type_sel,
      type_class, N, K, binpack_accel, binpack_cpu, per_row, fi, fp, ci, cp,
      sc);
  return static_cast<int>(cudaGetLastError());
}
