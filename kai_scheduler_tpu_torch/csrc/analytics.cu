// K14 analytics — the cluster-health bundle of one cycle (kai-pulse).
//
// Replaces kai_scheduler_tpu/ops/analytics.py:263 `cluster_analytics`:
// free-fraction histograms, unit pods per node and per rack, the ladder
// and fragmentation score, stranded free capacity, utilization, goodput,
// per-queue fairness drift with its max / mean / Gini, and the top-K
// oldest pending gangs, written into the flat f32 / i32 layout of
// ops/analytics.py `flatten`.
//
// One block of AN_THREADS threads does the whole pass, in phases separated
// by __syncthreads:
//   1. zero the rack-domain sums;
//   2. one thread per node (strided): histogram bins (shared int atomics:
//      counts are exact), unit pods (stored in `units`), and the node's
//      units added into its rack domain (float atomics: whole unit counts,
//      exact in any order while they stay below 2**24);
//   3. every sum over nodes, running pods, gang tasks and queues in the
//      plain version's order (`an_tree_sum`: pad to a power of two with
//      +0.0, add adjacent pairs level by level) — each thread reduces an
//      aligned power-of-two chunk as a subtree (a binary-counter stack),
//      then the block adds the chunk sums pairwise;
//   4. maxima (order-free), the queue roll-ups, the Gini pair sum over
//      [Q, Q], the top-K by K rounds of a block argmax in lax.top_k order
//      (value descending in f32's total order, lower index first), and the
//      scalar gauges.
// Bound: bytes — every input read once, the bundle written once.
#include "kai_common.cuh"

#define AN_THREADS 1024
#define AN_MAX_BINS 256
#define AN_MAX_TOPK 64

// the plain version's tree_sum of get(i), i < n
template <class F>
__device__ float an_tree_sum(const F& get, long long n, float* red) {
  __syncthreads();
  if (n <= 0) return 0.0f;
  long long p = 1;
  while (p < n) p <<= 1;
  const int T = (int)(p < (long long)blockDim.x ? p : blockDim.x);
  const long long C = p / T;
  const int t = threadIdx.x;
  if (t < T) {
    float stack[48];
    const long long base = (long long)t * C;
    int lvl = 0;
    for (long long j = 0; j < C; ++j) {
      float e = base + j < n ? get(base + j) : 0.0f;
      long long cnt = j + 1;
      lvl = 0;
      while ((cnt & 1) == 0) {
        e = __fadd_rn(stack[lvl], e);
        cnt >>= 1;
        ++lvl;
      }
      stack[lvl] = e;
    }
    red[t] = stack[lvl];
  }
  __syncthreads();
  for (int w = T; w > 1; w >>= 1) {
    const int h = w >> 1;
    float a = 0.0f;
    if (t < h) a = __fadd_rn(red[2 * t], red[2 * t + 1]);
    __syncthreads();
    if (t < h) red[t] = a;
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// block max of non-negative values (0.0 when empty)
__device__ float an_block_max(float v, float* red) {
  __syncthreads();
  red[threadIdx.x] = v;
  __syncthreads();
  for (int h = blockDim.x >> 1; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ int an_block_count(int v, int* ired) {
  __syncthreads();
  ired[threadIdx.x] = v;
  __syncthreads();
  for (int h = blockDim.x >> 1; h > 0; h >>= 1) {
    if ((int)threadIdx.x < h) ired[threadIdx.x] += ired[threadIdx.x + h];
    __syncthreads();
  }
  const int out = ired[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ float an_pos(float x) { return x > 0.0f ? x : 0.0f; }

__global__ void __launch_bounds__(AN_THREADS) analytics_kernel(
    const float* __restrict__ free, const float* __restrict__ alloc,
    const u8* __restrict__ nvalid, const float* __restrict__ releasing,
    const int* __restrict__ topology, const float* __restrict__ res_free,
    const float* __restrict__ res_rel, const u8* __restrict__ victim,
    const int* __restrict__ placements, const u8* __restrict__ allocated,
    const u8* __restrict__ pipelined, const float* __restrict__ qa,
    const u8* __restrict__ rvalid, const u8* __restrict__ rreleasing,
    const float* __restrict__ rreq, const u8* __restrict__ gvalid,
    const u8* __restrict__ task_valid, const float* __restrict__ task_req,
    const float* __restrict__ pending_age, const u8* __restrict__ qvalid,
    const float* __restrict__ fair_share, const float* __restrict__ ladder,
    int L, int rl, int LAD, int bins, float u0, float u1, float u2, int K,
    int N, int M, int G, int T, int Q, float* __restrict__ rack,
    float* __restrict__ scratch, float* __restrict__ out_f,
    int* __restrict__ out_i) {
  __shared__ float red[AN_THREADS];
  __shared__ int ired[AN_THREADS];
  __shared__ int s_hist[3 * AN_MAX_BINS];
  __shared__ int s_top[AN_MAX_TOPK];
  __shared__ float s_bv[AN_THREADS];
  __shared__ int s_bi[AN_THREADS];
  const int t = threadIdx.x;
  const int nthr = blockDim.x;
  const int junk = N * L + N;
  float* units = scratch;      // [N]
  float* share = scratch + N;  // [Q]
  const float unit[3] = {u0, u1, u2};

  // ---- 1. zero the domain sums and the histogram ---------------------------
  for (int i = t; i <= junk; i += nthr) rack[i] = 0.0f;
  for (int i = t; i < 3 * bins; i += nthr) s_hist[i] = 0;
  __syncthreads();

  // ---- 2. per node ------------------------------------------------------------
  for (int n = t; n < N; n += nthr) {
    const bool v = nvalid[n] != 0;
    float fr[3];
    bool fits = true;
    float u = INFINITY;
    for (int r = 0; r < 3; ++r) {
      fr[r] = an_pos(free[(size_t)n * 3 + r]);
      const float al = alloc[(size_t)n * 3 + r];
      const float frac = al > 0.0f ? fr[r] / fmaxf(al, KAI_EPS) : 0.0f;
      int bin = (int)floorf(frac * (float)bins);
      bin = min(max(bin, 0), bins - 1);
      if (v) atomicAdd(&s_hist[r * bins + bin], 1);
      fits = fits && (__fadd_rn(fr[r], KAI_EPS) >= unit[r]);
      if (unit[r] > 0.0f) u = fminf(u, floorf(fr[r] / fmaxf(unit[r], KAI_EPS)));
    }
    if (!isfinite(u)) u = 0.0f;
    const float un = (v && fits) ? an_pos(u) : 0.0f;
    units[n] = un;
    if (v && un != 0.0f) {
      const int d = topology[(size_t)n * L + rl];
      atomicAdd(&rack[d >= 0 ? d : N * L + n], un);
    }
  }
  __syncthreads();

  // ---- 3. the tree sums ----------------------------------------------------
  const float total_units =
      an_tree_sum([&](long long i) { return units[i]; }, N, red);
  float free_tot[3], stuck[3], cap[3], idle[3];
  for (int r = 0; r < 3; ++r) {
    free_tot[r] = an_tree_sum(
        [&](long long i) {
          return nvalid[i] ? an_pos(free[i * 3 + r]) : 0.0f;
        },
        N, red);
    stuck[r] = an_tree_sum(
        [&](long long i) {
          return (nvalid[i] && units[i] <= 0.0f) ? an_pos(free[i * 3 + r])
                                                 : 0.0f;
        },
        N, red);
    cap[r] = an_tree_sum(
        [&](long long i) { return nvalid[i] ? alloc[i * 3 + r] : 0.0f; }, N,
        red);
    idle[r] = an_tree_sum(
        [&](long long i) {
          if (!nvalid[i]) return 0.0f;
          return __fadd_rn(an_pos(res_free[i * 3 + r]),
                           an_pos(__fadd_rn(releasing[i * 3 + r],
                                            res_rel[i * 3 + r])));
        },
        N, red);
  }
  const float thr_running = an_tree_sum(
      [&](long long m) {
        return (rvalid[m] && !rreleasing[m] && !victim[m]) ? rreq[m * 3]
                                                           : 0.0f;
      },
      M, red);
  const float thr_placed = an_tree_sum(
      [&](long long i) {
        const long long g = i / T;
        return (placements[i] >= 0 && task_valid[i] && allocated[g] &&
                !pipelined[i])
                   ? task_req[i * 3]
                   : 0.0f;
      },
      (long long)G * T, red);

  // ---- 4. maxima, queues, top-K, scalars -----------------------------------
  float mr = 0.0f;
  for (int d = t; d < junk; d += nthr) mr = fmaxf(mr, rack[d]);
  const float max_rack = an_block_max(mr, red);

  float* o = out_f;
  float* o_hist = o;
  float* o_lcl = o_hist + 3 * bins;
  float* o_lrk = o_lcl + LAD;
  float* o_total = o_lrk + LAD;
  float* o_maxrack = o_total + 1;
  float* o_stranded = o_maxrack + 1;
  float* o_frag = o_stranded + 3;
  float* o_util = o_frag + 1;
  float* o_goodput = o_util + 3;
  float* o_qdrift = o_goodput + 1;
  float* o_dmax = o_qdrift + Q;
  float* o_dmean = o_dmax + 1;
  float* o_gini = o_dmean + 1;
  float* o_age = o_gini + 1;
  float* o_pending = o_age + K;

  float cap1[3];
  for (int r = 0; r < 3; ++r) cap1[r] = fmaxf(cap[r], 1.0f);
  float dm = 0.0f;
  int nq_local = 0;
  for (int q = t; q < Q; q += nthr) {
    float dv = 0.0f, ds = 0.0f;
    for (int r = 0; r < 3; ++r) {
      const float a = qa[(size_t)q * 3 + r];
      const float x = fabsf(__fsub_rn(a, fair_share[(size_t)q * 3 + r])) /
                      cap1[r];
      const float s = a / cap1[r];
      dv = r ? fmaxf(dv, x) : x;
      ds = r ? fmaxf(ds, s) : s;
    }
    const bool qv = qvalid[q] != 0;
    const float qd = qv ? dv : 0.0f;
    o_qdrift[q] = qd;
    share[q] = qv ? ds : 0.0f;
    dm = fmaxf(dm, qd);
    nq_local += qv ? 1 : 0;
  }
  __syncthreads();
  const float drift_max = an_block_max(dm, red);
  const float nq = (float)an_block_count(nq_local, ired);
  const float drift_sum =
      an_tree_sum([&](long long q) { return o_qdrift[q]; }, Q, red);
  const float share_tot =
      an_tree_sum([&](long long q) { return share[q]; }, Q, red);
  const float pair_sum = an_tree_sum(
      [&](long long i) {
        const long long a = i / Q, b = i % Q;
        return (qvalid[a] && qvalid[b]) ? fabsf(__fsub_rn(share[a], share[b]))
                                        : 0.0f;
      },
      (long long)Q * Q, red);

  int pend_local = 0;
  for (int g = t; g < G; g += nthr) pend_local += (gvalid[g] && !allocated[g]);
  const int pending = an_block_count(pend_local, ired);

  for (int k = 0; k < K; ++k) {
    float bv = 0.0f;
    int bi = -1;
    for (int g = t; g < G; g += nthr) {
      bool taken = false;
      for (int j = 0; j < k; ++j) taken = taken || s_top[j] == g;
      if (taken) continue;
      const float age = (gvalid[g] && !allocated[g])
                            ? __fadd_rn(pending_age[g], 1.0f)
                            : 0.0f;
      if (bi < 0 || kai_topk_better(age, g, bv, bi)) {
        bv = age;
        bi = g;
      }
    }
    s_bv[t] = bv;
    s_bi[t] = bi;
    __syncthreads();
    for (int h = nthr >> 1; h > 0; h >>= 1) {
      if (t < h) {
        const int oi = s_bi[t + h];
        if (oi >= 0 && (s_bi[t] < 0 ||
                        kai_topk_better(s_bv[t + h], oi, s_bv[t], s_bi[t]))) {
          s_bv[t] = s_bv[t + h];
          s_bi[t] = oi;
        }
      }
      __syncthreads();
    }
    if (t == 0) {
      s_top[k] = s_bi[0];
      o_age[k] = s_bv[0];
      out_i[k] = s_bi[0];
    }
    __syncthreads();
  }

  for (int i = t; i < 3 * bins; i += nthr) o_hist[i] = (float)s_hist[i];
  if (t == 0) {
    float n_cl = 0.0f, n_str = 0.0f;
    for (int i = 0; i < LAD; ++i) {
      const float cl = total_units >= ladder[i] ? 1.0f : 0.0f;
      const float rk = max_rack >= ladder[i] ? 1.0f : 0.0f;
      o_lcl[i] = cl;
      o_lrk[i] = rk;
      n_cl = __fadd_rn(n_cl, cl);
      n_str = __fadd_rn(n_str, __fmul_rn(cl, __fsub_rn(1.0f, rk)));
    }
    *o_total = total_units;
    *o_maxrack = max_rack;
    *o_frag = n_str / fmaxf(n_cl, 1.0f);
    for (int r = 0; r < 3; ++r) {
      o_stranded[r] =
          free_tot[r] > 0.0f ? stuck[r] / fmaxf(free_tot[r], KAI_EPS) : 0.0f;
      o_util[r] = cap[r] > 0.0f
                      ? __fsub_rn(1.0f, idle[r] / fmaxf(cap[r], KAI_EPS))
                      : 0.0f;
    }
    *o_goodput = __fadd_rn(thr_running, thr_placed) / fmaxf(cap[0], KAI_EPS);
    *o_dmax = drift_max;
    *o_dmean = drift_sum / fmaxf(nq, 1.0f);
    *o_gini = (nq > 1.0f && share_tot > 0.0f)
                  ? pair_sum /
                        fmaxf(__fmul_rn(__fmul_rn(2.0f, nq), share_tot),
                              KAI_EPS)
                  : 0.0f;
    *o_pending = (float)pending;
  }
}

// `rack` is an [N*L + N + 1] scratch, `scratch` [N + Q]; `out_f` holds the
// bundle's f32 fields in flatten order, `out_i` the K gang indices
KAI_EXPORT int kai_analytics(
    const float* free, const float* alloc, const u8* nvalid,
    const float* releasing, const int* topology, const float* res_free,
    const float* res_rel, const u8* victim, const int* placements,
    const u8* allocated, const u8* pipelined, const float* qa,
    const u8* rvalid, const u8* rreleasing, const float* rreq,
    const u8* gvalid, const u8* task_valid, const float* task_req,
    const float* pending_age, const u8* qvalid, const float* fair_share,
    const float* ladder, int L, int rl, int LAD, int bins, float u0, float u1,
    float u2, int K, int N, int M, int G, int T, int Q, float* rack,
    float* scratch, float* out_f, int* out_i, cudaStream_t stream) {
  if (N < 1 || L < 1 || rl < 0 || rl >= L || bins < 1 ||
      bins > AN_MAX_BINS || K < 1 || K > AN_MAX_TOPK || K > G || M < 0 ||
      T < 1 || Q < 1 || LAD < 0)
    return KAI_ERR_ARGS;
  analytics_kernel<<<1, AN_THREADS, 0, stream>>>(
      free, alloc, nvalid, releasing, topology, res_free, res_rel, victim,
      placements, allocated, pipelined, qa, rvalid, rreleasing, rreq, gvalid,
      task_valid, task_req, pending_age, qvalid, fair_share, ladder, L, rl,
      LAD, bins, u0, u1, u2, K, N, M, G, T, Q, rack, scratch, out_f, out_i);
  return static_cast<int>(cudaGetLastError());
}
