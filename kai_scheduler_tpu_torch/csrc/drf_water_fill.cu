// K1 drf_water_fill — one hierarchy level of the hierarchical DRF division.
//
// Replaces kai_scheduler_tpu/ops/drf.py:41 `_divide_one_resource`, vmapped
// over resources by `divide_level` (:144) and looped over levels by
// `set_fair_share` (:164).  One launch per level, one block per resource,
// one thread per queue (Q <= 1024); the per-queue state lives in
// registers, what siblings share (segment sums, remaining pool, ranks)
// in shared memory.  Both of the reference's while_loops — the priority
// tiers and the water-fill rounds inside a tier — run on the device.
//
// Bound: the work is a few hundred flops per queue per round on a few KB,
// so the card's launch latency, not bytes or flops, bounds it; the
// serial segment sums (one thread walks the queues in ascending index)
// are the price of reproducing the reference's scatter-add order: each
// segment is summed from 0.0 in ascending queue index, like the
// reference's segment_sum, so the f32 result is bit-identical.
#include "kai_common.cuh"

#define DRF_MAX_Q 1024
// a loop that would spin past this many rounds flags `err` and stops
#define DRF_MAX_ROUNDS (1 << 22)

__shared__ float sh_v[DRF_MAX_Q];
__shared__ float sh_w[DRF_MAX_Q];
__shared__ int sh_seg[DRF_MAX_Q];
__shared__ int sh_prio[DRF_MAX_Q];
__shared__ int sh_crea[DRF_MAX_Q];
__shared__ int sh_pr[DRF_MAX_Q];
__shared__ float sh_rf[DRF_MAX_Q];
__shared__ u8 sh_hasrem[DRF_MAX_Q];
__shared__ float sh_remaining[DRF_MAX_Q + 1];
__shared__ float sh_a[DRF_MAX_Q + 1];
__shared__ float sh_b[DRF_MAX_Q + 1];
__shared__ int sh_curp[DRF_MAX_Q + 1];

// out[s] = sum over q with seg[q] == s of v[q], ascending q, from 0.0
// (and out2 likewise from v2 when given).  Every thread must call it.
__device__ void drf_segment_sum(const float* v, float* out, const float* v2,
                                float* out2, int Q, int S) {
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      out[s] = 0.0f;
      if (out2) out2[s] = 0.0f;
    }
    for (int q = 0; q < Q; ++q) {
      const int s = sh_seg[q];
      out[s] = __fadd_rn(out[s], v[q]);
      if (out2) out2[s] = __fadd_rn(out2[s], v2[q]);
    }
  }
  __syncthreads();
}

__global__ void drf_level_kernel(
    const float* __restrict__ seg_total, const float* __restrict__ quota,
    const float* __restrict__ weight, const float* __restrict__ limit,
    const float* __restrict__ request, const float* __restrict__ usage,
    const int* __restrict__ priority, const int* __restrict__ seg,
    const int* __restrict__ creation, const u8* __restrict__ active,
    float k, int Q, int R, float* __restrict__ fs_out,
    int* __restrict__ err) {
  const int r = blockIdx.x;
  const int q = threadIdx.x;
  const int S = Q + 1;
  const bool vq = q < Q;

  float quota_q = 0.f, weight_q = 0.f, limit_q = 0.f, request_q = 0.f,
        usage_q = 0.f;
  int prio_q = 0, seg_q = 0, crea_q = 0;
  bool act_q = false;
  if (vq) {
    quota_q = quota[q * R + r];
    weight_q = weight[q * R + r];
    limit_q = limit[q * R + r];
    request_q = request[q * R + r];
    usage_q = usage[q * R + r];
    prio_q = priority[q];
    seg_q = seg[q];
    crea_q = creation[q];
    act_q = active[q] != 0;
    sh_seg[q] = seg_q;
    sh_prio[q] = prio_q;
    sh_crea[q] = crea_q;
  }
  const bool unl = limit_q <= KAI_UNLIMITED_CUT;
  float requestable = unl ? request_q : fminf(request_q, limit_q);
  requestable = fmaxf(requestable, 0.0f);
  const float q_total = seg_total[seg_q * R + r];
  const float deserved = (quota_q <= KAI_UNLIMITED_CUT) ? q_total : quota_q;

  // -- pass 1: deserved -----------------------------------------------------
  float fs = act_q ? fminf(deserved, requestable) : 0.0f;
  if (vq) sh_v[q] = fs;
  drf_segment_sum(sh_v, sh_a, nullptr, nullptr, Q, S);
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    sh_remaining[s] = fmaxf(__fsub_rn(seg_total[s * R + r], sh_a[s]), 0.0f);
  __syncthreads();

  // -- pass 2: over-quota by priority tier ------------------------------------
  float rem_frac = 0.0f;
  bool processed = false;
  int rounds = 0;
  bool overrun = false;
  while (true) {
    const bool sat0 = (request_q <= fs) || (!unl && (limit_q <= fs));
    const bool cand = vq && act_q && !sat0 && (weight_q > 0.0f) && !processed;
    const bool go = cand && (sh_remaining[seg_q] > 0.0f);
    if (!__syncthreads_or(go)) break;
    // highest unprocessed priority per segment forms the current tier
    if (vq) sh_pr[q] = cand ? prio_q : INT_MIN;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) sh_curp[s] = INT_MIN;
      for (int j = 0; j < Q; ++j)
        sh_curp[sh_seg[j]] = max(sh_curp[sh_seg[j]], sh_pr[j]);
    }
    __syncthreads();
    const bool tier = cand && (prio_q == sh_curp[seg_q]);

    bool again = true;
    while (again) {
      if (++rounds > DRF_MAX_ROUNDS) {
        overrun = true;
        break;
      }
      const bool sat = (request_q <= fs) || (!unl && (limit_q <= fs));
      const bool unsat = vq && act_q && !sat && tier;
      const float remreq =
          unsat ? fmaxf(__fsub_rn(requestable, fs), 0.0f) : 0.0f;
      const bool wants = unsat && (remreq > 0.0f);
      // normalize weights among wanting queues (ref calcShareWeights)
      if (vq) sh_v[q] = wants ? weight_q : 0.0f;
      drf_segment_sum(sh_v, sh_a, nullptr, nullptr, Q, S);
      const float tot_w = sh_a[seg_q];
      const float n_w = (wants && tot_w > 0.0f)
                            ? __fdiv_rn(weight_q, fmaxf(tot_w, 1e-30f))
                            : 0.0f;
      const float share_w =
          __fmul_rn(fmaxf(0.0f, __fadd_rn(n_w, __fmul_rn(
                                    k, __fsub_rn(n_w, usage_q)))),
                    wants ? 1.0f : 0.0f);
      if (vq) sh_v[q] = share_w;
      drf_segment_sum(sh_v, sh_b, nullptr, nullptr, Q, S);
      const float sum_w = sh_b[seg_q];
      const bool ok = wants && (sum_w > 0.0f);
      const float fair =
          ok ? __fdiv_rn(__fmul_rn(sh_remaining[seg_q], share_w),
                         fmaxf(sum_w, 1e-30f))
             : 0.0f;
      const bool sat_now = remreq <= fair;
      const float give = ok ? (sat_now ? remreq : floorf(fair)) : 0.0f;
      const float new_rem =
          (ok && !sat_now) ? __fsub_rn(fair, floorf(fair)) : 0.0f;
      rem_frac = ok ? new_rem : ((tier && sat_now) ? 0.0f : rem_frac);
      fs = __fadd_rn(fs, give);
      if (vq) {
        sh_v[q] = give;
        sh_w[q] = (ok && sat_now && (remreq < fair)) ? 1.0f : 0.0f;
      }
      // gave -> sh_a, freed -> sh_b
      drf_segment_sum(sh_v, sh_a, sh_w, sh_b, Q, S);
      bool more = false;
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        const float gave = sh_a[s];
        const float nrem = fmaxf(__fsub_rn(sh_remaining[s], gave), 0.0f);
        sh_remaining[s] = nrem;
        more = more || ((sh_b[s] > 0.0f) && (nrem > 0.0f) && (gave > 0.0f));
      }
      again = __syncthreads_or(more);
    }
    if (overrun) break;
    processed = processed || tier;
  }

  // -- pass 3: whole-unit remainders ------------------------------------------
  // order: priority desc, fractional remainder desc, creation asc
  const bool has_rem = vq && act_q && (rem_frac > 0.0f);
  if (vq) {
    sh_rf[q] = rem_frac;
    sh_hasrem[q] = has_rem ? 1 : 0;
  }
  __syncthreads();
  if (vq) {
    int rank = 0;
    for (int j = 0; j < Q; ++j) {
      if (sh_seg[j] != seg_q || !sh_hasrem[j]) continue;
      const int pj = sh_prio[j];
      const float rj = sh_rf[j];
      const bool before = (pj > prio_q) || (pj == prio_q && rj > rem_frac) ||
                          (pj == prio_q && rj == rem_frac && sh_crea[j] < crea_q);
      rank += before ? 1 : 0;
    }
    const float give3 =
        has_rem ? fminf(fmaxf(__fsub_rn(sh_remaining[seg_q], (float)rank), 0.0f),
                        1.0f)
                : 0.0f;
    fs_out[q * R + r] = __fadd_rn(fs, give3);
  }
  if (threadIdx.x == 0) err[r] = overrun ? 1 : 0;
}

KAI_EXPORT int kai_drf_level(const float* seg_total, const float* quota,
                             const float* weight, const float* limit,
                             const float* request, const float* usage,
                             const int* priority, const int* seg,
                             const int* creation, const u8* active, float k,
                             int Q, int R, float* fs_out, int* err,
                             cudaStream_t stream) {
  if (Q < 1 || Q > DRF_MAX_Q || R < 1) return KAI_ERR_ARGS;
  const int threads = ((Q + 31) / 32) * 32;
  drf_level_kernel<<<R, threads, 0, stream>>>(
      seg_total, quota, weight, limit, request, usage, priority, seg,
      creation, active, k, Q, R, fs_out, err);
  return static_cast<int>(cudaGetLastError());
}
