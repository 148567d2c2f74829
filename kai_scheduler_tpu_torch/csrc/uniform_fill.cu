// K3 uniform_fill — the whole-gang placement of every wavefront lane.
//
// Replaces kai_scheduler_tpu/ops/allocate.py:915
// `_attempt_gang_in_domain_uniform` under the chunk's lane vmap (:1690),
// in its sparse-output, hoisted-type-table form: per lane the ancestor
// queue gate `max_copies`, the lane clamp, the tie jitter (both the dense
// rotation and the rank-within-feasible branch), a top-k of T over the N
// nodes in lax.top_k order (score descending in f32's total order, -0.0
// below +0.0; lower node index first among ties), the cumulative fill,
// the node-ascending replica assignment, the pipeline flags, the queue
// deltas and `success`.
//
// One block of UF_THREADS (512) threads per lane, at most 64 registers a
// thread so that two blocks share an SM (a chunk's 256 lanes in one wave;
// 1,024 threads a lane, or 256, measured slower).  A lane's work is bound
// by instruction throughput more than by bytes: every node costs its
// rank, jitter, score and key.  What the design does about what is
// scarce on this card (barriers, local memory, serial threads):
//   - each warp owns a contiguous range of the node axis and reads it 128
//     nodes at a time (four coalesced 32-node steps whose loads are all
//     started before any is used).  The
//     jitter's feasible rank comes from one counting sweep (a ballot and a
//     popcount per step, no barrier), one barrier to publish the per-warp
//     counts, and in the scoring sweep each node's rank is its warp's
//     offset + the warp's running count + popc(ballot & lanes below).  The
//     dense rotation needs no rank and skips the counting sweep.
//   - the top-k is a selection on one 64-bit key per node: the f32 key of
//     the score (kai_f32_key, sign bit flipped) high and ~node low, so
//     "better" in lax.top_k's order is an unsigned compare.  Each warp
//     keeps its best 64 keys sorted in registers (two a lane) and the
//     k-th of them as a threshold (raised to the best threshold any warp
//     has published in shared memory: a k-th best of any subset is below
//     the k-th best of all).  A node enters the warp's 64-slot candidate
//     buffer in shared memory only if it beats the threshold; a full
//     buffer (32 or more) is bitonic-sorted in registers with shuffles and
//     merged into the warp's list.  On an empty cluster (every score ties,
//     lower node first) a warp merges once and then rejects every node.
//     The warps' lists are merged in a tree (log2 of the warps barriers;
//     32 keys a list when k <= 32, as it is for gangs of up to 32 tasks).
//     No per-thread arrays: nothing in local memory.
//   - the fill and the assignment run on one warp: the k chosen nodes'
//     clamped counts, a warp scan for the cumulative claim (unsigned, the
//     reference's int32 wrap), a warp bitonic sort of the placed nodes by
//     node id, a warp scan of their replicas and a binary search of each
//     task's position in that prefix; the queue gate's Q x 3 heads (both
//     tables in one pass) and the gang's task slots are split over the
//     lanes of warp 0, every load of the gang's scalars started first.
//
// The chunked victim wavefront (ref victims.py:1350, `_attempt_gang` under
// the lane vmap, legacy protocol) adds three optional inputs: `qa` with one
// [Q, 3] table per lane (qa_lanes: each lane's allocation net of its own
// victims), `rows` naming each lane's row of the tables (a junk lane's
// clamped gang may share a real lane's gang, so the row is not derived
// from the gang), and `score_bias` [B, N] (the own-freed band), added last
// in the reference's f32 order: ((bands + soft) + jitter) + bias hoisted,
// bands + ((jitter + soft) + bias) not.
//
// The topology modes (ref :1030-1092 with the chunk-hoisted tables, and
// :1135-1139), in the reference's order of operations:
//   - required level (dom_caps_y given, the gang's srl0 >= 0): the lane
//     counts the domains of that level whose live replica capacity holds
//     min(goal, queue gate) replicas, walking them fullest first (`order`,
//     the chunk's stable sort of the domain aggregates), and takes the
//     (lane mod n_fit)-th (ballot counts per warp range, one barrier, the
//     owning warp finds it) — or the domain its prior placements locked.
//     Feasibility, replica counts and the jitter's feasible rank are
//     confined to that domain; with no domain the gang places nothing.
//   - preferred level (pref_level given, the gang's level >= 0): a sweep
//     takes the block argmax of the scores (lowest node on ties, as
//     jnp.argmax); the scoring sweep adds W_TOPOLOGY on the feasible nodes
//     that share that node's domain at the level, before the top-k.
//   - the mask mode (valid_lanes: `valid` is [B, N], each lane's own row):
//     the affinity gates' node mask (K12, valid nodes folded in) ANDed
//     into the fits after the hoisted type tables (ref :1010-1011,
//     :1020-1021), before the domain confinement, the counts, the jitter's
//     feasible rank and the top-k; it composes with the topology modes
//     and with the victim lanes.
//   - dense rows (free given): per task slot, `free - count * req` and
//     `min(count, c_idle) * req` of the node it took (ref :1177-1180), the
//     rows the dense accept (K10) reads.
//
// Bound: bytes — per lane its type's fit/band rows and its class's soft
// row (~10 bytes a node, each table read once however many lanes share
// it), the [B, N] mask in the mask mode, the lanes' gang rows and the
// outputs; chip_smoke.py computes it from each captured call (affinity:
// ~0.015 ms; the headline's chunk: ~0.0004 ms).  The kernel is bound by
// latency: two sweeps of N / (128 x warps) dependent steps per lane.
//
// Build (ptxas -v, sm_90a): 64 registers, 25,608 bytes of shared memory,
// 0 bytes of stack frame, spill stores or spill loads.
#include "kai_common.cuh"

#define UF_THREADS 512
#define UF_WARPS (UF_THREADS / 32)
#define UF_MAXK 64
#define UF_ILP 4  // 32-node steps a warp loads at once
#define UF_FULL 0xffffffffu

typedef unsigned long long u64;

struct UfLane {
  int gi, ty, cls, queue, goal, mgate, total;
  bool nonpre, opn;
  float req[3];
  // topology: required level and its target domain (-1: none fits), the
  // preferred level and the best node's domain there
  int srl, target, pl, pref_dom;
  bool has_req, pick;
};

// the top-k key of (score, node): larger is better in lax.top_k's order;
// 0 is below every node's key
__device__ __forceinline__ u64 uf_key(float score, int n) {
  const unsigned hi = (unsigned)kai_f32_key(score) ^ 0x80000000u;
  return ((u64)hi << 32) | (unsigned)(~n);
}
__device__ __forceinline__ int uf_key_node(u64 key) {
  return (int)(~(unsigned)key);
}
__device__ __forceinline__ u64 uf_max(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 uf_min(u64 a, u64 b) { return a < b ? a : b; }

// one compare-exchange step of a bitonic network over a warp's 64-element
// sequence (element i of a register at lane i & 31): the element at index
// i meets index i ^ s and keeps the larger if it is the lower of the two
// in a descending block
__device__ __forceinline__ u64 uf_cx(u64 v, int i, int s, bool desc) {
  const u64 o = __shfl_xor_sync(UF_FULL, v, s);
  return (((i & s) == 0) == desc) ? uf_max(v, o) : uf_min(v, o);
}

// sort the warp's 64 keys descending: x0 holds indices 0..31, x1 32..63
__device__ __forceinline__ void uf_sort64(u64& x0, u64& x1) {
  const int lane = threadIdx.x & 31;
  for (int size = 2; size <= 32; size <<= 1) {
    for (int s = size >> 1; s > 0; s >>= 1) {
      x0 = uf_cx(x0, lane, s, (lane & size) == 0);
      x1 = uf_cx(x1, 32 + lane, s, ((32 + lane) & size) == 0);
    }
  }
  const u64 hi = uf_max(x0, x1), lo = uf_min(x0, x1);
  x0 = hi;
  x1 = lo;
  for (int s = 16; s > 0; s >>= 1) {
    x0 = uf_cx(x0, lane, s, true);
    x1 = uf_cx(x1, lane, s, true);
  }
}

// a := the best 64 of the two descending 64-sequences a and c, descending
// (max(a[i], c[63 - i]) is bitonic and holds them; a half-cleaner sorts
// it)
__device__ __forceinline__ void uf_merge64(u64& a0, u64& a1, u64 c0,
                                           u64 c1) {
  const int lane = threadIdx.x & 31;
  const u64 r1 = __shfl_sync(UF_FULL, c1, 31 - lane);
  const u64 r0 = __shfl_sync(UF_FULL, c0, 31 - lane);
  u64 v0 = uf_max(a0, r1), v1 = uf_max(a1, r0);
  const u64 hi = uf_max(v0, v1), lo = uf_min(v0, v1);
  v0 = hi;
  v1 = lo;
  for (int s = 16; s > 0; s >>= 1) {
    v0 = uf_cx(v0, lane, s, true);
    v1 = uf_cx(v1, lane, s, true);
  }
  a0 = v0;
  a1 = v1;
}

// sort the warp's 32 keys (one a lane) descending
__device__ __forceinline__ u64 uf_sort32(u64 x) {
  const int lane = threadIdx.x & 31;
  for (int size = 2; size <= 32; size <<= 1)
    for (int s = size >> 1; s > 0; s >>= 1)
      x = uf_cx(x, lane, s, size == 32 || (lane & size) == 0);
  return x;
}

// the best 32 of two descending 32-sequences, descending
__device__ __forceinline__ u64 uf_merge32(u64 a, u64 c) {
  const int lane = threadIdx.x & 31;
  u64 v = uf_max(a, __shfl_sync(UF_FULL, c, 31 - lane));
  for (int s = 16; s > 0; s >>= 1) v = uf_cx(v, lane, s, true);
  return v;
}

// the warp's list after a full (or the last) candidate buffer: its nc
// keys sorted and merged in
struct UfTop {
  u64 t0, t1;
};
__device__ __forceinline__ UfTop uf_flush(const u64* cbuf, int nc,
                                          UfTop top) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  u64 c0 = lane < nc ? cbuf[lane] : 0ull;
  u64 c1 = 32 + lane < nc ? cbuf[32 + lane] : 0ull;
  __syncwarp();
  uf_sort64(c0, c1);
  uf_merge64(top.t0, top.t1, c0, c1);
  return top;
}

// kai_pymod(off, N) without a division where off is in [-N, 2N), as the
// jitter's offsets nearly always are
__device__ __forceinline__ int uf_mod(int off, int N) {
  const int m = off < 0 ? off + N : (off >= N ? off - N : off);
  return (unsigned)m < (unsigned)N ? m : kai_pymod(off, N);
}

// the warp's k-th best key (k <= 64)
__device__ __forceinline__ u64 uf_kth(u64 t0, u64 t1, int k) {
  return __shfl_sync(UF_FULL, k - 1 < 32 ? t0 : t1, (k - 1) & 31);
}

__device__ __forceinline__ unsigned uf_warp_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(UF_FULL, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// the lane's score of a node (ref scores0 of the hoisted branch), from
// its loaded rows
__device__ __forceinline__ float uf_score(bool fpn, float bands, float s,
                                          bool has_bias, float bias,
                                          float jit, int hoisted) {
  if (!fpn) return KAI_BIG_NEG;
  if (hoisted) {
    float score = __fadd_rn(__fadd_rn(bands, s), jit);
    if (has_bias) score = __fadd_rn(score, bias);
    return score;
  }
  float extra_bands = __fadd_rn(jit, s);
  if (has_bias) extra_bands = __fadd_rn(extra_bands, bias);
  return __fadd_rn(bands, extra_bands);
}

// node o's clamped replica capacity for this lane (ref lane_clamp)
__device__ __forceinline__ int uf_clamp(int c, bool mask, bool opn,
                                        const int* prior_b, int T, int o) {
  c = mask ? c : 0;
  if (opn) {
    for (int t = 0; t < T; ++t)
      if (prior_b[t] >= 0 && prior_b[t] == o) c = 0;
    c = min(c, 1);
  }
  return c;
}

// ref max_copies: replicas within every ancestor queue's cap
__device__ __forceinline__ float uf_heads(float m, const float* used,
                                          const float* cap, int q,
                                          const float* req) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float head =
        req[r] > KAI_EPS ? __fdiv_rn(__fsub_rn(cap[q * 3 + r], used[q * 3 + r]),
                                     fmaxf(req[r], KAI_EPS))
                         : INFINITY;
    m = fminf(m, floorf(__fadd_rn(head, KAI_EPS)));
  }
  return m;
}

// the queue gate: max_copies over the allocations and limits, and for a
// non-preemptible gang also over the non-preemptible allocations and
// quotas, in one pass with the Q x 3 heads split over a warp's lanes
// (fminf of floors: exact in any order)
__device__ __forceinline__ int uf_gate(const float* qa, const float* limit,
                                       const float* qan, const float* quota,
                                       const u8* anc, int Q,
                                       const float* req, bool nonpre) {
  float m = INFINITY, mn = INFINITY;
  for (int q = threadIdx.x & 31; q < Q; q += 32) {
    if (!anc[q]) continue;
    m = uf_heads(m, qa, limit, q, req);
    if (nonpre) mn = uf_heads(mn, qan, quota, q, req);
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fminf(m, __shfl_xor_sync(UF_FULL, m, off));
    mn = fminf(mn, __shfl_xor_sync(UF_FULL, mn, off));
  }
  const int g = static_cast<int>(fminf(fmaxf(m, 0.0f), 1e9f));
  return nonpre ? min(g, static_cast<int>(fminf(fmaxf(mn, 0.0f), 1e9f)))
                : g;
}

__global__ void __launch_bounds__(UF_THREADS, 2) uniform_fill_kernel(
    const int* __restrict__ cand, const int* __restrict__ prior,
    const int* __restrict__ quota_b, const float* __restrict__ qa,
    const float* __restrict__ qan, const float* __restrict__ limit_eff,
    const float* __restrict__ quota_eff, const u8* __restrict__ chain,
    const float* __restrict__ task_req0, const u8* __restrict__ task_valid,
    const int* __restrict__ gang_queue, const u8* __restrict__ preemptible,
    const int* __restrict__ anti_self, const int* __restrict__ task_type0,
    const int* __restrict__ task_class0, const u8* __restrict__ fi,
    const u8* __restrict__ fp, const int* __restrict__ ci,
    const int* __restrict__ cp, const float* __restrict__ sc,
    const float* __restrict__ soft, const u8* __restrict__ valid,
    const int* __restrict__ rows, const float* __restrict__ score_bias,
    const int* __restrict__ topology, const int* __restrict__ srl0,
    const int* __restrict__ dom_caps_y, const int* __restrict__ level_of_dom,
    const int* __restrict__ order, const int* __restrict__ pref_level,
    const float* __restrict__ free_, int T, int N, int Q, int NL, int dense,
    int stride, int hoisted, int qa_lanes, int valid_lanes, float jscale,
    float* __restrict__ qa2, float* __restrict__ qan2,
    int* __restrict__ nodes_t, u8* __restrict__ pipe_t,
    u8* __restrict__ success, float* __restrict__ free_rows,
    float* __restrict__ bind_rows) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int k = min(T, N);
  const int* prior_b = prior + (size_t)b * T;
  const float* qa_b = qa_lanes ? qa + (size_t)b * Q * 3 : qa;
  const float* bias_b = score_bias ? score_bias + (size_t)b * N : nullptr;
  const u8* valid_b = valid_lanes ? valid + (size_t)b * N : valid;
  __shared__ UfLane L;
  __shared__ int s_wcnt[UF_WARPS];
  __shared__ float s_wv[UF_WARPS];
  __shared__ int s_wi[UF_WARPS];
  __shared__ u64 s_cand[UF_WARPS][UF_MAXK];  // candidates, then lists
  __shared__ u64 s_keys[UF_WARPS][UF_ILP][32];  // a step's keys
  __shared__ u64 s_thr;
  __shared__ int s_fnode[UF_MAXK], s_frun[UF_MAXK], s_fpl[UF_MAXK];

  // ---- lane scalars and the queue gate (warp 0) ---------------------------
  if (warp == 0) {
    // every load of the gang's scalars first
    const int gi = cand[b];
    float req[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) req[r] = task_req0[gi * 3 + r];
    const int queue = gang_queue[gi];
    const bool nonpre = preemptible[gi] == 0;
    const int ty0 = rows ? rows[b] : task_type0[gi];
    const int cls0 = task_class0[gi];
    const bool opn = anti_self[gi] >= 0;
    const int quota = quota_b[b];
    const int srl = (dom_caps_y && srl0) ? srl0[gi] : -1;
    const int plv = pref_level ? pref_level[gi] : -1;
    // the gang's valid slots, the lane's prior placements and the first of
    // them, a lane a slot
    int tcount = 0, already = 0, first = -1;
    for (int tb = 0; tb < T; tb += 32) {
      const int t = tb + lane;
      const bool tv = t < T && task_valid[(size_t)gi * T + t];
      const int pr = t < T ? prior_b[t] : -1;
      tcount += __popc(__ballot_sync(UF_FULL, tv));
      const unsigned pb = __ballot_sync(UF_FULL, pr >= 0);
      already += __popc(pb);
      if (first < 0 && pb) first = __shfl_sync(UF_FULL, pr, __ffs(pb) - 1);
    }
    const int m = uf_gate(qa_b, limit_eff, qan, quota_eff,
                          chain + (size_t)queue * Q, Q, req, nonpre);
    if (lane == 0) {
      L.gi = gi;
      L.ty = ty0;
      L.cls = cls0;
      L.queue = queue;
      L.nonpre = nonpre;
      L.opn = opn;
#pragma unroll
      for (int r = 0; r < 3; ++r) L.req[r] = req[r];
      L.goal = min(quota, tcount - already);
      L.mgate = m;
      // required level: the domain the prior placements locked, else a
      // pick
      L.srl = srl;
      L.has_req = srl >= 0;
      L.target = -1;
      L.pick = false;
      if (L.has_req) {
        const int lvl = min(srl, NL - 1);
        const int prior_dom =
            first >= 0 ? topology[(size_t)first * NL + lvl] : -1;
        if (prior_dom >= 0)
          L.target = prior_dom;
        else
          L.pick = true;
      }
      L.pl = plv;
      L.pref_dom = -1;
      s_thr = 0ull;
    }
  }
  __syncthreads();
  const int ty = L.ty, cls = L.cls;
  const u8* fp_y = fp + (size_t)ty * N;
  const float* sc_y = sc + (size_t)ty * N;
  const float* soft_c = soft + (size_t)cls * N;
  const int ND = N * NL;

  // ---- required level: the (lane mod n_fit)-th fitting domain, fullest
  // first -------------------------------------------------------------------
  if (L.pick) {
    const int* caps = dom_caps_y + (size_t)task_type0[L.gi] * ND;
    const int thr = max(min(L.goal, L.mgate), 1);
    const int srl = L.srl;
    const int span = (ND + UF_THREADS - 1) / UF_THREADS * 32;
    const int lo = warp * span, hi = min(ND, lo + span);
    int cnt = 0;
    for (int base = lo; base < hi; base += 32) {
      const int p = base + lane;
      bool fs = false;
      if (p < hi) {
        const int d = order[p];
        fs = caps[d] >= thr && level_of_dom[d] == srl;
      }
      cnt += __popc(__ballot_sync(UF_FULL, fs));
    }
    if (lane == 0) s_wcnt[warp] = cnt;
    __syncthreads();
    int n_fit = 0, before = 0;
    for (int w = 0; w < UF_WARPS; ++w) {
      before += w < warp ? s_wcnt[w] : 0;
      n_fit += s_wcnt[w];
    }
    if (n_fit > 0) {
      const int sel = kai_pymod(b, n_fit) + 1;
      if (sel > before && sel <= before + cnt) {  // this warp holds it
        int running = before;
        for (int base = lo; base < hi; base += 32) {
          const int p = base + lane;
          bool fs = false;
          if (p < hi) {
            const int d = order[p];
            fs = caps[d] >= thr && level_of_dom[d] == srl;
          }
          const unsigned bal = __ballot_sync(UF_FULL, fs);
          if (running + __popc(bal) >= sel) {
            if (fs && running + __popc(bal & lt_mask) + 1 == sel)
              L.target = order[p];
            break;
          }
          running += __popc(bal);
        }
      }
    }
    __syncthreads();
  }
  const bool has_req = L.has_req;
  const int target = L.target;
  const int lvl_req = has_req ? min(L.srl, NL - 1) : 0;
#define UF_IN_DOM(o) \
  (!has_req || (target >= 0 && topology[(size_t)(o) * NL + lvl_req] == target))

  // ---- each warp's node range; the feasible count before it ---------------
  const int span = (N + UF_THREADS - 1) / UF_THREADS * 32;
  const int lo = warp * span, hi = min(N, lo + span);
  int before = 0;
  if (!dense) {
    int cnt = 0;
    for (int base = lo; base < hi; base += 32 * UF_ILP) {
      bool f[UF_ILP];
#pragma unroll
      for (int u = 0; u < UF_ILP; ++u) {
        const int n = base + 32 * u + lane;
        f[u] = n < hi && (fp_y[n] & valid_b[n]) && UF_IN_DOM(n);
      }
#pragma unroll
      for (int u = 0; u < UF_ILP; ++u)
        cnt += __popc(__ballot_sync(UF_FULL, f[u]));
    }
    if (lane == 0) s_wcnt[warp] = cnt;
    __syncthreads();
    for (int w = 0; w < warp; ++w) before += s_wcnt[w];
  }

  // ---- preferred level: the best node of the band-free scores -------------
  if (L.pl >= 0) {
    float best = -INFINITY;
    int best_i = INT_MAX;
    int running = before;
    for (int base = lo; base < hi; base += 32) {
      const int n = base + lane;
      const bool in = n < hi;
      const bool fpn = in && fp_y[n] && valid_b[n] && UF_IN_DOM(n);
      const float bands = in ? sc_y[n] : 0.0f, s = in ? soft_c[n] : 0.0f;
      const unsigned bal = __ballot_sync(UF_FULL, fpn);
      if (in) {
        const int off =
            dense ? n - b * stride : running + __popc(bal & lt_mask) + fpn - 1 - b;
        const float jit = __fmul_rn(jscale, (float)uf_mod(off, N));
        const float score = uf_score(fpn, bands, s, bias_b != nullptr,
                                     bias_b ? bias_b[n] : 0.0f, jit, hoisted);
        if (kai_better(score, n, best, best_i)) {
          best = score;
          best_i = n;
        }
      }
      running += __popc(bal);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(UF_FULL, best, off);
      const int i2 = __shfl_down_sync(UF_FULL, best_i, off);
      if (kai_better(v2, i2, best, best_i)) {
        best = v2;
        best_i = i2;
      }
    }
    if (lane == 0) {
      s_wv[warp] = best;
      s_wi[warp] = best_i;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < UF_WARPS; ++w)
        if (kai_better(s_wv[w], s_wi[w], best, best_i)) {
          best = s_wv[w];
          best_i = s_wi[w];
        }
      L.pref_dom = topology[(size_t)best_i * NL + L.pl];
    }
    __syncthreads();
  }
  const int pl = L.pl, pref_dom = L.pref_dom;

  // ---- scores and each warp's best 64 keys --------------------------------
  u64* cbuf = s_cand[warp];
  UfTop top = {0ull, 0ull};
  u64 thr = 0ull;
  int nc = 0;
  int running = before;
  for (int base = lo; base < hi; base += 32 * UF_ILP) {
    // every load of the step first, then the ranks, scores and keys
    bool fpn[UF_ILP];
    float bands[UF_ILP], sv[UF_ILP], bias[UF_ILP];
    int pdom[UF_ILP];
#pragma unroll
    for (int u = 0; u < UF_ILP; ++u) {
      const int n = base + 32 * u + lane;
      const bool in = n < hi;
      fpn[u] = in && (fp_y[n] & valid_b[n]) && UF_IN_DOM(n);
      bands[u] = in ? sc_y[n] : 0.0f;
      sv[u] = in ? soft_c[n] : 0.0f;
      bias[u] = in && bias_b ? bias_b[n] : 0.0f;
      pdom[u] = in && pl >= 0 ? topology[(size_t)n * NL + pl] : -1;
    }
#pragma unroll
    for (int u = 0; u < UF_ILP; ++u) {
      const int n = base + 32 * u + lane;
      const unsigned bal = __ballot_sync(UF_FULL, fpn[u]);
      u64 key = 0ull;
      if (n < hi) {
        const int off = dense ? n - b * stride
                              : running + __popc(bal & lt_mask) + fpn[u] - 1 - b;
        const float jit = __fmul_rn(jscale, (float)uf_mod(off, N));
        float score = uf_score(fpn[u], bands[u], sv[u], bias_b != nullptr,
                               bias[u], jit, hoisted);
        if (fpn[u] && pl >= 0)
          score = __fadd_rn(score, pdom[u] == pref_dom ? 10000.0f : 0.0f);
        key = uf_key(score, n);
      }
      s_keys[warp][u][lane] = key;
      running += __popc(bal);
    }
    // the step's keys through the filter, one 32-node step at a time (not
    // unrolled: one copy of the flush)
    u64 lim = uf_max(thr, *(volatile u64*)&s_thr);
#pragma unroll 1
    for (int u = 0; u < UF_ILP; ++u) {
      const u64 key = s_keys[warp][u][lane];
      const bool take = key > lim;
      const unsigned cb = __ballot_sync(UF_FULL, take);
      if (cb) {
        if (take) cbuf[nc + __popc(cb & lt_mask)] = key;
        nc += __popc(cb);
        if (nc >= 32) {
          top = uf_flush(cbuf, nc, top);
          nc = 0;
          thr = uf_kth(top.t0, top.t1, k);
          lim = uf_max(lim, thr);
          if (lane == 0) atomicMax(&s_thr, thr);
        }
      }
    }
  }
  if (nc > 0) top = uf_flush(cbuf, nc, top);
  __syncwarp();
  cbuf[lane] = top.t0;
  cbuf[32 + lane] = top.t1;

  // ---- the warps' lists merged in a tree ----------------------------------
  for (int step = 1; step < UF_WARPS; step <<= 1) {
    __syncthreads();
    if (warp % (2 * step) == 0 && warp + step < UF_WARPS) {
      if (k <= 32) {  // only the best 32 of each list can be chosen
        cbuf[lane] = uf_merge32(cbuf[lane], s_cand[warp + step][lane]);
      } else {
        u64 a0 = cbuf[lane], a1 = cbuf[32 + lane];
        uf_merge64(a0, a1, s_cand[warp + step][lane],
                   s_cand[warp + step][32 + lane]);
        cbuf[lane] = a0;
        cbuf[32 + lane] = a1;
      }
    }
  }
  __syncthreads();

  // ---- cumulative fill and node-ascending assignment (warp 0) -------------
  if (warp == 0) {
    const int want = min(L.goal, L.mgate);
    const bool opn = L.opn;
    int c[2], o[2];
    for (int h = 0; h < 2; ++h) {
      const int i = h * 32 + lane;
      o[h] = i < k ? uf_key_node(s_cand[0][i]) : -1;
      const bool feas = o[h] >= 0 && fp_y[o[h]] && valid_b[o[h]] &&
                        UF_IN_DOM(o[h]);
      c[h] = feas ? uf_clamp(cp[(size_t)ty * N + o[h]], true, opn, prior_b,
                             T, o[h])
                  : 0;
    }
    // int32 arithmetic, wrapping as the reference's cumsum
    const unsigned s0 = uf_warp_scan((unsigned)c[0]);
    const unsigned s1 =
        uf_warp_scan((unsigned)c[1]) + __shfl_sync(UF_FULL, s0, 31);
    const int cum = (int)__shfl_sync(UF_FULL, s1, 31);
    int placed[2];
    for (int h = 0; h < 2; ++h) {
      const int excl = (int)((h ? s1 : s0) - (unsigned)c[h]);
      placed[h] = min(max((int)((unsigned)want - (unsigned)excl), 0), c[h]);
    }
    const int total = min(cum, want);
    // the placed nodes by node id: descending keys of (2^31 - node, count)
    u64 x0 = placed[0] > 0 ? ((u64)(0x80000000u - (unsigned)o[0]) << 32) |
                                 (unsigned)placed[0]
                           : 0ull;
    u64 x1 = placed[1] > 0 ? ((u64)(0x80000000u - (unsigned)o[1]) << 32) |
                                 (unsigned)placed[1]
                           : 0ull;
    if (k <= 32)
      x0 = uf_sort32(x0);  // x1 is empty
    else
      uf_sort64(x0, x1);
    const int nch = __popc(__ballot_sync(UF_FULL, x0 != 0ull)) +
                    __popc(__ballot_sync(UF_FULL, x1 != 0ull));
    const int p0 = (int)(unsigned)x0, p1 = (int)(unsigned)x1;
    const unsigned r0 = uf_warp_scan((unsigned)p0);
    const unsigned r1 =
        uf_warp_scan((unsigned)p1) + __shfl_sync(UF_FULL, r0, 31);
    s_fnode[lane] = (int)(0x80000000u - (unsigned)(x0 >> 32));
    s_fnode[32 + lane] = (int)(0x80000000u - (unsigned)(x1 >> 32));
    s_fpl[lane] = p0;
    s_fpl[32 + lane] = p1;
    s_frun[lane] = (int)r0;
    s_frun[32 + lane] = (int)r1;
    __syncwarp();
    const int gi = L.gi;
    int elig_base = 0;
    for (int tb = 0; tb < T; tb += 32) {
      const int t = tb + lane;
      const bool elig =
          t < T && task_valid[(size_t)gi * T + t] && prior_b[t] < 0;
      const unsigned eb = __ballot_sync(UF_FULL, elig);
      const int npos = elig ? elig_base + __popc(eb & lt_mask) : T;
      elig_base += __popc(eb);
      if (t >= T) continue;
      // the first placed node whose running replica count passes npos
      int a = 0, z = nch;
      while (a < z) {
        const int mid = (a + z) >> 1;
        if (s_frun[mid] > npos)
          z = mid;
        else
          a = mid + 1;
      }
      const int node = a < nch ? s_fnode[a] : -1;
      const int cum_at = a < nch ? s_frun[a] : 0;
      const int ppn = a < nch ? s_fpl[a] : 0;
      const bool placed_t = elig && npos < total && node >= 0;
      bool pipe = false;
      int c_idle = 0;
      if (placed_t) {
        const size_t oo = (size_t)ty * N + node;
        const bool in_dom = UF_IN_DOM(node);
        const bool fit_pipe = fp[oo] && valid_b[node] && in_dom;
        const bool fit_idle = fi[oo] && valid_b[node] && in_dom;
        const int c_pipe = uf_clamp(cp[oo], fit_pipe, opn, prior_b, T, node);
        c_idle =
            min(uf_clamp(ci[oo], fit_idle, opn, prior_b, T, node), c_pipe);
        pipe = (npos - (cum_at - ppn)) >= c_idle;
      }
      nodes_t[(size_t)b * T + t] = placed_t ? node : -1;
      pipe_t[(size_t)b * T + t] = pipe ? 1 : 0;
      if (free_rows) {
        const size_t ro = ((size_t)b * T + t) * 3;
        const float cnt = (float)ppn, bcnt = (float)min(ppn, c_idle);
        for (int r = 0; r < 3; ++r) {
          free_rows[ro + r] =
              placed_t ? __fsub_rn(free_[(size_t)node * 3 + r],
                                   __fmul_rn(cnt, L.req[r]))
                       : 0.0f;
          bind_rows[ro + r] = placed_t ? __fmul_rn(bcnt, L.req[r]) : 0.0f;
        }
      }
    }
    if (lane == 0) {
      L.total = total;
      success[b] = (L.goal > 0 && total >= L.goal) ? 1 : 0;
    }
  }
  __syncthreads();

  // ---- queue deltas along the ancestor chain ------------------------------
  const u8* anc = chain + (size_t)L.queue * Q;
  for (int idx = tid; idx < Q * 3; idx += UF_THREADS) {
    const int q = idx / 3, r = idx % 3;
    const float d = __fmul_rn(anc[q] ? 1.0f : 0.0f,
                              __fmul_rn((float)L.total, L.req[r]));
    qa2[(size_t)b * Q * 3 + idx] = __fadd_rn(qa_b[idx], d);
    qan2[(size_t)b * Q * 3 + idx] = __fadd_rn(qan[idx], L.nonpre ? d : 0.0f);
  }
}

KAI_EXPORT int kai_uniform_fill(
    const int* cand, const int* prior, const int* quota_b, const float* qa,
    const float* qan, const float* limit_eff, const float* quota_eff,
    const u8* chain, const float* task_req0, const u8* task_valid,
    const int* gang_queue, const u8* preemptible, const int* anti_self,
    const int* task_type0, const int* task_class0, const u8* fi, const u8* fp,
    const int* ci, const int* cp, const float* sc, const float* soft,
    const u8* valid, const int* rows, const float* score_bias,
    const int* topology, const int* srl0, const int* dom_caps_y,
    const int* level_of_dom, const int* order, const int* pref_level,
    const float* free_, int B, int T, int N, int Q, int Y, int G, int X,
    int L, int dense, int stride, int hoisted, int qa_lanes,
    int valid_lanes, float jscale, float* qa2, float* qan2, int* nodes_t,
    u8* pipe_t, u8* success, float* free_rows, float* bind_rows,
    cudaStream_t stream) {
  if (B < 1 || T < 1 || N < 1 || Q < 1 || Y < 1 || G < 1 || X < 1 ||
      (T < N ? T : N) > UF_MAXK)
    return KAI_ERR_ARGS;
  const bool topo = dom_caps_y || pref_level;
  if ((topo && (!topology || L < 1)) ||
      (dom_caps_y && (!srl0 || !level_of_dom || !order)) ||
      ((free_ != nullptr) != (free_rows != nullptr)) ||
      ((free_rows != nullptr) != (bind_rows != nullptr)))
    return KAI_ERR_ARGS;
  uniform_fill_kernel<<<B, UF_THREADS, 0, stream>>>(
      cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain, task_req0,
      task_valid, gang_queue, preemptible, anti_self, task_type0, task_class0,
      fi, fp, ci, cp, sc, soft, valid, rows, score_bias, topology, srl0,
      dom_caps_y, level_of_dom, order, pref_level, free_, T, N, Q,
      topo ? L : 1, dense, stride, hoisted, qa_lanes, valid_lanes, jscale,
      qa2, qan2, nodes_t, pipe_t, success, free_rows, bind_rows);
  return static_cast<int>(cudaGetLastError());
}
