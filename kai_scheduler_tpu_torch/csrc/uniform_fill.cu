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
// One block per lane.  The block walks the node axis in tiles of
// UF_THREADS consecutive nodes (one block-wide scan per tile gives the
// feasible rank the jitter needs), each thread keeping its own sorted
// top-k in local memory; k rounds of a block-wide argmax then merge the
// per-thread lists.  The fill and the assignment touch only the k chosen
// nodes and run on one thread.  Ties decide placements on an empty
// cluster (every node scores alike and the jitter of about 1e-8 is below
// the f32 spacing of the ~109-point scores), so the tie order is part of
// the contract.
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
// :1135-1139):
//   - required level (dom_caps_y given, the gang's srl0 >= 0): the lane
//     counts the domains of that level whose live replica capacity holds
//     min(goal, queue gate) replicas, walking them fullest first (`order`,
//     the chunk's stable sort of the domain aggregates), and takes the
//     (lane mod n_fit)-th with a block-wide scan — or the domain its prior
//     placements locked.  Feasibility, replica counts and the jitter's
//     feasible rank are confined to that domain; with no domain the gang
//     places nothing.
//   - preferred level (pref_level given, the gang's level >= 0): a first
//     pass takes the block argmax of the scores (lowest node on ties, as
//     jnp.argmax); the second adds W_TOPOLOGY on the feasible nodes that
//     share that node's domain at the level before the top-k.
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
// Bound: the per-lane work is a read of the lane type's [N] fit/band rows
// and soft-score row (~10 bytes per node, shared by the lanes of one type
// through L2) and a handful of flops per node; with B lanes it is
// latency- and occupancy-bound long before bytes or flops.
#include "kai_common.cuh"

#define UF_THREADS 256
#define UF_WARPS (UF_THREADS / 32)
#define UF_MAXK 64

// inclusive block scan of one int per thread; returns the inclusive value
// and the block total in *total.  Every thread must call it.
__device__ int uf_block_scan(int v, int* total) {
  __shared__ int s_warp[UF_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int base = 0, tot = 0;
  for (int w = 0; w < UF_WARPS; ++w) {
    const int sw = s_warp[w];
    if (w < warp) base += sw;
    tot += sw;
  }
  __syncthreads();
  *total = tot;
  return base + x;
}

struct UfLane {
  int gi, ty, cls, queue, goal, mgate, total;
  bool nonpre, opn;
  float req[3];
  // topology: required level and its target domain (-1: none fits), the
  // preferred level and the best node's domain there
  int srl, target, pl, pref_dom;
  bool has_req, pick;
  int n_fit;
};

// the lane's score of node n (ref scores0 of the hoisted branch)
__device__ __forceinline__ float uf_score(bool fpn, const float* sc_y,
                                          const float* soft_c,
                                          const float* bias_b, int n,
                                          float jit, int hoisted) {
  if (!fpn) return KAI_BIG_NEG;
  const float bands = sc_y[n], s = soft_c[n];
  if (hoisted) {
    float score = __fadd_rn(__fadd_rn(bands, s), jit);
    if (bias_b) score = __fadd_rn(score, bias_b[n]);
    return score;
  }
  float extra_bands = __fadd_rn(jit, s);
  if (bias_b) extra_bands = __fadd_rn(extra_bands, bias_b[n]);
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
__device__ int uf_max_copies(const float* used, const float* cap,
                             const u8* anc, int Q, const float* req) {
  float m = INFINITY;
  for (int q = 0; q < Q; ++q) {
    for (int r = 0; r < 3; ++r) {
      float head = req[r] > KAI_EPS
                       ? __fdiv_rn(__fsub_rn(cap[q * 3 + r], used[q * 3 + r]),
                                   fmaxf(req[r], KAI_EPS))
                       : INFINITY;
      head = anc[q] ? head : INFINITY;
      m = fminf(m, floorf(__fadd_rn(head, KAI_EPS)));
    }
  }
  return static_cast<int>(fminf(fmaxf(m, 0.0f), 1e9f));
}

__global__ void __launch_bounds__(UF_THREADS) uniform_fill_kernel(
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
  const int tid = threadIdx.x;
  const int k = min(T, N);
  const int* prior_b = prior + (size_t)b * T;
  const float* qa_b = qa_lanes ? qa + (size_t)b * Q * 3 : qa;
  const float* bias_b = score_bias ? score_bias + (size_t)b * N : nullptr;
  const u8* valid_b = valid_lanes ? valid + (size_t)b * N : valid;
  __shared__ UfLane L;
  __shared__ int s_order[UF_MAXK];
  __shared__ float s_wv[UF_WARPS];
  __shared__ int s_wi[UF_WARPS];

  // ---- lane scalars and the queue gate ----------------------------------
  if (tid == 0) {
    const int gi = cand[b];
    L.gi = gi;
    L.ty = rows ? rows[b] : task_type0[gi];
    L.cls = task_class0[gi];
    L.queue = gang_queue[gi];
    L.nonpre = preemptible[gi] == 0;
    L.opn = anti_self[gi] >= 0;
    for (int r = 0; r < 3; ++r) L.req[r] = task_req0[gi * 3 + r];
    int tcount = 0, already = 0;
    for (int t = 0; t < T; ++t) {
      tcount += task_valid[(size_t)gi * T + t] ? 1 : 0;
      already += prior_b[t] >= 0 ? 1 : 0;
    }
    L.goal = min(quota_b[b], tcount - already);
    const u8* anc = chain + (size_t)L.queue * Q;
    int m = uf_max_copies(qa_b, limit_eff, anc, Q, L.req);
    if (L.nonpre) m = min(m, uf_max_copies(qan, quota_eff, anc, Q, L.req));
    L.mgate = m;
    // required level: the domain the prior placements locked, else a pick
    L.srl = (dom_caps_y && srl0) ? srl0[gi] : -1;
    L.has_req = L.srl >= 0;
    L.target = -1;
    L.pick = false;
    if (L.has_req) {
      int first = -1;
      for (int t = 0; t < T && first < 0; ++t)
        if (prior_b[t] >= 0) first = prior_b[t];
      const int lvl = min(L.srl, NL - 1);
      const int prior_dom = first >= 0 ? topology[(size_t)first * NL + lvl]
                                       : -1;
      if (prior_dom >= 0)
        L.target = prior_dom;
      else
        L.pick = true;
    }
    L.pl = pref_level ? pref_level[gi] : -1;
    L.pref_dom = -1;
  }
  __syncthreads();
  const int ty = L.ty, cls = L.cls;
  const u8* fp_y = fp + (size_t)ty * N;
  const float* sc_y = sc + (size_t)ty * N;
  const float* soft_c = soft + (size_t)cls * N;
  const int ND = N * NL;

  // ---- required level: the (lane mod n_fit)-th fitting domain, fullest
  // first ------------------------------------------------------------------
  if (L.pick) {
    const int* caps = dom_caps_y + (size_t)task_type0[L.gi] * ND;
    const int thr = max(min(L.goal, L.mgate), 1);
    const int srl = L.srl;
    int n_fit = 0;
    for (int base = 0; base < ND; base += UF_THREADS) {
      const int p = base + tid;
      bool fs = false;
      if (p < ND) {
        const int d = order[p];
        fs = caps[d] >= thr && level_of_dom[d] == srl;
      }
      n_fit += __syncthreads_count(fs);
    }
    if (n_fit > 0) {
      const int sel = kai_pymod(b, n_fit) + 1;
      int running = 0;
      for (int base = 0; base < ND; base += UF_THREADS) {
        const int p = base + tid;
        bool fs = false;
        if (p < ND) {
          const int d = order[p];
          fs = caps[d] >= thr && level_of_dom[d] == srl;
        }
        int tile = 0;
        const int incl = uf_block_scan(fs ? 1 : 0, &tile);
        if (fs && running + incl == sel) L.target = order[p];
        running += tile;
        if (running >= sel) break;  // uniform across the block
      }
    }
    __syncthreads();
  }
  const bool has_req = L.has_req;
  const int target = L.target;
  const int lvl_req = has_req ? min(L.srl, NL - 1) : 0;
#define UF_IN_DOM(o) \
  (!has_req || (target >= 0 && topology[(size_t)(o) * NL + lvl_req] == target))

  // ---- preferred level: the best node of the band-free scores ------------
  if (L.pl >= 0) {
    float best = -INFINITY;
    int best_i = INT_MAX;
    int running = 0;
    for (int base = 0; base < N; base += UF_THREADS) {
      const int n = base + tid;
      const bool fpn = n < N && fp_y[n] && valid_b[n] && UF_IN_DOM(n);
      int tile_total = 0, incl = 0;
      if (!dense) incl = uf_block_scan(fpn ? 1 : 0, &tile_total);
      if (n < N) {
        const int off = dense ? n - b * stride : running + incl - 1 - b;
        const float jit = __fmul_rn(jscale, (float)kai_pymod(off, N));
        const float score = uf_score(fpn, sc_y, soft_c, bias_b, n, jit,
                                     hoisted);
        if (kai_better(score, n, best, best_i)) {
          best = score;
          best_i = n;
        }
      }
      running += tile_total;
    }
    const int lane_w = tid & 31, warp_w = tid >> 5;
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, best, off);
      const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
      if (kai_better(v2, i2, best, best_i)) {
        best = v2;
        best_i = i2;
      }
    }
    if (lane_w == 0) {
      s_wv[warp_w] = best;
      s_wi[warp_w] = best_i;
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

  // ---- scores and the per-thread top-k ------------------------------------
  float tv[UF_MAXK];
  int ti[UF_MAXK];
  for (int i = 0; i < k; ++i) {
    tv[i] = -INFINITY;
    ti[i] = INT_MAX;
  }
  int running = 0;  // feasible nodes before this tile
  for (int base = 0; base < N; base += UF_THREADS) {
    const int n = base + tid;
    const bool fpn = n < N && fp_y[n] && valid_b[n] && UF_IN_DOM(n);
    int tile_total = 0;
    int incl = 0;
    if (!dense) incl = uf_block_scan(fpn ? 1 : 0, &tile_total);
    if (n < N) {
      const int off = dense ? n - b * stride : running + incl - 1 - b;
      const float jit = __fmul_rn(jscale, (float)kai_pymod(off, N));
      float score = uf_score(fpn, sc_y, soft_c, bias_b, n, jit, hoisted);
      if (fpn && pl >= 0)
        score = __fadd_rn(score, topology[(size_t)n * NL + pl] == pref_dom
                                     ? 10000.0f
                                     : 0.0f);
      if (kai_topk_better(score, n, tv[k - 1], ti[k - 1])) {
        int j = k - 1;
        while (j > 0 && kai_topk_better(score, n, tv[j - 1], ti[j - 1])) {
          tv[j] = tv[j - 1];
          ti[j] = ti[j - 1];
          --j;
        }
        tv[j] = score;
        ti[j] = n;
      }
    }
    running += tile_total;
  }

  // ---- merge: k rounds of a block-wide argmax over the list heads ---------
  const int lane = tid & 31, warp = tid >> 5;
  int head = 0;
  for (int i = 0; i < k; ++i) {
    float v = head < k ? tv[head] : -INFINITY;
    int ix = head < k ? ti[head] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, v, off);
      const int i2 = __shfl_down_sync(0xffffffffu, ix, off);
      if (kai_topk_better(v2, i2, v, ix)) {
        v = v2;
        ix = i2;
      }
    }
    if (lane == 0) {
      s_wv[warp] = v;
      s_wi[warp] = ix;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < UF_WARPS; ++w)
        if (kai_topk_better(s_wv[w], s_wi[w], v, ix)) {
          v = s_wv[w];
          ix = s_wi[w];
        }
      s_order[i] = ix;
    }
    __syncthreads();
    if (head < k && ti[head] == s_order[i]) ++head;
  }

  // ---- cumulative fill and node-ascending assignment (one thread) --------
  if (tid == 0) {
    const int want = min(L.goal, L.mgate);
    int cnode[UF_MAXK], cplaced[UF_MAXK];
    int nch = 0;
    unsigned int cum = 0;  // int32 arithmetic, wrapping as the reference's
    for (int i = 0; i < k; ++i) {
      const int o = s_order[i];
      const bool feas = fp_y[o] && valid_b[o] && UF_IN_DOM(o);
      const int c = feas ? uf_clamp(cp[(size_t)ty * N + o], feas, L.opn,
                                    prior_b, T, o)
                         : 0;
      const int excl = (int)cum;
      cum += (unsigned int)c;
      const int placed = min(max(want - excl, 0), c);
      if (placed > 0) {
        // insert by node id (ascending)
        int j = nch++;
        while (j > 0 && cnode[j - 1] > o) {
          cnode[j] = cnode[j - 1];
          cplaced[j] = cplaced[j - 1];
          --j;
        }
        cnode[j] = o;
        cplaced[j] = placed;
      }
    }
    const int total = min((int)cum, want);
    L.total = total;
    const int gi = L.gi;
    int elig_rank = 0;
    for (int t = 0; t < T; ++t) {
      const bool elig = task_valid[(size_t)gi * T + t] && prior_b[t] < 0;
      const int npos = elig ? elig_rank++ : T;
      int node = -1, cum_at = 0, ppn = 0, run = 0;
      for (int j = 0; j < nch; ++j) {
        run += cplaced[j];
        if (run > npos) {
          node = cnode[j];
          cum_at = run;
          ppn = cplaced[j];
          break;
        }
      }
      const bool placed_t = elig && npos < total && node >= 0;
      bool pipe = false;
      int c_idle = 0;
      if (placed_t) {
        const size_t o = (size_t)ty * N + node;
        const bool in_dom = UF_IN_DOM(node);
        const bool fit_pipe = fp[o] && valid_b[node] && in_dom;
        const bool fit_idle = fi[o] && valid_b[node] && in_dom;
        const int c_pipe = uf_clamp(cp[o], fit_pipe, L.opn, prior_b, T, node);
        c_idle =
            min(uf_clamp(ci[o], fit_idle, L.opn, prior_b, T, node), c_pipe);
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
    success[b] = (L.goal > 0 && total >= L.goal) ? 1 : 0;
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
