// K3 uniform_fill — the whole-gang placement of every wavefront lane.
//
// Replaces kai_scheduler_tpu/ops/allocate.py:915
// `_attempt_gang_in_domain_uniform` under the chunk's lane vmap (:1690),
// in its sparse-output, hoisted-type-table form: per lane the ancestor
// queue gate `max_copies`, the lane clamp, the tie jitter (both the dense
// rotation and the rank-within-feasible branch), a top-k of T over the N
// nodes in lax.top_k order (score descending, lower node index first
// among ties), the cumulative fill, the node-ascending replica
// assignment, the pipeline flags, the queue deltas and `success`.
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
};

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
    const int* __restrict__ rows, const float* __restrict__ score_bias, int T,
    int N, int Q, int dense, int stride, int hoisted, int qa_lanes,
    float jscale, float* __restrict__ qa2, float* __restrict__ qan2,
    int* __restrict__ nodes_t, u8* __restrict__ pipe_t,
    u8* __restrict__ success) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int k = min(T, N);
  const int* prior_b = prior + (size_t)b * T;
  const float* qa_b = qa_lanes ? qa + (size_t)b * Q * 3 : qa;
  const float* bias_b = score_bias ? score_bias + (size_t)b * N : nullptr;
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
  }
  __syncthreads();
  const int ty = L.ty, cls = L.cls;
  const u8* fp_y = fp + (size_t)ty * N;
  const float* sc_y = sc + (size_t)ty * N;
  const float* soft_c = soft + (size_t)cls * N;

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
    const bool fpn = n < N && fp_y[n] && valid[n];
    int tile_total = 0;
    int incl = 0;
    if (!dense) incl = uf_block_scan(fpn ? 1 : 0, &tile_total);
    if (n < N) {
      const int off = dense ? n - b * stride : running + incl - 1 - b;
      const float jit = __fmul_rn(jscale, (float)kai_pymod(off, N));
      float score = KAI_BIG_NEG;
      if (fpn) {
        const float bands = sc_y[n], s = soft_c[n];
        if (hoisted) {
          score = __fadd_rn(__fadd_rn(bands, s), jit);
          if (bias_b) score = __fadd_rn(score, bias_b[n]);
        } else {
          float extra_bands = __fadd_rn(jit, s);
          if (bias_b) extra_bands = __fadd_rn(extra_bands, bias_b[n]);
          score = __fadd_rn(bands, extra_bands);
        }
      }
      if (kai_better(score, n, tv[k - 1], ti[k - 1])) {
        int j = k - 1;
        while (j > 0 && kai_better(score, n, tv[j - 1], ti[j - 1])) {
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
      if (kai_better(v2, i2, v, ix)) {
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
        if (kai_better(s_wv[w], s_wi[w], v, ix)) {
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
      const bool feas = fp_y[o] && valid[o];
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
      if (placed_t) {
        const size_t o = (size_t)ty * N + node;
        const bool fit_pipe = fp[o] && valid[node];
        const bool fit_idle = fi[o] && valid[node];
        const int c_pipe = uf_clamp(cp[o], fit_pipe, L.opn, prior_b, T, node);
        const int c_idle =
            min(uf_clamp(ci[o], fit_idle, L.opn, prior_b, T, node), c_pipe);
        pipe = (npos - (cum_at - ppn)) >= c_idle;
      }
      nodes_t[(size_t)b * T + t] = placed_t ? node : -1;
      pipe_t[(size_t)b * T + t] = pipe ? 1 : 0;
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
    const u8* valid, const int* rows, const float* score_bias, int B, int T,
    int N, int Q, int Y, int G, int X, int dense, int stride, int hoisted,
    int qa_lanes, float jscale, float* qa2, float* qan2, int* nodes_t,
    u8* pipe_t, u8* success, cudaStream_t stream) {
  if (B < 1 || T < 1 || N < 1 || Q < 1 || Y < 1 || G < 1 || X < 1 ||
      (T < N ? T : N) > UF_MAXK)
    return KAI_ERR_ARGS;
  uniform_fill_kernel<<<B, UF_THREADS, 0, stream>>>(
      cand, prior, quota_b, qa, qan, limit_eff, quota_eff, chain, task_req0,
      task_valid, gang_queue, preemptible, anti_self, task_type0, task_class0,
      fi, fp, ci, cp, sc, soft, valid, rows, score_bias, T, N, Q, dense,
      stride, hoisted, qa_lanes, jscale, qa2, qan2, nodes_t, pipe_t, success);
  return static_cast<int>(cudaGetLastError());
}
