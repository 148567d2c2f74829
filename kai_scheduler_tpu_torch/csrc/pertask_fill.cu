// K9 pertask_fill — the per-task placement of every wavefront lane.
//
// Replaces kai_scheduler_tpu/ops/allocate.py:517 `_attempt_gang_in_domain`
// under the allocate chunk's lane vmap (:1699), without the
// subgroup-topology and extended branches (the port refuses both): per lane
// the re-push protocol's subgroup quorum and eligible task set (:619-646),
// the hoisted queue prefix gates (:670-696), anti-self domains (:586-608),
// then the T task steps in order, each one block-wide pass pair over the N
// nodes:
//   1. dual feasibility against the lane's LIVE pools (`feasible_nodes_dual`
//      predicates.py:168 with the device pool check `_accel_pool_ok` :82),
//      the anti-self mask, and the block-wide min/max of the binpack/spread
//      density range;
//   2. the integer prefix count of fit_pipe (the tie jitter's feasible
//      rank), the score in the reference's f32 order — ((0 + placement) +
//      resourcetype) + availability, plus ((((topology + jitter) + soft) +
//      nominated) + gpusharingorder) — and a block argmax that takes the
//      lowest node on ties, as jnp.argmax does;
//   3. one thread's bookkeeping on the chosen node: `pick_device` for a
//      fraction (scoring.py:66), the whole-device rank-and-take (:809-817),
//      the node debit at the node's own portion, the canonical queue debit,
//      bind-now vs pipelined claims (:819-850).
//
// The lane's live pools are the chunk-start pools with its own claims
// applied in task order.  A lane touches at most T nodes, so those rows
// (free, device free, bind-now and device bind-now) live in shared memory
// and every other node reads the chunk-start pools: no per-lane copy of
// [N, R] or [N, D].  The lane emits, per task slot, its node, device,
// pipeline flag, and the FINAL rows of the node it took (the dense accept,
// K10, needs free - free2, which is not the sum of the task deltas in f32).
//
// The subgroup-topology mode (dom_ptr given; ref :650-668, :729-760,
// :855-866, :878-882): a first launch sums the chunk-start pools (idle +
// releasing + victim-freed) per domain, each domain's nodes in ascending
// order from +0.0 (XLA:CPU's scatter-add order: memory and CPU carry
// fractions), into row B of a global scratch, [B + 1, ND + 1, 3] (180 KB
// a row at 5,000 nodes x 3 levels: no room in shared memory), and copies
// it into every active lane's row; with `agg_ready` (the chunk's retry
// launch, on the scratch of its first) row B already holds the table and
// is only copied, into the retried lanes' rows.  Each lane keeps its
// subgroups' locks and remaining requests in shared memory.  A task step
// of a subgroup with a required level is confined to its locked domain;
// its first placement needs a domain whose aggregate still holds the
// subgroup's remaining request (and is not the one `banned` names), and
// gets the domain-binpack band W_TOPOLOGY * (1 - agg / max(mx, EPS)) with
// mx the block max of the fitting domains' aggregates — the pass that
// builds the fit bits takes that max too.  The chosen node's domain at
// every level loses the placement in the lane's scratch row.  `active`
// runs only the lanes of the in-cycle retry (ref :1274-1289), each block
// with its own lane index; the other blocks return at once and leave
// their outputs as they were.
//
// The mask mode (`lane_mask` [B, N], the affinity gates' node mask, K12):
// each block reads its lane's row into the nodes it may use, `allowed =
// domain_mask & ~forbidden` (ref :720 with domain_mask = n.valid & mask,
// :1259), in both launches of a chunk; it composes with the subgroup
// domains, the banned retry and the device table.
//
// Bound: per task step each block reads the node pools, labels, filter and
// soft rows (~150 bytes a node with 8 devices, shared by every lane through
// L2) and does a few hundred f32 operations a node; it is latency- and
// L2-bound, two passes over N per step.  A simple, right kernel first.
#include "kai_common.cuh"

#define PF_THREADS 256
#define PF_WARPS (PF_THREADS / 32)
#define PF_MAXT 64
#define PF_MAXD 32
#define PF_MAXS 32
// 1.0 - EPS and friends as the reference's weak-typed Python floats round
// them to f32
#define PF_ONE_M_EPS ((float)(1.0 - 1e-6))

struct PfTouch {
  int node;
  float free[3], bind[3];
  float dev[PF_MAXD], dbind[PF_MAXD];
};

struct PfLane {
  int gi, queue, asl, pl, goal, count, pref_dom, ntouch, nforbid;
  bool nonpre, has_asl, has_pref;
  float q_delta[3];
  // task step scalars
  float req[3], por, mem;
  int cls, nom, node;
  bool is_frac, any_fp;
  float mn, mx;
  // subgroup topology: the step's subgroup, its level's column, its lock,
  // its banned domain, and the block max of the fitting domains' accel
  int sub, lvl, locked, banned;
  bool has_srl, needs_pick;
  float dmx;
  // the subgroups' locked domains and remaining requests
  int sub_dom[PF_MAXS];
  float sub_rem[PF_MAXS][3];
};

// the chunk-start domain aggregate (row B of the scratch; summed unless
// `ready`), copied into every active lane's row
__global__ void __launch_bounds__(PF_THREADS) pf_domain_agg_kernel(
    const int* __restrict__ dom_ptr, const int* __restrict__ dom_nodes,
    const float* __restrict__ free0, const float* __restrict__ rel,
    const float* __restrict__ extra, const u8* __restrict__ active, int B,
    int ND, int ready, float* __restrict__ agg) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d > ND) return;
  float* start = agg + ((size_t)B * (ND + 1) + d) * 3;
  float a[3] = {0.0f, 0.0f, 0.0f};
  if (ready) {
    for (int r = 0; r < 3; ++r) a[r] = start[r];
  } else {
    if (d < ND)  // the junk row ND is never read: it stays zero
      for (int j = dom_ptr[d]; j < dom_ptr[d + 1]; ++j) {
        const size_t o = (size_t)dom_nodes[j] * 3;
        for (int r = 0; r < 3; ++r)
          a[r] = __fadd_rn(a[r], __fadd_rn(__fadd_rn(free0[o + r],
                                                     rel[o + r]),
                                           extra[o + r]));
      }
    for (int r = 0; r < 3; ++r) start[r] = a[r];
  }
  for (int b = 0; b < B; ++b) {
    if (active && !active[b]) continue;
    float* row = agg + ((size_t)b * (ND + 1) + d) * 3;
    for (int r = 0; r < 3; ++r) row[r] = a[r];
  }
}

// inclusive block scan of one int per thread; the block total in *total
__device__ int pf_block_scan(int v, int* total) {
  __shared__ int s_warp[PF_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int base = 0, tot = 0;
  for (int w = 0; w < PF_WARPS; ++w) {
    const int sw = s_warp[w];
    if (w < warp) base += sw;
    tot += sw;
  }
  __syncthreads();
  *total = tot;
  return base + x;
}

// the node's effective share of one device (predicates.node_portion)
__device__ __forceinline__ float pf_portion(float por, float mem,
                                            const float* dev_mem, int n) {
  return mem > 0.0f ? __fdiv_rn(mem, fmaxf(dev_mem[n], KAI_EPS))
                    : __fmul_rn(por, 1.0f);
}

// _accel_pool_ok: one device with enough share for a fraction, enough
// fully free devices for whole-device tasks
__device__ __forceinline__ bool pf_pool_ok(const float* df, int D, float p,
                                           bool is_frac, float req_accel) {
  if (is_frac) {
    float m = -INFINITY;
    for (int d = 0; d < D; ++d) m = fmaxf(m, df[d]);
    return m >= __fsub_rn(p, KAI_EPS);
  }
  float whole = 0.0f;
  for (int d = 0; d < D; ++d) whole += df[d] >= PF_ONE_M_EPS ? 1.0f : 0.0f;
  return __fadd_rn(whole, KAI_EPS) >= req_accel;
}

__global__ void __launch_bounds__(PF_THREADS) pertask_fill_kernel(
    // gangs
    const float* __restrict__ task_req, const u8* __restrict__ task_valid,
    const int* __restrict__ task_sel, const float* __restrict__ task_portion,
    const float* __restrict__ task_mem, const int* __restrict__ task_class,
    const int* __restrict__ task_nom, const int* __restrict__ task_sub,
    const int* __restrict__ sub_need, const int* __restrict__ min_needed,
    const int* __restrict__ gang_queue, const u8* __restrict__ preemptible,
    const int* __restrict__ anti_self, const int* __restrict__ pref_level,
    // nodes
    const float* __restrict__ free0, const float* __restrict__ dev0,
    const float* __restrict__ rel, const float* __restrict__ extra,
    const float* __restrict__ dev_rel, const float* __restrict__ extra_dev,
    const float* __restrict__ alloc, const u8* __restrict__ valid,
    const int* __restrict__ labels, const u8* __restrict__ fmask,
    const float* __restrict__ soft, const float* __restrict__ dev_mem,
    const int* __restrict__ topology,
    // queues
    const float* __restrict__ qa, const float* __restrict__ qan,
    const float* __restrict__ limit_eff, const float* __restrict__ quota_eff,
    const u8* __restrict__ chain,
    // lanes
    const int* __restrict__ cand, const int* __restrict__ prior,
    // subgroup topology
    const int* __restrict__ srl, const int* __restrict__ banned,
    const u8* __restrict__ active, const u8* __restrict__ lane_mask,
    float* __restrict__ agg_all, int T, int N, int D, int K, int L, int S,
    int Q, int binpack_accel, int binpack_cpu,
    int device_pack, int track, float jscale,
    // outputs
    float* __restrict__ qa2, float* __restrict__ qan2,
    int* __restrict__ nodes_t, int* __restrict__ dev_t,
    u8* __restrict__ pipe_t, u8* __restrict__ success,
    float* __restrict__ free_rows, float* __restrict__ dev_rows,
    float* __restrict__ bind_rows, float* __restrict__ devbind_rows,
    int* __restrict__ sub_dom_out) {
  extern __shared__ u8 s_flags[];  // [N]: bit 0 fit_idle, bit 1 fit_pipe
  __shared__ PfLane Ln;
  __shared__ PfTouch s_touch[PF_MAXT];
  __shared__ int s_forbid[2 * PF_MAXT];
  __shared__ bool s_elig[PF_MAXT], s_gate[PF_MAXT];
  __shared__ float s_wf[PF_WARPS], s_wg[PF_WARPS], s_wd[PF_WARPS];
  __shared__ int s_wi[PF_WARPS];
  const int b = blockIdx.x;
  if (active && !active[b]) return;  // not a retried lane: keep its output
  const int tid = threadIdx.x;
  const int lane_w = tid & 31, warp = tid >> 5;
  const bool topo = agg_all != nullptr;
  const int ND = N * L;
  float* agg = topo ? agg_all + (size_t)b * (ND + 1) * 3 : nullptr;
  const u8* mask_b = lane_mask ? lane_mask + (size_t)b * N : nullptr;

  // ---- lane set-up (one thread): eligible set, gates, anti-self seeds -----
  if (tid == 0) {
    const int gi = cand[b];
    Ln.gi = gi;
    Ln.queue = gang_queue[gi];
    Ln.nonpre = preemptible[gi] == 0;
    Ln.asl = anti_self[gi];
    Ln.has_asl = Ln.asl >= 0;
    Ln.pl = pref_level[gi];
    Ln.has_pref = Ln.pl >= 0;
    Ln.ntouch = 0;
    Ln.nforbid = 0;
    Ln.count = 0;
    for (int r = 0; r < 3; ++r) Ln.q_delta[r] = 0.0f;
    const int* pb = prior + (size_t)b * T;
    const int* sub = task_sub + (size_t)gi * T;
    bool already[PF_MAXT], unplaced[PF_MAXT];
    int n_already = 0;
    int already_s[PF_MAXS], deficit[PF_MAXS];
    for (int s = 0; s < S; ++s) already_s[s] = 0;
    for (int t = 0; t < T; ++t) {
      already[t] = pb[t] >= 0;
      unplaced[t] = task_valid[(size_t)gi * T + t] && !already[t];
      if (already[t]) {
        ++n_already;
        ++already_s[sub[t]];
      }
    }
    bool in_quorum = n_already < min_needed[gi];
    int deficit_sum = 0;
    for (int s = 0; s < S; ++s) {
      deficit[s] = max(sub_need[(size_t)gi * S + s] - already_s[s], 0);
      deficit_sum += deficit[s];
      in_quorum = in_quorum || deficit[s] > 0;
    }
    const int extra_needed = max(min_needed[gi] - n_already - deficit_sum, 0);
    bool elig_q[PF_MAXT];
    for (int t = 0; t < T; ++t) {
      int rank = 0;
      for (int u = 0; u < t; ++u) rank += (sub[u] == sub[t] && unplaced[u]);
      elig_q[t] = unplaced[t] && rank < deficit[sub[t]];
    }
    int rank_rest = 0, rank_unpl = 0, goal = 0;
    for (int t = 0; t < T; ++t) {
      const bool rest = unplaced[t] && !elig_q[t];
      if (rest) {
        elig_q[t] = rank_rest < extra_needed;
        ++rank_rest;
      }
      const bool first_unplaced = unplaced[t] && rank_unpl < 1;
      if (unplaced[t]) ++rank_unpl;
      s_elig[t] = in_quorum ? elig_q[t] : first_unplaced;
      goal += s_elig[t];
    }
    Ln.goal = goal;
    if (topo) {
      // each subgroup's remaining request of this attempt (task order from
      // +0.0) and its lock, seeded from the prior placements
      for (int s2 = 0; s2 < S; ++s2) {
        Ln.sub_dom[s2] = -1;
        for (int r = 0; r < 3; ++r) Ln.sub_rem[s2][r] = 0.0f;
      }
      for (int t = 0; t < T; ++t)
        for (int r = 0; r < 3; ++r)
          Ln.sub_rem[sub[t]][r] = __fadd_rn(
              Ln.sub_rem[sub[t]][r],
              s_elig[t] ? task_req[((size_t)gi * T + t) * 3 + r] : 0.0f);
      for (int t = 0; t < T; ++t) {
        const int lv = srl[(size_t)gi * S + sub[t]];
        if (already[t] && lv >= 0)
          Ln.sub_dom[sub[t]] =
              max(Ln.sub_dom[sub[t]],
                  topology[(size_t)pb[t] * L + min(lv, L - 1)]);
      }
    }
    // queue gates on every task prefix: cum_req in jnp.cumsum's blocked
    // order (blocks of 16 from +0.0, then the block totals' prefix)
    const u8* anc = chain + (size_t)Ln.queue * Q;
    float excl[3] = {0.0f, 0.0f, 0.0f}, inb[3] = {0.0f, 0.0f, 0.0f};
    for (int t = 0; t < T; ++t) {
      if (t > 0 && t % 16 == 0)
        for (int r = 0; r < 3; ++r) {
          excl[r] = __fadd_rn(excl[r], inb[r]);
          inb[r] = 0.0f;
        }
      float cum[3];
      for (int r = 0; r < 3; ++r) {
        const float v = s_elig[t] ? task_req[((size_t)gi * T + t) * 3 + r]
                                  : 0.0f;
        inb[r] = __fadd_rn(inb[r], v);
        cum[r] = t < 16 ? inb[r] : __fadd_rn(inb[r], excl[r]);
      }
      bool lim_ok = true, quo_ok = true;
      for (int q = 0; q < Q; ++q) {
        if (!anc[q]) continue;
        for (int r = 0; r < 3; ++r) {
          lim_ok = lim_ok && __fadd_rn(qa[q * 3 + r], cum[r]) <=
                                 __fadd_rn(limit_eff[q * 3 + r], KAI_EPS);
          quo_ok = quo_ok && __fadd_rn(qan[q * 3 + r], cum[r]) <=
                                 __fadd_rn(quota_eff[q * 3 + r], KAI_EPS);
        }
      }
      s_gate[t] = lim_ok && (!Ln.nonpre || quo_ok);
    }
    // anti-self domains of the prior placements; the first prior placement
    // anchors the preferred-level band (even where its domain id is -1)
    int first = -1;
    for (int t = 0; t < T; ++t) {
      if (!already[t]) continue;
      const int o = pb[t];
      if (first < 0) first = o;
      if (Ln.has_asl)
        s_forbid[Ln.nforbid++] =
            Ln.asl >= L ? o : topology[(size_t)o * L + min(Ln.asl, L - 1)];
    }
    Ln.pref_dom = first >= 0 ? topology[(size_t)first * L + max(Ln.pl, 0)]
                             : -1;
  }
  __syncthreads();

  const int asl = Ln.asl;
  const bool has_asl = Ln.has_asl;
  const int lvl_asl = min(max(asl, 0), L - 1);
  const int lvl_pref = max(Ln.pl, 0);
  const float big = FLT_MAX;

  for (int t = 0; t < T; ++t) {
    if (!(s_elig[t] && s_gate[t])) {
      if (tid == 0) {
        nodes_t[(size_t)b * T + t] = -1;
        dev_t[(size_t)b * T + t] = -1;
        pipe_t[(size_t)b * T + t] = 0;
      }
      continue;
    }
    if (tid == 0) {
      const size_t o = (size_t)Ln.gi * T + t;
      for (int r = 0; r < 3; ++r) Ln.req[r] = task_req[o * 3 + r];
      Ln.por = task_portion[o];
      Ln.mem = task_mem[o];
      Ln.cls = task_class[o];
      Ln.nom = task_nom[o];
      Ln.is_frac = Ln.por > 0.0f || Ln.mem > 0.0f;
      if (topo) {
        const int st = task_sub[o];
        const int lv = srl[(size_t)Ln.gi * S + st];
        Ln.sub = st;
        Ln.has_srl = lv >= 0;
        Ln.lvl = min(max(lv, 0), L - 1);
        Ln.locked = Ln.sub_dom[st];
        Ln.needs_pick = Ln.has_srl && Ln.locked < 0;
        Ln.banned = banned ? banned[(size_t)b * S + st] : INT_MIN;
      } else {
        Ln.has_srl = Ln.needs_pick = false;
      }
    }
    __syncthreads();
    const bool has_srl = Ln.has_srl, needs_pick = Ln.needs_pick;
    const int lvl_s = has_srl ? Ln.lvl : 0, locked = has_srl ? Ln.locked : -1;
    const int ban = needs_pick ? Ln.banned : INT_MIN;
    const float* srem = Ln.sub_rem[has_srl ? Ln.sub : 0];
    const float req0 = Ln.req[0], req1 = Ln.req[1], req2 = Ln.req[2];
    const float por = Ln.por, mem = Ln.mem;
    const bool is_frac = Ln.is_frac;
    const int cls = Ln.cls, nom = Ln.nom, ntouch = Ln.ntouch,
              nforbid = Ln.nforbid, pref_dom = Ln.pref_dom;
    const int* sel = task_sel + ((size_t)Ln.gi * T + t) * K;
    const float rq_nosum0 = (track && is_frac) ? 0.0f : req0;
    const int res = req0 > 0.0f ? 0 : 1;
    const bool binpack = req0 > 0.0f ? binpack_accel != 0 : binpack_cpu != 0;

    // ---- pass 1: fit bits, density range, any feasible --------------------
    float mn = big, mx = -big, dmx = -INFINITY;
    int any = 0;
    for (int n = tid; n < N; n += PF_THREADS) {
      // the required level: locked domain, or a domain whose aggregate
      // holds the subgroup's remaining request (its max over every node)
      bool dom_ok = false, dom_pass = true;
      if (has_srl) {
        const int dc = topology[(size_t)n * L + lvl_s];
        if (needs_pick) {
          dom_ok = dc >= 0 && dc != ban;
          const float* a = agg + (size_t)max(dc, 0) * 3;
          for (int r = 0; r < 3 && dom_ok; ++r)
            dom_ok = __fadd_rn(a[r], KAI_EPS) >= srem[r];
          dmx = fmaxf(dmx, dom_ok ? a[0] : 0.0f);
          dom_pass = dom_ok;
        } else {
          dom_pass = dc == locked;
        }
      }
      bool ok_sel = dom_pass && valid[n] && (!mask_b || mask_b[n]) &&
                    fmask[(size_t)cls * N + n];
      for (int kk = 0; kk < K && ok_sel; ++kk) {
        const int sv = sel[kk];
        if (sv >= 0 && labels[(size_t)n * K + kk] != sv) ok_sel = false;
      }
      if (ok_sel && has_asl) {
        const int dom = asl >= L ? n : topology[(size_t)n * L + lvl_asl];
        for (int j = 0; j < nforbid; ++j)
          if (s_forbid[j] == dom) ok_sel = false;
      }
      u8 fl = 0;
      if (ok_sel) {
        const float* fr = free0 + (size_t)n * 3;
        const float* dr = dev0 + (size_t)n * D;
        for (int j = 0; j < ntouch; ++j)
          if (s_touch[j].node == n) {
            fr = s_touch[j].free;
            dr = s_touch[j].dev;
          }
        const float rq[3] = {rq_nosum0, req1, req2};
        bool fi = true, fp = true;
        for (int r = 0; r < 3; ++r) {
          const float avail = __fadd_rn(__fadd_rn(fr[r], rel[n * 3 + r]),
                                        extra[n * 3 + r]);
          fi = fi && __fadd_rn(fr[r], KAI_EPS) >= rq[r];
          fp = fp && __fadd_rn(avail, KAI_EPS) >= rq[r];
        }
        if (track) {
          const float p = pf_portion(por, mem, dev_mem, n);
          float dp[PF_MAXD];
          for (int d = 0; d < D; ++d)
            dp[d] = __fadd_rn(__fadd_rn(dr[d], dev_rel[(size_t)n * D + d]),
                              extra_dev[(size_t)n * D + d]);
          fi = fi && pf_pool_ok(dr, D, p, is_frac, req0);
          fp = fp && pf_pool_ok(dp, D, p, is_frac, req0);
        }
        fl = (fi ? 1 : 0) | (fp ? 2 : 0) | (dom_ok ? 4 : 0);
        if (fp) {
          any = 1;
          if (alloc[n * 3 + res] > 0.0f) {
            const float na = __fadd_rn(fr[res], rel[n * 3 + res]);
            mn = fminf(mn, na);
            mx = fmaxf(mx, na);
          }
        }
      }
      s_flags[n] = fl;
    }
    for (int off = 16; off > 0; off >>= 1) {
      mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
      mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
      dmx = fmaxf(dmx, __shfl_down_sync(0xffffffffu, dmx, off));
    }
    if (lane_w == 0) {
      s_wf[warp] = mn;
      s_wg[warp] = mx;
      s_wd[warp] = dmx;
    }
    any = __syncthreads_or(any);
    if (tid == 0) {
      for (int w = 1; w < PF_WARPS; ++w) {
        s_wf[0] = fminf(s_wf[0], s_wf[w]);
        s_wg[0] = fmaxf(s_wg[0], s_wg[w]);
        s_wd[0] = fmaxf(s_wd[0], s_wd[w]);
      }
      Ln.mn = s_wf[0];
      Ln.mx = s_wg[0];
      Ln.dmx = s_wd[0];
      Ln.any_fp = any != 0;
    }
    __syncthreads();
    if (!Ln.any_fp) {  // nothing feasible: the step places nothing
      if (tid == 0) {
        nodes_t[(size_t)b * T + t] = -1;
        dev_t[(size_t)b * T + t] = -1;
        pipe_t[(size_t)b * T + t] = 0;
      }
      __syncthreads();
      continue;
    }
    mn = Ln.mn;
    mx = Ln.mx;
    const float span = __fsub_rn(mx, mn);
    const float dmx_eps = fmaxf(Ln.dmx, KAI_EPS);

    // ---- pass 2: feasible rank, score, argmax (lowest node on ties) -------
    float best = -INFINITY;
    int best_i = INT_MAX;
    int running = 0;
    for (int base = 0; base < N; base += PF_THREADS) {
      const int n = base + tid;
      const u8 fl = n < N ? s_flags[n] : 0;
      const bool fp = (fl & 2) != 0;
      int tile_total = 0;
      const int incl = pf_block_scan(fp ? 1 : 0, &tile_total);
      if (n < N) {
        float score = KAI_BIG_NEG;
        if (fp) {
          const bool fi = (fl & 1) != 0;
          const float* fr = free0 + (size_t)n * 3;
          const float* dr = dev0 + (size_t)n * D;
          for (int j = 0; j < ntouch; ++j)
            if (s_touch[j].node == n) {
              fr = s_touch[j].free;
              dr = s_touch[j].dev;
            }
          float place = 0.0f;
          if (alloc[n * 3 + res] > 0.0f) {
            float raw = 1.0f;
            if (span > 0.0f) {
              const float na = __fadd_rn(fr[res], rel[n * 3 + res]);
              const float frac =
                  __fdiv_rn(__fsub_rn(na, mn), fmaxf(span, 1e-30f));
              raw = binpack ? __fsub_rn(1.0f, frac) : frac;
            }
            place = __fmul_rn(9.0f, raw);
          }
          const float rtype =
              (req0 <= 0.0f && alloc[n * 3] <= 0.0f) ? 10.0f : 0.0f;
          const float avl = fi ? 100.0f : 0.0f;
          const float bands =
              __fadd_rn(__fadd_rn(__fadd_rn(0.0f, place), rtype), avl);
          const float topo_b =
              (Ln.has_pref && pref_dom >= 0 &&
               topology[(size_t)n * L + lvl_pref] == pref_dom)
                  ? 10000.0f
                  : 0.0f;
          // the domain-binpack band of a subgroup's first placement
          float dom_band = 0.0f;
          if (needs_pick && (fl & 4)) {
            const float a = agg[(size_t)topology[(size_t)n * L + lvl_s] * 3];
            dom_band = __fmul_rn(10000.0f,
                                 __fsub_rn(1.0f, __fdiv_rn(a, dmx_eps)));
          }
          const int rank = running + incl - 1;
          const float jit = __fmul_rn(jscale, (float)kai_pymod(rank - b, N));
          float eb = __fadd_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(topo_b, dom_band), jit),
                        soft[(size_t)cls * N + n]),
              n == nom ? 1000000.0f : 0.0f);
          if (track) {
            const float p = pf_portion(por, mem, dev_mem, n);
            const float pm = __fsub_rn(p, KAI_EPS);
            bool shared_fit = false;
            for (int d = 0; d < D; ++d) {
              const float df = dr[d];
              shared_fit = shared_fit ||
                           (df > KAI_EPS && df < PF_ONE_M_EPS && df >= pm);
            }
            eb = __fadd_rn(eb, (is_frac && shared_fit) ? 1000.0f : 0.0f);
          }
          score = __fadd_rn(__fadd_rn(0.0f, bands), eb);
        }
        if (kai_better(score, n, best, best_i)) {
          best = score;
          best_i = n;
        }
      }
      running += tile_total;
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, best, off);
      const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
      if (kai_better(v2, i2, best, best_i)) {
        best = v2;
        best_i = i2;
      }
    }
    if (lane_w == 0) {
      s_wf[warp] = best;
      s_wi[warp] = best_i;
    }
    __syncthreads();

    // ---- bookkeeping on the chosen node (one thread) ----------------------
    if (tid == 0) {
      for (int w = 1; w < PF_WARPS; ++w)
        if (kai_better(s_wf[w], s_wi[w], best, best_i)) {
          best = s_wf[w];
          best_i = s_wi[w];
        }
      const int node = best_i;
      const bool is_pipe = (s_flags[node] & 1) == 0;
      int j = 0;
      while (j < Ln.ntouch && s_touch[j].node != node) ++j;
      PfTouch& tr = s_touch[j];
      if (j == Ln.ntouch) {
        ++Ln.ntouch;
        tr.node = node;
        for (int r = 0; r < 3; ++r) {
          tr.free[r] = free0[(size_t)node * 3 + r];
          tr.bind[r] = 0.0f;
        }
        for (int d = 0; d < D; ++d) {
          tr.dev[d] = dev0[(size_t)node * D + d];
          tr.dbind[d] = 0.0f;
        }
      }
      float p = req0;
      int frac_dev = -1;
      if (track) {
        p = pf_portion(por, mem, dev_mem, node);
        float rel_row[PF_MAXD], key[PF_MAXD];
        bool elig[PF_MAXD];
        for (int d = 0; d < D; ++d)
          rel_row[d] = __fadd_rn(dev_rel[(size_t)node * D + d],
                                 extra_dev[(size_t)node * D + d]);
        // fraction: the GpuOrderFn pick over idle (+ releasing when it
        // pipelines) share
        const float pm = __fsub_rn(p, KAI_EPS);
        int pick = 0;
        float kbest = device_pack ? INFINITY : -INFINITY;
        for (int d = 0; d < D; ++d) {
          const float row = is_pipe ? __fadd_rn(tr.dev[d], rel_row[d])
                                    : tr.dev[d];
          const bool fits = row >= pm;
          const float kd = fits ? row : (device_pack ? INFINITY : -INFINITY);
          if (d == 0) {
            kbest = kd;
          } else if (device_pack ? kd < kbest : kd > kbest) {
            kbest = kd;
            pick = d;
          }
        }
        frac_dev = pick;
        // whole devices: round(req) of them, most-free first (index ties)
        const int kwant = (int)rintf(req0);
        for (int d = 0; d < D; ++d) {
          elig[d] = __fadd_rn(tr.dev[d], rel_row[d]) >= PF_ONE_M_EPS;
          key[d] = elig[d] ? -tr.dev[d] : INFINITY;
        }
        float dd[PF_MAXD];
        for (int d = 0; d < D; ++d) {
          int rank = 0;
          for (int e = 0; e < D; ++e)
            rank += (key[e] < key[d]) || (key[e] == key[d] && e < d);
          const bool take = elig[d] && rank < kwant;
          dd[d] = is_frac ? __fmul_rn(p, d == frac_dev ? 1.0f : 0.0f)
                          : (take ? 1.0f : 0.0f);
        }
        for (int d = 0; d < D; ++d) {
          tr.dev[d] = __fadd_rn(tr.dev[d], -dd[d]);
          if (!is_pipe) tr.dbind[d] = __fadd_rn(tr.dbind[d], dd[d]);
        }
      }
      // the node's accel debit uses its own share; the queue's the request
      const float dn[3] = {is_frac ? p : req0, req1, req2};
      for (int r = 0; r < 3; ++r) {
        tr.free[r] = __fadd_rn(tr.free[r], -dn[r]);
        if (!is_pipe) tr.bind[r] = __fadd_rn(tr.bind[r], dn[r]);
        Ln.q_delta[r] = __fadd_rn(Ln.q_delta[r], Ln.req[r]);
      }
      if (has_asl)
        s_forbid[Ln.nforbid++] =
            asl >= L ? node : topology[(size_t)node * L + lvl_asl];
      nodes_t[(size_t)b * T + t] = node;
      dev_t[(size_t)b * T + t] = is_frac ? frac_dev : -1;
      pipe_t[(size_t)b * T + t] = is_pipe ? 1 : 0;
      ++Ln.count;
      if (Ln.pref_dom < 0)
        Ln.pref_dom = topology[(size_t)node * L + lvl_pref];
      if (topo) {
        const int st = Ln.sub;
        if (needs_pick) Ln.sub_dom[st] = topology[(size_t)node * L + lvl_s];
        for (int r = 0; r < 3; ++r)
          Ln.sub_rem[st][r] = __fadd_rn(Ln.sub_rem[st][r], -Ln.req[r]);
        // the node's domain at every level loses the placement
        for (int lv = 0; lv < L; ++lv) {
          const int did = topology[(size_t)node * L + lv];
          float* a = agg + (size_t)(did >= 0 ? did : ND) * 3;
          for (int r = 0; r < 3; ++r) a[r] = __fadd_rn(a[r], -dn[r]);
        }
      }
    }
    __syncthreads();
  }

  // ---- outputs: success, final rows of the touched nodes, queue tables ---
  if (tid == 0) success[b] = (Ln.goal > 0 && Ln.count >= Ln.goal) ? 1 : 0;
  if (topo)
    for (int s2 = tid; s2 < S; s2 += PF_THREADS)
      sub_dom_out[(size_t)b * S + s2] = Ln.sub_dom[s2];
  for (int t = tid; t < T; t += PF_THREADS) {
    const int node = nodes_t[(size_t)b * T + t];
    const size_t o = (size_t)b * T + t;
    int j = -1;
    if (node >= 0)
      for (int u = 0; u < Ln.ntouch; ++u)
        if (s_touch[u].node == node) j = u;
    for (int r = 0; r < 3; ++r) {
      free_rows[o * 3 + r] = j >= 0 ? s_touch[j].free[r] : 0.0f;
      bind_rows[o * 3 + r] = j >= 0 ? s_touch[j].bind[r] : 0.0f;
    }
    for (int d = 0; d < D; ++d) {
      dev_rows[o * D + d] = j >= 0 ? s_touch[j].dev[d] : 0.0f;
      devbind_rows[o * D + d] = j >= 0 ? s_touch[j].dbind[d] : 0.0f;
    }
  }
  const u8* anc = chain + (size_t)Ln.queue * Q;
  for (int idx = tid; idx < Q * 3; idx += PF_THREADS) {
    const int q = idx / 3, r = idx % 3;
    const float d = __fmul_rn(anc[q] ? 1.0f : 0.0f, Ln.q_delta[r]);
    qa2[(size_t)b * Q * 3 + idx] = __fadd_rn(qa[idx], d);
    qan2[(size_t)b * Q * 3 + idx] = __fadd_rn(qan[idx], Ln.nonpre ? d : 0.0f);
  }
}

KAI_EXPORT int kai_pertask_fill(
    const float* task_req, const u8* task_valid, const int* task_sel,
    const float* task_portion, const float* task_mem, const int* task_class,
    const int* task_nom, const int* task_sub, const int* sub_need,
    const int* min_needed, const int* gang_queue, const u8* preemptible,
    const int* anti_self, const int* pref_level, const float* free0,
    const float* dev0, const float* rel, const float* extra,
    const float* dev_rel, const float* extra_dev, const float* alloc,
    const u8* valid, const int* labels, const u8* fmask, const float* soft,
    const float* dev_mem, const int* topology, const float* qa,
    const float* qan, const float* limit_eff, const float* quota_eff,
    const u8* chain, const int* cand, const int* prior, const int* srl,
    const int* dom_ptr, const int* dom_nodes, const int* banned,
    const u8* active, const u8* lane_mask, float* agg_scratch, int B, int T,
    int N, int D, int K, int X, int L, int S, int Q, int G, int binpack_accel,
    int binpack_cpu,
    int device_pack, int track, int agg_ready, float jscale, float* qa2,
    float* qan2, int* nodes_t, int* dev_t, u8* pipe_t, u8* success,
    float* free_rows, float* dev_rows, float* bind_rows, float* devbind_rows,
    int* sub_dom, cudaStream_t stream) {
  if (B < 1 || T < 1 || T > PF_MAXT || N < 1 || D < 0 || D > PF_MAXD ||
      K < 0 || X < 1 || L < 1 || S < 1 || S > PF_MAXS || Q < 1 || G < 1)
    return KAI_ERR_ARGS;
  const bool topo = dom_ptr != nullptr;
  if (topo != (dom_nodes && agg_scratch && sub_dom) ||
      ((banned || agg_ready) && !topo))
    return KAI_ERR_ARGS;
  if (topo) {
    const int ND = N * L;
    pf_domain_agg_kernel<<<(ND + PF_THREADS) / PF_THREADS, PF_THREADS, 0,
                           stream>>>(dom_ptr, dom_nodes, free0, rel, extra,
                                     active, B, ND, agg_ready, agg_scratch);
    const cudaError_t e0 = cudaGetLastError();
    if (e0 != cudaSuccess) return static_cast<int>(e0);
  }
  // the fit bits, one byte a node; with the ~19 KB of static shared
  // memory a block may need more than the 48 KB granted without opting in
  const size_t smem = (size_t)N;
  const cudaError_t e = cudaFuncSetAttribute(
      pertask_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  pertask_fill_kernel<<<B, PF_THREADS, smem, stream>>>(
      task_req, task_valid, task_sel, task_portion, task_mem, task_class,
      task_nom, task_sub, sub_need, min_needed, gang_queue, preemptible,
      anti_self, pref_level, free0, dev0, rel, extra, dev_rel, extra_dev,
      alloc, valid, labels, fmask, soft, dev_mem, topology, qa, qan, limit_eff,
      quota_eff, chain, cand, prior, srl, banned, active, lane_mask,
      topo ? agg_scratch : nullptr, T, N, D, K, L, S, Q, binpack_accel,
      binpack_cpu, device_pack, track, jscale, qa2, qan2, nodes_t, dev_t,
      pipe_t, success, free_rows, dev_rows, bind_rows, devbind_rows, sub_dom);
  return static_cast<int>(cudaGetLastError());
}
