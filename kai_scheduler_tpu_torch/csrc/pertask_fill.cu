// K9 pertask_fill — the per-task placement of every wavefront lane.
//
// Replaces kai_scheduler_tpu/ops/allocate.py:517 `_attempt_gang_in_domain`
// under the allocate chunk's lane vmap (:1699): per lane the re-push
// protocol's subgroup quorum and eligible task set (:619-646), the hoisted
// queue prefix gates (:670-696), anti-self domains (:586-608), then the T
// task steps in order, each one pass over the N nodes in global memory and
// one over shared memory:
//   1. dual feasibility against the lane's LIVE pools (`feasible_nodes_dual`
//      predicates.py:168 with the device pool check `_accel_pool_ok` :82),
//      the anti-self mask, the block-wide min/max of the binpack/spread
//      density range and each warp's count of fit_pipe nodes (`__ballot_sync`
//      / `__popc`); what step 2 needs of a node — its flag bits, the density
//      input, the soft score and the domain aggregate — stays in shared
//      memory;
//   2. over shared memory only: the feasible rank (the tie jitter's) from
//      the warp's exclusive prefix and `__popc(ballot & lanemask_lt)`, the
//      score in the reference's f32 order — ((0 + placement) + resourcetype)
//      + availability, plus (((((topology + domain) + jitter) + soft) +
//      nominated) + gpusharingorder) — and a block argmax that takes the
//      lowest node on ties, as jnp.argmax does;
//   3. warp 0 folds the warps' bests and stages the chosen node's rows
//      (pools, device rows, its domain at every level and their chunk-start
//      aggregates) in one round trip, then one thread's bookkeeping on it:
//      `pick_device` for a fraction (scoring.py:66), the whole-device
//      rank-and-take (:809-817), the node debit at the node's own portion,
//      the canonical queue debit, bind-now vs pipelined claims (:819-850).
// Each warp walks one contiguous range of nodes in both passes, so a node's
// rank needs no barrier per tile: a step has four barriers.  Step 1 issues
// every load a node needs before it tests any, so a node costs one L2
// round trip.
//
// The per-chunk node summary.  Everything the two passes read of a node's
// chunk-start pools reduces, for any task, to 14 f32 and a bit word (SoA
// [15, N], built once per launch by `pf_prologue_kernel`, one thread a
// node): free + EPS and ((free + releasing) + extra) + EPS per resource,
// free + releasing on accel and cpu (the density input), and of the idle and
// the pipelined device rows the max share and the whole-free count + EPS,
// the max share among partly used idle devices, and max(device memory,
// EPS).  The reductions are exact: `_accel_pool_ok` compares the row's max
// (fmaxf is exact), a count of devices at or above 1 - EPS is a whole
// number, and "some partly used device holds p - EPS" is "the max of the
// partly used devices holds it".  The per-task compares keep the
// reference's operands, so the fit bits are bit-equal (the plain mirror,
// `ops/allocate.py` `pertask_summary_plain`, is held against the
// per-device predicates in tests/test_torch_pertask_summary.py).
//
// Exceptions instead of copies.  A lane touches at most T nodes: their live
// rows (free, device free, bind-now and device bind-now) and their live
// summary live in shared memory, and a bit in the node's shared flag byte
// says to read them; every other node reads the summary.  In the
// subgroup-topology mode (dom_ptr given; ref :650-668, :729-760, :855-866,
// :878-882) a first launch sums the chunk-start pools (idle + releasing +
// victim-freed) per domain, each domain's nodes in ascending order from
// +0.0 (XLA:CPU's scatter-add order: memory and CPU carry fractions; one
// warp a domain loads 32 nodes at a time and adds them in order through
// shuffles), into a global [ND + 1, 3] table; a retry launch given `agg_ready` reads the
// table of its chunk's first launch.  Each lane keeps only the domains its
// placements debited, per level, in shared memory and reads every other
// domain from the table: no per-lane copy.  Each lane keeps its subgroups'
// locks and remaining requests in shared memory.  A task step of a subgroup
// with a required level is confined to its locked domain; its first
// placement needs a domain whose aggregate still holds the subgroup's
// remaining request (and is not the one `banned` names), and gets the
// domain-binpack band W_TOPOLOGY * (1 - agg / max(mx, EPS)) with mx the
// block max of the fitting domains' aggregates.  The chosen node's domain
// at every level loses the placement.  `active` runs only the lanes of the
// in-cycle retry (ref :1274-1289), each block with its own lane index; the
// other blocks return at once and leave their outputs as they were.
//
// The victim actions' modes (ref :595, :903-907, :783-784; the solver and
// the dense victim wavefront call the fill with neither prior placements
// nor a quota).  `legacy`: every valid task is eligible and success is at
// least min_needed placed.  The lanes mode: each block reads its lane's
// slice of `extra` [B, N, 3], `extra_dev` [B, N, D] and `qa` [B, Q, 3]
// (a zero lane stride keeps one shared), and `score_bias` [B, N] joins
// the bands after the nominated band.  With per-lane pools the node
// summary depends on the lane: the prologue builds one a lane ([B, 15, N],
// grid y = lane), so every fit bit stays the reductions' exact answer; the
// build reads each lane's slices once (B x N x (3 + D) floats) and writes
// B x 15 x N.  The subgroup-topology mode takes neither.
//
// The extended mode (E > 0: MIG and other extended scalar resources; ref
// :570-581, :683-688, :713-719, :841-849).  Each task's g-number equivalent
// gq = task_extended . ext_accel (a dot over E from +0.0, staged per lane)
// joins its accel request in the queue prefix gates, (req0 + gq) before the
// cumsum, and in the queue delta.  The node tests compare the extended pool
// per key in the reference's operand order: idle `ext + EPS >= te`,
// pipelined `((ext + extended_releasing) + ext_extra) + EPS >= te`.  The
// prologue writes both left-hand sides into a second summary, [2E, N] (one
// a lane where `ext_extra` is the lane's own, [B, N, E]), rather than have
// every step re-add three [N, E] tables: the summary holds the same f32
// sums the compares take, so the bits are the plain version's.  A touched
// node's live extended row, its bind-now claims and its live sums stay in
// shared memory with its other rows; a placement debits `te` there (and
// claims it bind-now unless it pipelines).  `ext_rows` / `extbind_rows`
// [B, T, E] come out as the other rows do.
//
// The mask mode (`lane_mask` [B, N], the affinity gates' node mask, K12):
// each block reads its lane's row into the nodes it may use, `allowed =
// domain_mask & ~forbidden` (ref :720 with domain_mask = n.valid & mask,
// :1259); it composes with the subgroup domains, the banned retry and the
// device table.
//
// Shared memory: 9 bytes a node (13 with topology) for the first NS nodes,
// NS chosen so that a block stays under ~108 KB and two blocks share an SM.
// The nodes past NS (more than ~12,000 at T = 8, D = 8) are evaluated again
// in step 2 from the summary, so the kernel takes any N.
//
// Bound.  DRAM: the node tables and the lanes' rows once (`chip_smoke.py`
// computes it; 0.004 ms on the sharing cell).  What the design pays is L2
// traffic, proportional to lanes x placed steps.  Sharing cell (B = 256,
// T = 8, N = 10,000, D = 8, one label key): before, two passes a step
// each re-reading ~150 bytes a node of raw pools, labels, filter and soft
// rows, 256 x 8 x 2 x 10,000 x 150 B ~ 6.1 GB a launch; now one pass of
// ~56 bytes a node (summary fields the task needs, filter byte, label,
// soft), 256 x 8 x 10,000 x 56 B ~ 1.15 GB, plus the summary's build
// (~2 MB).  Measured times: PERF.md, NVIDIA H100 80GB HBM3.
#include "kai_common.cuh"

#define PF_THREADS 512
#define PF_WARPS (PF_THREADS / 32)
#define PF_MAXT 64
#define PF_MAXD 32
#define PF_MAXS 32
#define PF_MAXE 8
// the dynamic shared memory a block aims to stay under (two blocks an SM)
#define PF_SMEM_BUDGET (108 * 1024)
// 1.0 - EPS and friends as the reference's weak-typed Python floats round
// them to f32
#define PF_ONE_M_EPS ((float)(1.0 - 1e-6))

// the summary's fields (SoA, [PF_NF, N]); the first PF_NLIVE are what a
// touched node's live rows change
#define PF_FE 0      // free + EPS, 3 resources
#define PF_AE 3      // ((free + releasing) + extra) + EPS, 3 resources
#define PF_NA 6      // free + releasing, accel and cpu
#define PF_DMAX_I 8  // max idle device share
#define PF_WE_I 9    // whole idle devices + EPS
#define PF_DMAX_P 10 // max pipelined device share (+ releasing + freed)
#define PF_WE_P 11   // whole pipelined devices + EPS
#define PF_SMAX 12   // max share among partly used idle devices
#define PF_NLIVE 13
#define PF_DMEM 13   // max(device memory, EPS)
#define PF_BITS 14   // bit word
#define PF_NF 15
#define PFB_VALID 1u
#define PFB_RES0 2u     // allocatable accel > 0
#define PFB_RES1 4u     // allocatable cpu > 0
#define PFB_CPUONLY 8u  // allocatable accel <= 0

// a node's flag byte in shared memory
#define PFL_FI 1      // fits the idle pool
#define PFL_FP 2      // fits the pipelined pool
#define PFL_DOMOK 4   // its domain holds the subgroup's remaining request
#define PFL_SHARED 8  // a partly used device holds the fraction
#define PFL_TOPOB 16  // in the preferred domain
#define PFL_RTYPE 32  // cpu task on a cpu-only node
#define PFL_HASRES 64 // has the task's density resource
#define PFL_TOUCH 128 // the lane touched it: read its live rows (kept)

struct PfLane {
  int gi, queue, asl, pl, goal, count, pref_dom, ntouch, nforbid;
  bool nonpre, has_asl, has_pref;
  float q_delta[3];
  // task step scalars
  float req[3], por, mem;
  int cls, nom;
  bool is_frac;
  // subgroup topology: the step's subgroup, its level's column, its lock,
  // its banned domain
  int sub, lvl, locked, banned;
  bool has_srl, needs_pick;
  // the subgroups' locked domains and remaining requests
  int sub_dom[PF_MAXS];
  float sub_rem[PF_MAXS][3];
};

// the summary of one node's pools (free f32 [3], dev f32 [D] and the
// node's releasing / victim-freed rows) into s[0 .. PF_NLIVE)
__device__ __forceinline__ void pf_summarize(
    const float* fr, const float* dr, const float* rel_n,
    const float* extra_n, const float* drel_n, const float* dextra_n, int D,
    float* s, int stride) {
  for (int r = 0; r < 3; ++r) {
    s[(PF_FE + r) * stride] = __fadd_rn(fr[r], KAI_EPS);
    s[(PF_AE + r) * stride] = __fadd_rn(
        __fadd_rn(__fadd_rn(fr[r], rel_n[r]), extra_n[r]), KAI_EPS);
  }
  s[PF_NA * stride] = __fadd_rn(fr[0], rel_n[0]);
  s[(PF_NA + 1) * stride] = __fadd_rn(fr[1], rel_n[1]);
  float mi = -INFINITY, mp = -INFINITY, sm = -INFINITY;
  float wi = 0.0f, wp = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float df = dr[d];
    const float dp = __fadd_rn(__fadd_rn(df, drel_n[d]), dextra_n[d]);
    mi = fmaxf(mi, df);
    mp = fmaxf(mp, dp);
    wi = __fadd_rn(wi, df >= PF_ONE_M_EPS ? 1.0f : 0.0f);
    wp = __fadd_rn(wp, dp >= PF_ONE_M_EPS ? 1.0f : 0.0f);
    if (df > KAI_EPS && df < PF_ONE_M_EPS) sm = fmaxf(sm, df);
  }
  s[PF_DMAX_I * stride] = mi;
  s[PF_WE_I * stride] = __fadd_rn(wi, KAI_EPS);
  s[PF_DMAX_P * stride] = mp;
  s[PF_WE_P * stride] = __fadd_rn(wp, KAI_EPS);
  s[PF_SMAX * stride] = sm;
}

// the extended summary of one node's row: ext + EPS and ((ext +
// extended_releasing) + ext_extra) + EPS per key, into s[0 .. 2E)
__device__ __forceinline__ void pf_summarize_ext(const float* ex,
                                                 const float* erel,
                                                 const float* exx, int E,
                                                 float* s, int stride) {
  for (int e = 0; e < E; ++e) {
    s[e * stride] = __fadd_rn(ex[e], KAI_EPS);
    s[(E + e) * stride] =
        __fadd_rn(__fadd_rn(__fadd_rn(ex[e], erel[e]), exx[e]), KAI_EPS);
  }
}

// the prologue: each node's summary (one thread a node); with `sum_agg`
// the chunk-start domain aggregate too (one warp a domain: its lanes load
// 32 of the domain's nodes at a time, and the sum takes them in ascending
// order through shuffles)
__global__ void __launch_bounds__(256) pf_prologue_kernel(
    const float* __restrict__ free0, const float* __restrict__ dev0,
    const float* __restrict__ rel, const float* __restrict__ extra,
    const float* __restrict__ dev_rel, const float* __restrict__ extra_dev,
    const float* __restrict__ alloc, const u8* __restrict__ valid,
    const float* __restrict__ dev_mem, int N, int D,
    float* __restrict__ summ, const int* __restrict__ dom_ptr,
    const int* __restrict__ dom_nodes, int ND, int sum_agg,
    float* __restrict__ agg, int extra_ls, int extra_dev_ls,
    const float* __restrict__ ext0, const float* __restrict__ ext_rel,
    const float* __restrict__ ext_extra, int E, int ext_ls,
    float* __restrict__ esumm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // one summary a lane (grid y) where the pools are the lanes' own
  const int y = blockIdx.y;
  extra += (size_t)y * extra_ls;
  extra_dev += (size_t)y * extra_dev_ls;
  summ += (size_t)y * PF_NF * N;
  if (E > 0 && i < N) {
    const size_t o = (size_t)i * E;
    pf_summarize_ext(ext0 + o, ext_rel + o, ext_extra + (size_t)y * ext_ls + o,
                     E, esumm + (size_t)y * 2 * E * N + i, N);
  }
  if (i < N) {
    const size_t o = (size_t)i * D;
    pf_summarize(free0 + i * 3, dev0 + o, rel + i * 3, extra + i * 3,
                 dev_rel + o, extra_dev + o, D, summ + i, N);
    summ[(size_t)PF_DMEM * N + i] = fmaxf(dev_mem[i], KAI_EPS);
    const unsigned bits = (valid[i] ? PFB_VALID : 0u) |
                          (alloc[i * 3] > 0.0f ? PFB_RES0 : 0u) |
                          (alloc[i * 3 + 1] > 0.0f ? PFB_RES1 : 0u) |
                          (alloc[i * 3] <= 0.0f ? PFB_CPUONLY : 0u);
    summ[(size_t)PF_BITS * N + i] = __uint_as_float(bits);
  }
  const int d = i >> 5, lane = i & 31;
  if (sum_agg && y == 0 && d <= ND) {  // the same for the whole warp
    float a[3] = {0.0f, 0.0f, 0.0f};
    if (d < ND) {  // the junk row ND is never read: it stays zero
      const int lo = dom_ptr[d], hi = dom_ptr[d + 1];
      for (int j0 = lo; j0 < hi; j0 += 32) {
        float v[3] = {0.0f, 0.0f, 0.0f};
        if (j0 + lane < hi) {
          const size_t o = (size_t)dom_nodes[j0 + lane] * 3;
          for (int r = 0; r < 3; ++r)
            v[r] = __fadd_rn(__fadd_rn(free0[o + r], rel[o + r]),
                             extra[o + r]);
        }
        const int cnt = min(32, hi - j0);
        for (int k = 0; k < cnt; ++k)
          for (int r = 0; r < 3; ++r)
            a[r] = __fadd_rn(a[r], __shfl_sync(0xffffffffu, v[r], k));
      }
    }
    if (lane == 0)
      for (int r = 0; r < 3; ++r) agg[(size_t)d * 3 + r] = a[r];
  }
}

// the node's effective share of one device (predicates.node_portion), from
// the summary's max(device memory, EPS)
__device__ __forceinline__ float pf_portion(float por, float mem,
                                            float dmem) {
  return mem > 0.0f ? __fdiv_rn(mem, dmem) : __fmul_rn(por, 1.0f);
}

// one task step's constants, the same in every thread
struct PfStep {
  const float* summ;        // [PF_NF, N]
  const float* esumm;       // extended summary [2E, N] (extended mode)
  const float* te;          // the task's extended request [E]
  const float* tesum;       // touched nodes' live extended sums [T, 2E]
  const float* tsum;        // touched nodes' live summaries [T, PF_NLIVE]
  const int* tnode;         // touched nodes [T]
  const float* agg;         // chunk-start domain aggregate [ND + 1, 3]
  const int* dchg_id;       // per level: the lane's debited domains
  const float* dchg_a;      //   and their live aggregates
  const int* dchg_n;        //   and their count
  const u8* valid_mask;     // the lane's mask row, or null
  const u8* fmask;          // the task class's filter row
  const int* labels;
  const int* sel;
  const int* topology;
  const int* forbid;
  int N, K, L, T, E, ntouch, nforbid, asl, lvl_asl, lvl_pref, pref_dom,
      lvl_s, locked, ban, res;
  bool has_asl, has_pref, has_srl, needs_pick, track, is_frac;
  float rq0, req0, req1, req2, por, mem, srem0, srem1, srem2;
};

__device__ __forceinline__ int pf_find_touch(const PfStep& c, int n) {
  for (int j = 0; j < c.ntouch; ++j)
    if (c.tnode[j] == n) return j;
  return -1;
}

// a node's flag bits for one step (PFL_TOUCH left out); `na` the density
// input where it fits the pipelined pool and has the resource, `ag` its
// domain's accel aggregate where the step picks a domain.  Every load a
// node needs is issued before any test, so a node costs one round trip.
__device__ __forceinline__ u8 pf_eval(const PfStep& c, int n, int tj,
                                      float& na, float& ag) {
  const int N = c.N;
  const float* s = tj >= 0 ? c.tsum + tj * PF_NLIVE : c.summ + n;
  const int st = tj >= 0 ? 1 : N;
  const unsigned nb = __float_as_uint(c.summ[(size_t)PF_BITS * N + n]);
  const bool vm = !c.valid_mask || c.valid_mask[n];
  const bool fm = c.fmask[n] != 0;
  bool lab = true;
  for (int kk = 0; kk < c.K; ++kk) {
    const int sv = c.sel[kk];
    lab = lab & (sv < 0 || c.labels[(size_t)n * c.K + kk] == sv);
  }
  const int dc = c.has_srl ? c.topology[(size_t)n * c.L + c.lvl_s] : -1;
  const int dom_asl =
      !c.has_asl ? -1
                 : (c.asl >= c.L ? n
                                 : c.topology[(size_t)n * c.L + c.lvl_asl]);
  const bool want_pref = c.has_pref && c.pref_dom >= 0;
  const int pdom = want_pref ? c.topology[(size_t)n * c.L + c.lvl_pref] : -1;
  const float fe0 = s[PF_FE * st], fe1 = s[(PF_FE + 1) * st],
              fe2 = s[(PF_FE + 2) * st];
  const float ae0 = s[PF_AE * st], ae1 = s[(PF_AE + 1) * st],
              ae2 = s[(PF_AE + 2) * st];
  const float nav = s[(PF_NA + c.res) * st];
  float pool_i = 0.0f, pool_p = 0.0f, smax = -INFINITY, dmem = 1.0f;
  if (c.track) {
    pool_i = s[(c.is_frac ? PF_DMAX_I : PF_WE_I) * st];
    pool_p = s[(c.is_frac ? PF_DMAX_P : PF_WE_P) * st];
    if (c.is_frac) {
      smax = s[PF_SMAX * st];
      if (c.mem > 0.0f) dmem = c.summ[(size_t)PF_DMEM * N + n];
    }
  }
  // the required level: the locked domain, or a domain whose aggregate
  // (the lane's debited copy, else the chunk-start table) holds the
  // subgroup's remaining request
  bool dom_ok = false, dom_pass = true;
  ag = 0.0f;
  if (c.has_srl) {
    if (c.needs_pick) {
      dom_ok = dc >= 0 && dc != c.ban;
      if (dom_ok) {
        const float* a = c.agg + (size_t)dc * 3;
        const int* ids = c.dchg_id + c.lvl_s * c.T;
        for (int j = 0, m = c.dchg_n[c.lvl_s]; j < m; ++j)
          if (ids[j] == dc) a = c.dchg_a + ((size_t)c.lvl_s * c.T + j) * 3;
        dom_ok = __fadd_rn(a[0], KAI_EPS) >= c.srem0 &&
                 __fadd_rn(a[1], KAI_EPS) >= c.srem1 &&
                 __fadd_rn(a[2], KAI_EPS) >= c.srem2;
        ag = a[0];
      }
      dom_pass = dom_ok;
    } else {
      dom_pass = dc == c.locked;
    }
  }
  const u8 dbit = dom_ok ? PFL_DOMOK : 0;
  bool ok_sel = dom_pass && (nb & PFB_VALID) && vm && fm && lab;
  if (ok_sel && c.has_asl)
    for (int j = 0; j < c.nforbid; ++j)
      if (c.forbid[j] == dom_asl) ok_sel = false;
  if (!ok_sel) return dbit;
  bool fi = fe0 >= c.rq0 && fe1 >= c.req1 && fe2 >= c.req2;
  bool fp = ae0 >= c.rq0 && ae1 >= c.req1 && ae2 >= c.req2;
  if (c.E > 0) {  // the extended pools, every key
    const float* es = tj >= 0 ? c.tesum + tj * 2 * c.E : c.esumm + n;
    for (int e = 0; e < c.E; ++e) {
      fi = fi && es[e * st] >= c.te[e];
      fp = fp && es[(c.E + e) * st] >= c.te[e];
    }
  }
  bool shared = false;
  if (c.track) {
    if (c.is_frac) {
      const float pm = __fsub_rn(pf_portion(c.por, c.mem, dmem), KAI_EPS);
      fi = fi && pool_i >= pm;
      fp = fp && pool_p >= pm;
      shared = smax >= pm;
    } else {
      fi = fi && pool_i >= c.req0;
      fp = fp && pool_p >= c.req0;
    }
  }
  u8 fl = dbit | (fi ? PFL_FI : 0) | (shared ? PFL_SHARED : 0);
  if (fp) {
    fl |= PFL_FP;
    if (nb & (c.res == 0 ? PFB_RES0 : PFB_RES1)) {
      fl |= PFL_HASRES;
      na = nav;
    }
    if (c.req0 <= 0.0f && (nb & PFB_CPUONLY)) fl |= PFL_RTYPE;
    if (want_pref && pdom == c.pref_dom) fl |= PFL_TOPOB;
  }
  return fl;
}

__global__ void __launch_bounds__(PF_THREADS, 2) pertask_fill_kernel(
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
    const int* __restrict__ labels, const u8* __restrict__ fmask,
    const float* __restrict__ soft, const int* __restrict__ topology,
    const float* __restrict__ summ,
    // queues
    const float* __restrict__ qa, const float* __restrict__ qan,
    const float* __restrict__ limit_eff, const float* __restrict__ quota_eff,
    const u8* __restrict__ chain,
    // lanes
    const int* __restrict__ cand, const int* __restrict__ prior,
    // subgroup topology
    const int* __restrict__ srl, const int* __restrict__ banned,
    const u8* __restrict__ active, const u8* __restrict__ lane_mask,
    const float* __restrict__ score_bias, const float* __restrict__ agg,
    // extended mode
    const float* __restrict__ task_ext, const float* __restrict__ ext_accel,
    const float* __restrict__ ext0, const float* __restrict__ ext_rel,
    const float* __restrict__ ext_extra, const float* __restrict__ esumm,
    int T, int N, int NS, int D, int K, int L, int S, int Q, int E,
    int binpack_accel, int binpack_cpu, int device_pack, int track,
    int legacy, int extra_ls, int extra_dev_ls, int qa_ls, int ext_ls,
    float jscale,
    // outputs
    float* __restrict__ qa2, float* __restrict__ qan2,
    int* __restrict__ nodes_t, int* __restrict__ dev_t,
    u8* __restrict__ pipe_t, u8* __restrict__ success,
    float* __restrict__ free_rows, float* __restrict__ dev_rows,
    float* __restrict__ bind_rows, float* __restrict__ devbind_rows,
    int* __restrict__ sub_dom_out, float* __restrict__ ext_rows,
    float* __restrict__ extbind_rows) {
  // dynamic shared memory: the touched nodes' rows and live summaries (the
  // extended rows, claims and sums too), the debited domains per level,
  // then the staged nodes' soft score, density input, domain aggregate
  // (topology) and flag byte
  extern __shared__ float s_dyn[];
  const bool topo = agg != nullptr;
  int* s_tnode = reinterpret_cast<int*>(s_dyn);
  float* s_tfree = s_dyn + T;
  float* s_tbind = s_tfree + T * 3;
  float* s_tdev = s_tbind + T * 3;
  float* s_tdbind = s_tdev + T * D;
  float* s_tsum = s_tdbind + T * D;
  float* s_text = s_tsum + T * PF_NLIVE;
  float* s_tebind = s_text + T * E;
  float* s_tesum = s_tebind + T * E;
  int* s_dchg_n = reinterpret_cast<int*>(s_tesum + T * 2 * E);
  int* s_dchg_id = s_dchg_n + (topo ? L : 0);
  const int nd = topo ? L * T : 0;
  float* s_dchg_a = reinterpret_cast<float*>(s_dchg_id + nd);
  // the chosen node's domain at every level and their aggregates
  int* s_ntopo = reinterpret_cast<int*>(s_dchg_a + nd * 3);
  float* s_nagg = reinterpret_cast<float*>(s_ntopo + L);
  float* s_sf = s_nagg + L * 3;
  float* s_na = s_sf + NS;
  float* s_ag = s_na + NS;
  u8* s_fl = reinterpret_cast<u8*>(s_ag + (topo ? NS : 0));

  __shared__ PfLane Ln;
  __shared__ int s_forbid[2 * PF_MAXT];
  __shared__ bool s_elig[PF_MAXT], s_gate[PF_MAXT];
  __shared__ float s_r0[PF_WARPS], s_r1[PF_WARPS], s_r2[PF_WARPS];
  __shared__ int s_cnt[PF_WARPS];
  __shared__ float s_bv[PF_WARPS];  // pass 2's warp bests
  __shared__ int s_bi[PF_WARPS];
  // the chosen node's rows: free, releasing, extra, max(memory, EPS); its
  // device free, releasing and victim-freed rows
  __shared__ float s_nrow[10], s_ndev[3 * PF_MAXD];
  __shared__ u8 s_bf[PF_WARPS];
  // extended mode: each task's g-number equivalent, the step's request and
  // the chosen node's extended, releasing and victim-freed rows
  __shared__ float s_gq[PF_MAXT], s_te[PF_MAXE], s_next[3 * PF_MAXE];
  const int b = blockIdx.x;
  if (active && !active[b]) return;  // not a retried lane: keep its output
  // the lane's pools and queue table (a zero stride: shared), its summaries
  extra += (size_t)b * extra_ls;
  extra_dev += (size_t)b * extra_dev_ls;
  qa += (size_t)b * qa_ls;
  ext_extra += (size_t)b * ext_ls;
  if (extra_ls || extra_dev_ls || ext_ls) {
    summ += (size_t)b * PF_NF * N;
    esumm += (size_t)b * 2 * E * N;
  }
  const float* bias_b = score_bias ? score_bias + (size_t)b * N : nullptr;
  const int tid = threadIdx.x;
  const int lane_w = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane_w) - 1u;
  const u8* mask_b = lane_mask ? lane_mask + (size_t)b * N : nullptr;
  for (int i = tid; i < NS; i += PF_THREADS) s_fl[i] = 0;
  if (topo)
    for (int i = tid; i < L; i += PF_THREADS) s_dchg_n[i] = 0;

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
      // legacy: every valid task (none is placed yet)
      s_elig[t] = legacy ? unplaced[t]
                         : (in_quorum ? elig_q[t] : first_unplaced);
      goal += s_elig[t];
    }
    Ln.goal = goal;
    // the g-number equivalents, a dot over E from +0.0
    for (int t = 0; t < T; ++t) {
      float gq = 0.0f;
      for (int e = 0; e < E; ++e)
        gq = __fadd_rn(gq, __fmul_rn(task_ext[((size_t)gi * T + t) * E + e],
                                     ext_accel[e]));
      s_gq[t] = gq;
    }
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
    // order (blocks of 16 from +0.0, then the block totals' prefix),
    // tested against each ancestor queue of the chain
    float cum[PF_MAXT][3];
    float excl[3] = {0.0f, 0.0f, 0.0f}, inb[3] = {0.0f, 0.0f, 0.0f};
    for (int t = 0; t < T; ++t) {
      if (t > 0 && t % 16 == 0)
        for (int r = 0; r < 3; ++r) {
          excl[r] = __fadd_rn(excl[r], inb[r]);
          inb[r] = 0.0f;
        }
      for (int r = 0; r < 3; ++r) {
        float v = s_elig[t] ? task_req[((size_t)gi * T + t) * 3 + r] : 0.0f;
        // the extended mode's g-number equivalents join the accel column
        if (E > 0 && r == 0 && s_elig[t]) v = __fadd_rn(v, s_gq[t]);
        inb[r] = __fadd_rn(inb[r], v);
        cum[t][r] = t < 16 ? inb[r] : __fadd_rn(inb[r], excl[r]);
      }
    }
    bool lim_ok[PF_MAXT], quo_ok[PF_MAXT];
    for (int t = 0; t < T; ++t) lim_ok[t] = quo_ok[t] = true;
    const u8* anc = chain + (size_t)Ln.queue * Q;
    for (int q = 0; q < Q; ++q) {
      if (!anc[q]) continue;
      for (int r = 0; r < 3; ++r) {
        const float a = qa[q * 3 + r], an = qan[q * 3 + r];
        const float lim = __fadd_rn(limit_eff[q * 3 + r], KAI_EPS);
        const float quo = __fadd_rn(quota_eff[q * 3 + r], KAI_EPS);
        for (int t = 0; t < T; ++t) {
          lim_ok[t] = lim_ok[t] && __fadd_rn(a, cum[t][r]) <= lim;
          quo_ok[t] = quo_ok[t] && __fadd_rn(an, cum[t][r]) <= quo;
        }
      }
    }
    for (int t = 0; t < T; ++t)
      s_gate[t] = lim_ok[t] && (!Ln.nonpre || quo_ok[t]);
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

  PfStep c;
  c.summ = summ;
  c.esumm = esumm;
  c.te = s_te;
  c.tesum = s_tesum;
  c.E = E;
  c.tsum = s_tsum;
  c.tnode = s_tnode;
  c.agg = agg;
  c.dchg_id = s_dchg_id;
  c.dchg_a = s_dchg_a;
  c.dchg_n = s_dchg_n;
  c.valid_mask = mask_b;
  c.labels = labels;
  c.topology = topology;
  c.forbid = s_forbid;
  c.N = N;
  c.K = K;
  c.L = L;
  c.T = T;
  c.track = track != 0;
  c.asl = Ln.asl;
  c.has_asl = Ln.has_asl;
  c.has_pref = Ln.has_pref;
  c.lvl_asl = min(max(c.asl, 0), L - 1);
  c.lvl_pref = max(Ln.pl, 0);
  const float big = FLT_MAX;
  // each warp's contiguous node range, a multiple of 32 long
  const int chunk = ((N + PF_THREADS - 1) / PF_THREADS) * 32;
  const int w_lo = warp * chunk, w_hi = min(w_lo + chunk, N);

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
      for (int e = 0; e < E; ++e) s_te[e] = task_ext[o * E + e];
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
    c.has_srl = Ln.has_srl;
    c.needs_pick = Ln.needs_pick;
    c.lvl_s = c.has_srl ? Ln.lvl : 0;
    c.locked = c.has_srl ? Ln.locked : -1;
    c.ban = c.needs_pick ? Ln.banned : INT_MIN;
    {
      const float* srem = Ln.sub_rem[c.has_srl ? Ln.sub : 0];
      c.srem0 = srem[0];
      c.srem1 = srem[1];
      c.srem2 = srem[2];
    }
    c.req0 = Ln.req[0];
    c.req1 = Ln.req[1];
    c.req2 = Ln.req[2];
    c.por = Ln.por;
    c.mem = Ln.mem;
    c.is_frac = Ln.is_frac;
    c.ntouch = Ln.ntouch;
    c.nforbid = Ln.nforbid;
    c.pref_dom = Ln.pref_dom;
    const int cls = Ln.cls, nom = Ln.nom;
    c.fmask = fmask + (size_t)cls * N;
    c.sel = task_sel + ((size_t)Ln.gi * T + t) * K;
    c.rq0 = (c.track && c.is_frac) ? 0.0f : c.req0;
    c.res = c.req0 > 0.0f ? 0 : 1;
    const bool binpack =
        c.req0 > 0.0f ? binpack_accel != 0 : binpack_cpu != 0;
    const float* soft_c = soft + (size_t)cls * N;

    // ---- pass 1 (global): fit bits, density range, feasible counts ------
    float mn = big, mx = -big, dmx = -INFINITY;
    int wcnt = 0;
    for (int i0 = w_lo; i0 < w_hi; i0 += 32) {
      const int n = i0 + lane_w;
      u8 fl = 0;
      if (n < w_hi) {
        const u8 old = n < NS ? s_fl[n] : 0;
        const int tj = n < NS ? ((old & PFL_TOUCH) ? pf_find_touch(c, n) : -1)
                              : pf_find_touch(c, n);
        const float sf = n < NS ? soft_c[n] : 0.0f;  // in the same trip
        float na = 0.0f, ag = 0.0f;
        fl = pf_eval(c, n, tj, na, ag);
        if (c.needs_pick) dmx = fmaxf(dmx, (fl & PFL_DOMOK) ? ag : 0.0f);
        if ((fl & PFL_FP) && (fl & PFL_HASRES)) {
          mn = fminf(mn, na);
          mx = fmaxf(mx, na);
        }
        if (n < NS) {
          s_fl[n] = (old & PFL_TOUCH) | fl;
          s_na[n] = na;
          s_sf[n] = sf;
          if (topo) s_ag[n] = ag;
        }
      }
      wcnt += __popc(__ballot_sync(0xffffffffu, (fl & PFL_FP) != 0));
    }
    for (int off = 16; off > 0; off >>= 1) {
      mn = fminf(mn, __shfl_down_sync(0xffffffffu, mn, off));
      mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
      dmx = fmaxf(dmx, __shfl_down_sync(0xffffffffu, dmx, off));
    }
    if (lane_w == 0) {
      s_r0[warp] = mn;
      s_r1[warp] = mx;
      s_r2[warp] = dmx;
      s_cnt[warp] = wcnt;
    }
    __syncthreads();
    // every thread folds the warps' values in the same order
    int total = 0, run = 0;
    mn = s_r0[0];
    mx = s_r1[0];
    dmx = s_r2[0];
    for (int w = 0; w < PF_WARPS; ++w) {
      if (w < warp) run += s_cnt[w];
      total += s_cnt[w];
      mn = fminf(mn, s_r0[w]);
      mx = fmaxf(mx, s_r1[w]);
      dmx = fmaxf(dmx, s_r2[w]);
    }
    if (total == 0) {  // nothing feasible: the step places nothing
      if (tid == 0) {
        nodes_t[(size_t)b * T + t] = -1;
        dev_t[(size_t)b * T + t] = -1;
        pipe_t[(size_t)b * T + t] = 0;
      }
      continue;
    }
    const float span = __fsub_rn(mx, mn);
    const float dmx_eps = fmaxf(dmx, KAI_EPS);

    // ---- pass 2 (shared): feasible rank, score, argmax (lowest node) -----
    float best = -INFINITY;
    int best_i = INT_MAX;
    u8 best_fl = 0;
    for (int i0 = w_lo; i0 < w_hi; i0 += 32) {
      const int n = i0 + lane_w;
      u8 fl = 0;
      float na = 0.0f, ag = 0.0f, sf = 0.0f;
      if (n < w_hi) {
        if (n < NS) {
          fl = s_fl[n];
          na = s_na[n];
          sf = s_sf[n];
          if (topo) ag = s_ag[n];
        } else {  // past the staged nodes: evaluate again
          fl = pf_eval(c, n, pf_find_touch(c, n), na, ag);
          if (fl & PFL_FP) sf = soft_c[n];
        }
      }
      const bool fp = (fl & PFL_FP) != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, fp);
      if (n < w_hi) {
        float score = KAI_BIG_NEG;
        if (fp) {
          float place = 0.0f;
          if (fl & PFL_HASRES) {
            float raw = 1.0f;
            if (span > 0.0f) {
              const float frac =
                  __fdiv_rn(__fsub_rn(na, mn), fmaxf(span, 1e-30f));
              raw = binpack ? __fsub_rn(1.0f, frac) : frac;
            }
            place = __fmul_rn(9.0f, raw);
          }
          const float rtype = (fl & PFL_RTYPE) ? 10.0f : 0.0f;
          const float avl = (fl & PFL_FI) ? 100.0f : 0.0f;
          const float bands =
              __fadd_rn(__fadd_rn(__fadd_rn(0.0f, place), rtype), avl);
          const float topo_b = (fl & PFL_TOPOB) ? 10000.0f : 0.0f;
          // the domain-binpack band of a subgroup's first placement
          float dom_band = 0.0f;
          if (c.needs_pick && (fl & PFL_DOMOK))
            dom_band = __fmul_rn(10000.0f,
                                 __fsub_rn(1.0f, __fdiv_rn(ag, dmx_eps)));
          const int rank = run + __popc(bal & lt_mask);
          const float jit = __fmul_rn(jscale, (float)kai_pymod(rank - b, N));
          float eb = __fadd_rn(
              __fadd_rn(__fadd_rn(__fadd_rn(topo_b, dom_band), jit), sf),
              n == nom ? 1000000.0f : 0.0f);
          if (bias_b) eb = __fadd_rn(eb, bias_b[n]);
          if (c.track)
            eb = __fadd_rn(eb, (c.is_frac && (fl & PFL_SHARED)) ? 1000.0f
                                                                : 0.0f);
          score = __fadd_rn(__fadd_rn(0.0f, bands), eb);
        }
        if (kai_better(score, n, best, best_i)) {
          best = score;
          best_i = n;
          best_fl = fl;
        }
      }
      run += __popc(bal);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_down_sync(0xffffffffu, best, off);
      const int i2 = __shfl_down_sync(0xffffffffu, best_i, off);
      const int f2 = __shfl_down_sync(0xffffffffu, (int)best_fl, off);
      if (kai_better(v2, i2, best, best_i)) {
        best = v2;
        best_i = i2;
        best_fl = (u8)f2;
      }
    }
    if (lane_w == 0) {
      s_bv[warp] = best;
      s_bi[warp] = best_i;
      s_bf[warp] = best_fl;
    }
    __syncthreads();

    // ---- bookkeeping on the chosen node: warp 0 folds the warps' bests
    // and stages the node's rows (one load a lane), one thread updates ----
    if (warp == 0) {
      best = s_bv[0];
      best_i = s_bi[0];
      best_fl = s_bf[0];
      for (int w = 1; w < PF_WARPS; ++w)
        if (kai_better(s_bv[w], s_bi[w], best, best_i)) {
          best = s_bv[w];
          best_i = s_bi[w];
          best_fl = s_bf[w];
        }
      const int node = best_i;
      if (lane_w < 3) {
        s_nrow[lane_w] = free0[(size_t)node * 3 + lane_w];
        s_nrow[3 + lane_w] = rel[(size_t)node * 3 + lane_w];
        s_nrow[6 + lane_w] = extra[(size_t)node * 3 + lane_w];
      }
      for (int d = lane_w; d < D; d += 32) {
        const size_t o = (size_t)node * D + d;
        s_ndev[d] = dev0[o];
        s_ndev[PF_MAXD + d] = dev_rel[o];
        s_ndev[2 * PF_MAXD + d] = extra_dev[o];
      }
      for (int lv = lane_w; lv < L; lv += 32) {
        const int did = topology[(size_t)node * L + lv];
        s_ntopo[lv] = did;
        if (topo && did >= 0)
          for (int r = 0; r < 3; ++r)
            s_nagg[lv * 3 + r] = agg[(size_t)did * 3 + r];
      }
      if (lane_w == 0) s_nrow[9] = summ[(size_t)PF_DMEM * N + node];
      if (lane_w < E) {
        const size_t o = (size_t)node * E + lane_w;
        s_next[lane_w] = ext0[o];
        s_next[PF_MAXE + lane_w] = ext_rel[o];
        s_next[2 * PF_MAXE + lane_w] = ext_extra[o];
      }
      __syncwarp();
    }
    if (tid == 0) {
      const int node = best_i;
      const float* nrel = s_nrow + 3;
      const float* nextra = s_nrow + 6;
      const float* ndrel = s_ndev + PF_MAXD;
      const float* ndext = s_ndev + 2 * PF_MAXD;
      const bool is_pipe = (best_fl & PFL_FI) == 0;
      int j = 0;
      while (j < Ln.ntouch && s_tnode[j] != node) ++j;
      float* tfree = s_tfree + j * 3;
      float* tbind = s_tbind + j * 3;
      float* tdev = s_tdev + j * D;
      float* tdbind = s_tdbind + j * D;
      if (j == Ln.ntouch) {
        ++Ln.ntouch;
        s_tnode[j] = node;
        if (node < NS) s_fl[node] |= PFL_TOUCH;
        for (int r = 0; r < 3; ++r) {
          tfree[r] = s_nrow[r];
          tbind[r] = 0.0f;
        }
        for (int d = 0; d < D; ++d) {
          tdev[d] = s_ndev[d];
          tdbind[d] = 0.0f;
        }
        for (int e = 0; e < E; ++e) {
          s_text[j * E + e] = s_next[e];
          s_tebind[j * E + e] = 0.0f;
        }
      }
      const float req0 = Ln.req[0];
      const bool is_frac = Ln.is_frac;
      float p = req0;
      int frac_dev = -1;
      if (track) {
        p = pf_portion(Ln.por, Ln.mem, s_nrow[9]);
        float rel_row[PF_MAXD], key[PF_MAXD];
        bool elig[PF_MAXD];
        for (int d = 0; d < D; ++d) rel_row[d] = __fadd_rn(ndrel[d], ndext[d]);
        // fraction: the GpuOrderFn pick over idle (+ releasing when it
        // pipelines) share
        const float pm = __fsub_rn(p, KAI_EPS);
        int pick = 0;
        float kbest = device_pack ? INFINITY : -INFINITY;
        for (int d = 0; d < D; ++d) {
          const float row = is_pipe ? __fadd_rn(tdev[d], rel_row[d])
                                    : tdev[d];
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
          elig[d] = __fadd_rn(tdev[d], rel_row[d]) >= PF_ONE_M_EPS;
          key[d] = elig[d] ? -tdev[d] : INFINITY;
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
          tdev[d] = __fadd_rn(tdev[d], -dd[d]);
          if (!is_pipe) tdbind[d] = __fadd_rn(tdbind[d], dd[d]);
        }
      }
      // the node's accel debit uses its own share; the queue's the request
      const float dn[3] = {is_frac ? p : req0, Ln.req[1], Ln.req[2]};
      for (int r = 0; r < 3; ++r) {
        tfree[r] = __fadd_rn(tfree[r], -dn[r]);
        if (!is_pipe) tbind[r] = __fadd_rn(tbind[r], dn[r]);
        // the queue ledger counts the g-number equivalents (extended mode)
        const float dq =
            (E > 0 && r == 0) ? __fadd_rn(Ln.req[0], s_gq[t]) : Ln.req[r];
        Ln.q_delta[r] = __fadd_rn(Ln.q_delta[r], dq);
      }
      if (E > 0) {  // the extended row, its claims and its live sums
        float* tex = s_text + j * E;
        for (int e = 0; e < E; ++e) {
          tex[e] = __fadd_rn(tex[e], -s_te[e]);
          if (!is_pipe) s_tebind[j * E + e] = __fadd_rn(s_tebind[j * E + e],
                                                       s_te[e]);
        }
        pf_summarize_ext(tex, s_next + PF_MAXE, s_next + 2 * PF_MAXE, E,
                         s_tesum + j * 2 * E, 1);
      }
      // the node's live summary, read instead of the chunk-start one
      pf_summarize(tfree, tdev, nrel, nextra, ndrel, ndext, D,
                   s_tsum + j * PF_NLIVE, 1);
      if (c.has_asl)
        s_forbid[Ln.nforbid++] = c.asl >= L ? node : s_ntopo[c.lvl_asl];
      nodes_t[(size_t)b * T + t] = node;
      dev_t[(size_t)b * T + t] = is_frac ? frac_dev : -1;
      pipe_t[(size_t)b * T + t] = is_pipe ? 1 : 0;
      ++Ln.count;
      if (Ln.pref_dom < 0) Ln.pref_dom = s_ntopo[c.lvl_pref];
      if (topo) {
        const int st = Ln.sub;
        if (c.needs_pick) Ln.sub_dom[st] = s_ntopo[c.lvl_s];
        for (int r = 0; r < 3; ++r)
          Ln.sub_rem[st][r] = __fadd_rn(Ln.sub_rem[st][r], -Ln.req[r]);
        // the node's domain at every level loses the placement, in the
        // lane's list of debited domains (the junk domain -1 is never read)
        for (int lv = 0; lv < L; ++lv) {
          const int did = s_ntopo[lv];
          if (did < 0) continue;
          int* ids = s_dchg_id + lv * T;
          int k = 0;
          while (k < s_dchg_n[lv] && ids[k] != did) ++k;
          float* a = s_dchg_a + ((size_t)lv * T + k) * 3;
          if (k == s_dchg_n[lv]) {
            ++s_dchg_n[lv];
            ids[k] = did;
            for (int r = 0; r < 3; ++r) a[r] = s_nagg[lv * 3 + r];
          }
          for (int r = 0; r < 3; ++r) a[r] = __fadd_rn(a[r], -dn[r]);
        }
      }
    }
  }
  __syncthreads();

  // ---- outputs: success, final rows of the touched nodes, queue tables ---
  if (tid == 0)
    success[b] = (legacy ? Ln.count >= min_needed[Ln.gi]
                         : (Ln.goal > 0 && Ln.count >= Ln.goal))
                     ? 1
                     : 0;
  if (topo)
    for (int s2 = tid; s2 < S; s2 += PF_THREADS)
      sub_dom_out[(size_t)b * S + s2] = Ln.sub_dom[s2];
  for (int t = tid; t < T; t += PF_THREADS) {
    const int node = nodes_t[(size_t)b * T + t];
    const size_t o = (size_t)b * T + t;
    int j = -1;
    if (node >= 0)
      for (int u = 0; u < Ln.ntouch; ++u)
        if (s_tnode[u] == node) j = u;
    for (int r = 0; r < 3; ++r) {
      free_rows[o * 3 + r] = j >= 0 ? s_tfree[j * 3 + r] : 0.0f;
      bind_rows[o * 3 + r] = j >= 0 ? s_tbind[j * 3 + r] : 0.0f;
    }
    for (int d = 0; d < D; ++d) {
      dev_rows[o * D + d] = j >= 0 ? s_tdev[j * D + d] : 0.0f;
      devbind_rows[o * D + d] = j >= 0 ? s_tdbind[j * D + d] : 0.0f;
    }
    for (int e = 0; e < E; ++e) {
      ext_rows[o * E + e] = j >= 0 ? s_text[j * E + e] : 0.0f;
      extbind_rows[o * E + e] = j >= 0 ? s_tebind[j * E + e] : 0.0f;
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

static int pf_prologue(const float* free0, const float* dev0,
                       const float* rel, const float* extra,
                       const float* dev_rel, const float* extra_dev,
                       const float* alloc, const u8* valid,
                       const float* dev_mem, int N, int D, float* summ,
                       const int* dom_ptr, const int* dom_nodes, int ND,
                       int sum_agg, float* agg, int lanes, int extra_ls,
                       int extra_dev_ls, const float* ext0,
                       const float* ext_rel, const float* ext_extra, int E,
                       int ext_ls, float* esumm, cudaStream_t stream) {
  const int work = sum_agg && 32 * (ND + 1) > N ? 32 * (ND + 1) : N;
  const dim3 grid((work + 255) / 256, lanes);
  pf_prologue_kernel<<<grid, 256, 0, stream>>>(
      free0, dev0, rel, extra, dev_rel, extra_dev, alloc, valid, dev_mem, N,
      D, summ, dom_ptr, dom_nodes, ND, sum_agg, agg, extra_ls, extra_dev_ls,
      ext0, ext_rel, ext_extra, E, ext_ls, esumm);
  return static_cast<int>(cudaGetLastError());
}

// the summary alone (its card test holds it against the plain mirror)
KAI_EXPORT int kai_pertask_summary(const float* free0, const float* dev0,
                                   const float* rel, const float* extra,
                                   const float* dev_rel,
                                   const float* extra_dev, const float* alloc,
                                   const u8* valid, const float* dev_mem,
                                   int N, int D, float* summ,
                                   cudaStream_t stream) {
  if (N < 1 || D < 0 || D > PF_MAXD) return KAI_ERR_ARGS;
  return pf_prologue(free0, dev0, rel, extra, dev_rel, extra_dev, alloc,
                     valid, dev_mem, N, D, summ, nullptr, nullptr, 0, 0,
                     nullptr, 1, 0, 0, nullptr, nullptr, nullptr, 0, 0,
                     nullptr, stream);
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
    const u8* active, const u8* lane_mask, const float* score_bias,
    const float* task_ext, const float* ext_accel, const float* ext0,
    const float* ext_rel, const float* ext_extra, float* agg_scratch,
    float* summ, float* esumm, int B, int T, int N, int D, int K, int X,
    int L, int S, int Q, int G, int E, int binpack_accel, int binpack_cpu,
    int device_pack, int track, int agg_ready, int legacy, int extra_ls,
    int extra_dev_ls, int qa_ls, int ext_ls, float jscale, float* qa2,
    float* qan2, int* nodes_t, int* dev_t, u8* pipe_t, u8* success,
    float* free_rows, float* dev_rows, float* bind_rows, float* devbind_rows,
    int* sub_dom, float* ext_rows, float* extbind_rows,
    cudaStream_t stream) {
  if (B < 1 || T < 1 || T > PF_MAXT || N < 1 || D < 0 || D > PF_MAXD ||
      K < 0 || X < 1 || L < 1 || S < 1 || S > PF_MAXS || Q < 1 || G < 1 ||
      E < 0 || E > PF_MAXE || !summ)
    return KAI_ERR_ARGS;
  if (E > 0 && !(task_ext && ext_accel && ext0 && ext_rel && ext_extra &&
                 esumm && ext_rows && extbind_rows))
    return KAI_ERR_ARGS;
  if (ext_ls && ext_ls != N * E) return KAI_ERR_ARGS;
  const bool topo = dom_ptr != nullptr;
  if (topo != (dom_nodes && agg_scratch && sub_dom) ||
      ((banned || agg_ready) && !topo))
    return KAI_ERR_ARGS;
  if (topo && (legacy || extra_ls || extra_dev_ls || qa_ls))
    return KAI_ERR_ARGS;  // the victim modes take no subgroup topology
  if ((extra_ls && extra_ls != N * 3) || (extra_dev_ls && extra_dev_ls != N * D)
      || (qa_ls && qa_ls != Q * 3))
    return KAI_ERR_ARGS;
  if (topo && ext_ls) return KAI_ERR_ARGS;
  const int lanes = (extra_ls || extra_dev_ls || ext_ls) ? B : 1;
  int rc = pf_prologue(free0, dev0, rel, extra, dev_rel, extra_dev, alloc,
                       valid, dev_mem, N, D, summ, dom_ptr, dom_nodes,
                       topo ? N * L : 0, topo && !agg_ready, agg_scratch,
                       lanes, extra_ls, extra_dev_ls, ext0, ext_rel,
                       ext_extra, E, ext_ls, esumm, stream);
  if (rc != 0) return rc;
  // dynamic shared memory: the touched rows and live summaries, the
  // debited domains, then as many staged nodes as the budget holds
  const size_t fixed =
      sizeof(float) * ((size_t)T * (1 + 6 + 2 * D + PF_NLIVE + 4 * E) +
                       (topo ? (size_t)L * (T * 4 + 1) : 0) +
                       (size_t)L * 4);
  const size_t per_node = 9 + (topo ? 4 : 0);
  size_t ns = fixed < PF_SMEM_BUDGET ? (PF_SMEM_BUDGET - fixed) / per_node : 0;
  if (ns > (size_t)N) ns = N;
  const size_t smem = fixed + ns * per_node;
  const cudaError_t e = cudaFuncSetAttribute(
      pertask_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  pertask_fill_kernel<<<B, PF_THREADS, smem, stream>>>(
      task_req, task_valid, task_sel, task_portion, task_mem, task_class,
      task_nom, task_sub, sub_need, min_needed, gang_queue, preemptible,
      anti_self, pref_level, free0, dev0, rel, extra, dev_rel, extra_dev,
      labels, fmask, soft, topology, summ, qa, qan, limit_eff, quota_eff,
      chain, cand, prior, srl, banned, active, lane_mask, score_bias,
      topo ? agg_scratch : nullptr, task_ext, ext_accel, ext0, ext_rel,
      ext_extra, esumm, T, N, (int)ns, D, K, L, S, Q, E, binpack_accel,
      binpack_cpu, device_pack, track, legacy, extra_ls, extra_dev_ls, qa_ls,
      ext_ls, jscale, qa2, qan2, nodes_t, dev_t, pipe_t, success, free_rows,
      dev_rows, bind_rows, devbind_rows, sub_dom, ext_rows, extbind_rows);
  return static_cast<int>(cudaGetLastError());
}
