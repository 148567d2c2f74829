// K10 dense_accept — the dense accept prefix of an allocate chunk and its
// weighted commit.
//
// Replaces kai_scheduler_tpu/ops/allocate.py:1730-1777 (the dense prefix
// test on the node, bind-now, device and device bind-now pools, the
// reference's `jnp.cumsum(axis=0)` over [B, N, R] and [B, N, D] lane deltas)
// and the commit :1779-1795 (`free - einsum(w, d_free)`, the same for the
// device pool, `qa + einsum(w, d_qa)` and `qan`).  The extended mode (E > 0;
// ref :1756-1767, :1794-1795) holds the extended pool [N, E] the same way,
// against its floor -(extended_releasing + extended_releasing_extra) - EPS,
// from K9's extended rows: E more columns on the same entries, after the
// device columns.
//
// The lanes' claims come as K9's (or K3's) rows: for each lane, the final
// pools of the nodes it placed on.  Lane b's delta at node n is
// `free[n] - row` where b touched n and zero elsewhere, so a node's
// cumulative claim changes only at the lanes that touched it.  Two
// launches:
//   1. `da_zero_kernel`, a grid-stride pass over every node (and device):
//      the zero claim (`free - 0 >= floor`) holds for every lane or none;
//      where it fails, no lane is accepted (`first_bad = 0`).
//   2. `da_accept_kernel`, one block:
//      a. the live entries — a successful lane's FIRST slot at each node
//         (its later slots there carry the same final row: the reference
//         counts each lane once) — gathered with one atomic a warp as
//         64-bit keys (node << 32 | lane * T + slot) and bitonic-sorted in
//         shared memory: each node's entries form one run, one entry a
//         lane, in ascending lane order;
//      b. the runs listed, short (at most 16 entries) and long;
//      c. each run's first failing lane.  The cumulative claim is
//         XLA:CPU's cumsum order: blocks of 16 lanes each summed left to
//         right from +0.0, the block totals likewise, each block's
//         exclusive prefix added last.  A short run takes one thread a
//         column, walking the run in order and folding each finished
//         block's total.  A long run takes one warp: a group of lanes a
//         column, one lane a non-empty 16-lane block — the block's deltas
//         and total from +0.0, the earlier blocks' totals added in
//         ascending order by shuffles, then each lane's claim tested.
//         The first failing lane of a run is its lowest (the claims only
//         grow along the run); `first_bad` is the block minimum over runs
//         and launch 1's zero claim;
//      d. take = ok & gate_ok & (lane < first_bad); one thread a (run,
//         column) sums the run's taken lanes' deltas in ascending lane
//         order from +0.0, walking no further than first_bad, and writes
//         `free - sum` (and the device row); the queue tables add the
//         taken lanes' deltas in ascending order.
// No [B, N, R] or [B, N, D] cumulative is built, and no entry compares
// itself with another lane's slots: the previous design walked lanes 0..b
// for every entry and probed T slots at each, O((B T)^2) shared-memory
// reads a launch; no check now walks more than 16 lanes of a run.
//
// Bound: bytes — the live entries' rows, the pools at their nodes, the
// zero claim's whole pools and floors, the queue deltas, once each
// (`chip_smoke.py` computes it from each run's inputs).  The kernel is
// latency-bound: one block sorts and walks the runs.
#include "kai_common.cuh"

#define DA_THREADS 512
#define DA_WARPS (DA_THREADS / 32)
#define DA_MAXD 32
#define DA_MAXE 8
#define DA_MAXB 256
#define DA_BLOCK 16  // XLA:CPU's cumsum block
#define DA_NBLK (DA_MAXB / DA_BLOCK)
// the most the sort's keys and the run list take of shared memory (16,384
// entries); larger chunks use the caller's global scratch
#define DA_SMEM_KEYS (192 * 1024)

__global__ void __launch_bounds__(256) da_zero_kernel(
    const float* __restrict__ free_, const float* __restrict__ dev,
    const float* __restrict__ ext, const float* __restrict__ rel_floor,
    const float* __restrict__ dev_floor, const float* __restrict__ ext_floor,
    int N, int D, int E, int track, int* __restrict__ first_bad) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  bool bad = false;
  for (int i = gid; i < N * 3; i += stride)
    bad = bad || !(free_[i] >= rel_floor[i]);
  if (track)
    for (size_t i = gid; i < (size_t)N * D; i += stride)
      bad = bad || !(dev[i] >= dev_floor[i]);
  for (size_t i = gid; i < (size_t)N * E; i += stride)
    bad = bad || !(ext[i] >= ext_floor[i]);
  if (bad) atomicMin(first_bad, 0);
}

__device__ __forceinline__ int da_node(unsigned long long k) {
  return (int)(k >> 32);
}
__device__ __forceinline__ int da_entry(unsigned long long k) {
  return (int)(k & 0xffffffffull);
}

// the columns: the node pool's 3, then the device pool's D (with the device
// table), then the extended pool's E — an entry's row and bind-now row, a
// node's pool and floor
struct DaCols {
  const float* free_rows;
  const float* dev_rows;
  const float* ext_rows;
  const float* bind_rows;
  const float* devbind_rows;
  const float* extbind_rows;
  const float* free_;
  const float* dev;
  const float* ext;
  const float* rel_floor;
  const float* dev_floor;
  const float* ext_floor;
  int D, E;  // D is 0 without the device table
  __device__ __forceinline__ float at(const float* a, const float* b,
                                      const float* c, size_t i, int col) const {
    return col < 3       ? a[i * 3 + col]
           : col < 3 + D ? b[i * D + col - 3]
                         : c[i * E + col - 3 - D];
  }
  __device__ __forceinline__ float row(int e, int col) const {
    return at(free_rows, dev_rows, ext_rows, e, col);
  }
  __device__ __forceinline__ float bind(int e, int col) const {
    return at(bind_rows, devbind_rows, extbind_rows, e, col);
  }
  __device__ __forceinline__ float pool(int n, int col) const {
    return at(free_, dev, ext, n, col);
  }
  __device__ __forceinline__ float floor(int n, int col) const {
    return at(rel_floor, dev_floor, ext_floor, n, col);
  }
};

// the lowest sorted position in [lo, hi) of node n's run whose lane is at
// least `lane` (the run is lane-ascending)
__device__ __forceinline__ int da_lower_bound(const unsigned long long* keys,
                                              int lo, int hi, int lane,
                                              int T) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (da_entry(keys[mid]) / T < lane)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// node n's run ends at the first sorted position past `st` of another node
// (one warp)
__device__ __forceinline__ int da_run_end(const unsigned long long* keys,
                                          int st, int M, int n, int lane_w) {
  for (int en = st;; en += 32) {
    const int p = en + lane_w;
    const unsigned bal =
        __ballot_sync(0xffffffffu, p < M && da_node(keys[p]) == n);
    if (bal != 0xffffffffu) return en + __ffs(~bal) - 1;
  }
}

// the first lane of node n's run, from sorted position st, whose
// cumulative claim in column `col` fails its test (INT_MAX if none): the
// run walked in order, folding each finished 16-lane block's total
__device__ int da_check_serial(const unsigned long long* keys, int st,
                               int en, int T, int col, float pool,
                               float floor, const DaCols& cols) {
  const float lim = __fadd_rn(fmaxf(pool, 0.0f), KAI_EPS);
  float excl_f = 0.0f, inb_f = 0.0f, excl_b = 0.0f, inb_b = 0.0f;
  int blk = 0;
  for (int p = st; p < en; ++p) {
    const int e = da_entry(keys[p]), lane = e / T;
    if (lane / DA_BLOCK != blk) {  // fold the finished block's total
      blk = lane / DA_BLOCK;
      excl_f = __fadd_rn(excl_f, inb_f);
      excl_b = __fadd_rn(excl_b, inb_b);
      inb_f = inb_b = 0.0f;
    }
    inb_f = __fadd_rn(inb_f, __fsub_rn(pool, cols.row(e, col)));
    inb_b = __fadd_rn(inb_b, cols.bind(e, col));
    const float cf = __fadd_rn(inb_f, excl_f);
    const float cb = __fadd_rn(inb_b, excl_b);
    if (!(__fsub_rn(pool, cf) >= floor) || !(cb <= lim)) return lane;
  }
  return INT_MAX;
}

// the same for a long run, one warp: a group of g lanes a column, one lane
// a non-empty 16-lane block — the block's deltas and total from +0.0, the
// earlier blocks' totals added in ascending order by shuffles, then each
// of its lanes' claims tested
__device__ int da_check_warp(const unsigned long long* keys, int st, int en,
                             int n, int T, int C, const DaCols& cols,
                             int* s_bound, int* s_blk, int lane_w) {
  const unsigned lt_mask = (1u << lane_w) - 1u;
  if (lane_w <= DA_NBLK)
    s_bound[lane_w] = lane_w == DA_NBLK
                          ? en
                          : da_lower_bound(keys, st, en, lane_w * DA_BLOCK, T);
  __syncwarp();
  const bool ne = lane_w < DA_NBLK && s_bound[lane_w + 1] > s_bound[lane_w];
  const unsigned nem = __ballot_sync(0xffffffffu, ne);
  if (ne) s_blk[__popc(nem & lt_mask)] = lane_w;
  __syncwarp();
  const int nb = __popc(nem);
  int g = 1;
  while (g < nb) g <<= 1;
  const int r = lane_w & (g - 1), cc = lane_w / g, g0 = lane_w & ~(g - 1);
  int bad = INT_MAX;
  for (int c0 = 0; c0 < C; c0 += 32 / g) {
    const int col = c0 + cc;
    const bool act = col < C && r < nb;
    int lo = 0, hi = 0;
    float pool = 0.0f, floor = 0.0f;
    if (act) {
      lo = s_bound[s_blk[r]];
      hi = s_bound[s_blk[r] + 1];
      pool = cols.pool(n, col);
      floor = cols.floor(n, col);
    }
    float dv[DA_BLOCK], bv[DA_BLOCK];
    float tot_f = 0.0f, tot_b = 0.0f;
#pragma unroll
    for (int k = 0; k < DA_BLOCK; ++k) {
      const bool in = lo + k < hi;
      const int e = in ? da_entry(keys[lo + k]) : 0;
      dv[k] = in ? __fsub_rn(pool, cols.row(e, col)) : 0.0f;
      bv[k] = in ? cols.bind(e, col) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < DA_BLOCK; ++k)
      if (lo + k < hi) {
        tot_f = __fadd_rn(tot_f, dv[k]);
        tot_b = __fadd_rn(tot_b, bv[k]);
      }
    // the empty blocks' +0.0 totals change nothing
    float excl_f = 0.0f, excl_b = 0.0f;
    for (int k = 0; k < g; ++k) {
      const float tf = __shfl_sync(0xffffffffu, tot_f, g0 + k);
      const float tb = __shfl_sync(0xffffffffu, tot_b, g0 + k);
      if (k < r) {
        excl_f = __fadd_rn(excl_f, tf);
        excl_b = __fadd_rn(excl_b, tb);
      }
    }
    const float lim = __fadd_rn(fmaxf(pool, 0.0f), KAI_EPS);
    float inb_f = 0.0f, inb_b = 0.0f;
#pragma unroll
    for (int k = 0; k < DA_BLOCK; ++k)
      if (lo + k < hi) {
        inb_f = __fadd_rn(inb_f, dv[k]);
        inb_b = __fadd_rn(inb_b, bv[k]);
        const float cf = __fadd_rn(inb_f, excl_f);
        const float cb = __fadd_rn(inb_b, excl_b);
        if (!(__fsub_rn(pool, cf) >= floor) || !(cb <= lim)) {
          bad = min(bad, da_entry(keys[lo + k]) / T);
          break;
        }
      }
  }
  __syncwarp();
  return bad;
}

__global__ void __launch_bounds__(DA_THREADS) da_accept_kernel(
    const int* __restrict__ nodes_b, const u8* __restrict__ ok,
    const u8* __restrict__ gate_ok, const float* __restrict__ free_rows,
    const float* __restrict__ dev_rows, const float* __restrict__ bind_rows,
    const float* __restrict__ devbind_rows, const float* __restrict__ free_,
    const float* __restrict__ dev, const float* __restrict__ rel_floor,
    const float* __restrict__ dev_floor, const float* __restrict__ d_qa,
    const float* __restrict__ d_qan, const float* __restrict__ qa,
    const float* __restrict__ qan, const float* __restrict__ ext_rows,
    const float* __restrict__ extbind_rows, const float* __restrict__ ext,
    const float* __restrict__ ext_floor, int B, int T, int D, int E, int Q,
    int track, int P, const int* __restrict__ first_bad,
    u8* __restrict__ take, float* __restrict__ free2,
    float* __restrict__ dev2, float* __restrict__ ext2,
    float* __restrict__ qa2, float* __restrict__ qan2,
    unsigned long long* __restrict__ scratch_g) {
  // the keys [P] then the runs [P] (start << 8 | min(length, 255)): short
  // runs (at most 16 entries) from the front, long ones from the back
  extern __shared__ unsigned long long s_keys[];
  __shared__ int s_m, s_fb, s_ntl, s_nshort, s_nlong;
  __shared__ u8 s_take[DA_MAXB];
  __shared__ int s_tl[DA_MAXB];
  __shared__ int s_bound[DA_WARPS][DA_NBLK + 1], s_blk[DA_WARPS][DA_NBLK];
  unsigned long long* keys = scratch_g ? scratch_g : s_keys;
  int* runs = reinterpret_cast<int*>(keys + P);
  const int tid = threadIdx.x, lane_w = tid & 31, warp = tid >> 5;
  const unsigned lt_mask = (1u << lane_w) - 1u;
  const int n_ent = B * T;
  if (tid == 0) {
    s_m = s_nshort = s_nlong = 0;
    s_fb = INT_MAX;
  }
  __syncthreads();

  // a. the live entries — a successful lane's first slot at each node —
  // in any order (one atomic a warp), then sorted by (node, entry)
  for (int e0 = 0; e0 < n_ent; e0 += DA_THREADS) {
    const int e = e0 + tid;
    bool live = false;
    int n = -1;
    if (e < n_ent) {
      const int b = e / T;
      n = nodes_b[e];
      live = ok[b] && n >= 0;
      for (int u = b * T; u < e; ++u) live = live & (nodes_b[u] != n);
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    int base = 0;
    if (lane_w == 0 && bal) base = atomicAdd(&s_m, __popc(bal));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (live)
      keys[base + __popc(bal & lt_mask)] =
          ((unsigned long long)(unsigned)n << 32) | (unsigned)e;
  }
  __syncthreads();
  const int M = s_m;
  int PM = 1;
  while (PM < M) PM <<= 1;
  for (int i = M + tid; i < PM; i += DA_THREADS) keys[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= PM; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < PM; i += DA_THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], c = keys[ixj];
          if ((a > c) == ((i & k) == 0)) {
            keys[i] = c;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }

  // b. the runs (one a node), short and long, in any order (one atomic a
  // warp each)
  for (int p0 = 0; p0 < M; p0 += DA_THREADS) {
    const int p = p0 + tid;
    int len = 0;
    if (p < M && (p == 0 || da_node(keys[p - 1]) != da_node(keys[p]))) {
      const int n = da_node(keys[p]);
      len = 1;
      while (len <= DA_BLOCK && p + len < M && da_node(keys[p + len]) == n)
        ++len;
    }
    const bool shrt = len > 0 && len <= DA_BLOCK, lng = len > DA_BLOCK;
    const unsigned bs = __ballot_sync(0xffffffffu, shrt);
    const unsigned bl = __ballot_sync(0xffffffffu, lng);
    int base_s = 0, base_l = 0;
    if (lane_w == 0) {
      if (bs) base_s = atomicAdd(&s_nshort, __popc(bs));
      if (bl) base_l = atomicAdd(&s_nlong, __popc(bl));
    }
    base_s = __shfl_sync(0xffffffffu, base_s, 0);
    base_l = __shfl_sync(0xffffffffu, base_l, 0);
    if (shrt) runs[base_s + __popc(bs & lt_mask)] = p << 8 | len;
    if (lng) runs[P - 1 - (base_l + __popc(bl & lt_mask))] = p << 8;
  }
  __syncthreads();
  const int nshort = s_nshort, nlong = s_nlong;

  // c. each run's first failing lane: the short runs one thread a (run,
  // column), the long runs one warp a run
  const int Dt = track ? D : 0;
  DaCols cols{free_rows, dev_rows,  ext_rows,  bind_rows, devbind_rows,
              extbind_rows, free_,  dev,       ext,       rel_floor,
              dev_floor,    ext_floor, Dt,     E};
  const int C = 3 + Dt + E;
  int run_bad = INT_MAX;
  for (int i = tid; i < nshort * C; i += DA_THREADS) {
    const int rr = runs[i / C], col = i % C;
    const int st = rr >> 8, n = da_node(keys[st]);
    run_bad = min(run_bad, da_check_serial(keys, st, st + (rr & 255), T,
                                           col, cols.pool(n, col),
                                           cols.floor(n, col), cols));
  }
  for (int i = warp; i < nlong; i += DA_WARPS) {
    const int st = runs[P - 1 - i] >> 8, n = da_node(keys[st]);
    const int en = da_run_end(keys, st, M, n, lane_w);
    run_bad = min(run_bad, da_check_warp(keys, st, en, n, T, C, cols,
                                         s_bound[warp], s_blk[warp], lane_w));
  }
  for (int off = 16; off > 0; off >>= 1)
    run_bad = min(run_bad, __shfl_down_sync(0xffffffffu, run_bad, off));
  if (lane_w == 0 && run_bad != INT_MAX) atomicMin(&s_fb, run_bad);
  __syncthreads();

  // d. the taken lanes and the commit
  const int fb = min(s_fb, *first_bad);
  for (int b = tid; b < B; b += DA_THREADS) {
    const u8 tk = (ok[b] && gate_ok[b] && b < fb) ? 1 : 0;
    s_take[b] = tk;
    take[b] = tk;
  }
  __syncthreads();
  if (warp == 0) {  // the taken lanes in ascending order
    int base = 0;
    for (int k = 0; k < B; k += 32) {
      const int b = k + lane_w;
      const bool tk = b < B && s_take[b];
      const unsigned bal = __ballot_sync(0xffffffffu, tk);
      if (tk) s_tl[base + __popc(bal & lt_mask)] = b;
      base += __popc(bal);
    }
    if (lane_w == 0) s_ntl = base;
  }
  // one thread a (run, column): the run's taken lanes (all below
  // first_bad: the walk stops there), their deltas ascending from +0.0
  const int nruns = nshort + nlong;
  for (int i = tid; i < nruns * C; i += DA_THREADS) {
    const int ri = i / C, col = i % C;
    const int st = (ri < nshort ? runs[ri] : runs[P - 1 - (ri - nshort)]) >> 8;
    const int n = da_node(keys[st]);
    const float pool = cols.pool(n, col);
    float sum = 0.0f;
    bool any = false;
    for (int q = st; q < M && da_node(keys[q]) == n; ++q) {
      const int e = da_entry(keys[q]);
      if (e / T >= fb) break;
      if (!s_take[e / T]) continue;
      sum = __fadd_rn(sum, __fsub_rn(pool, cols.row(e, col)));
      any = true;
    }
    if (any) {
      const float v = __fsub_rn(pool, sum);
      if (col < 3)
        free2[(size_t)n * 3 + col] = v;
      else if (col < 3 + Dt)
        dev2[(size_t)n * D + col - 3] = v;
      else
        ext2[(size_t)n * E + col - 3 - Dt] = v;
    }
  }
  __syncthreads();
  const int ntl = s_ntl;
  for (int i = tid; i < Q * 3; i += DA_THREADS) {
    float s = 0.0f, sn = 0.0f;
    for (int j = 0; j < ntl; ++j) {
      const size_t o = (size_t)s_tl[j] * Q * 3 + i;
      s = __fadd_rn(s, d_qa[o]);
      sn = __fadd_rn(sn, d_qan[o]);
    }
    qa2[i] = __fadd_rn(qa[i], s);
    qan2[i] = __fadd_rn(qan[i], sn);
  }
}

KAI_EXPORT int kai_dense_accept(
    const int* nodes_b, const u8* ok, const u8* gate_ok,
    const float* free_rows, const float* dev_rows, const float* bind_rows,
    const float* devbind_rows, const float* free_, const float* dev,
    const float* rel_floor, const float* dev_floor, const float* d_qa,
    const float* d_qan, const float* qa, const float* qan,
    const float* ext_rows, const float* extbind_rows, const float* ext,
    const float* ext_floor, int B, int T, int N, int D, int E, int Q,
    int track, int* first_bad, u8* take, float* free2, float* dev2,
    float* ext2, float* qa2, float* qan2, unsigned long long* keys_scratch,
    cudaStream_t stream) {
  if (B < 1 || B > DA_MAXB || T < 1 || N < 1 || D < 0 || D > DA_MAXD ||
      Q < 1 || E < 0 || E > DA_MAXE)
    return KAI_ERR_ARGS;
  if (E > 0 && !(ext_rows && extbind_rows && ext && ext_floor && ext2))
    return KAI_ERR_ARGS;
  size_t P = 1;
  while (P < (size_t)B * T) P <<= 1;
  // the keys (8 bytes) and the runs (4 bytes) of P entries
  const size_t bytes = P * 12;
  const bool in_smem = bytes <= DA_SMEM_KEYS;
  if (!in_smem && !keys_scratch) return KAI_ERR_ARGS;
  const size_t smem = in_smem ? bytes : 0;
  // opted in at every size: with the static arrays, 48 KB of dynamic
  // shared memory is already past the default limit
  const cudaError_t ea = cudaFuncSetAttribute(
      da_accept_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (ea != cudaSuccess) return static_cast<int>(ea);
  const size_t work = (size_t)N * (3 + (track ? D : 0) + E);
  const int zblocks = work > 256 * 1024 ? 1024 : (int)((work + 255) / 256);
  da_zero_kernel<<<zblocks, 256, 0, stream>>>(free_, dev, ext, rel_floor,
                                              dev_floor, ext_floor, N, D, E,
                                              track, first_bad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  da_accept_kernel<<<1, DA_THREADS, smem, stream>>>(
      nodes_b, ok, gate_ok, free_rows, dev_rows, bind_rows, devbind_rows,
      free_, dev, rel_floor, dev_floor, d_qa, d_qan, qa, qan, ext_rows,
      extbind_rows, ext, ext_floor, B, T, D, E, Q, track, (int)P, first_bad,
      take, free2, dev2, ext2, qa2, qan2, in_smem ? nullptr : keys_scratch);
  return static_cast<int>(cudaGetLastError());
}
