// K7 replace_victims — sequential greedy re-placement of a consolidation
// scenario's victims (the allPodsReallocated validator).
//
// Replaces kai_scheduler_tpu/ops/victims.py:644 `_replace_victims`, the
// reference's lax.fori_loop over the first K = max(1, min(M, max_pods))
// victims in nonzero order.  Per victim:
//   1. every node is tested: resources + EPS against the pod's request
//      over free + releasing, node validity, the pod's filter class row,
//      extended scalars, and either the fractional share (the best
//      device's free + releasing share against the node-relative portion)
//      or the whole devices (count of devices >= 1 - EPS);
//   2. the argmax of -avail[:, accel] over fitting nodes, the LOWEST node
//      index on ties (jnp.argmax's rule); nothing fits -> placed = false;
//   3. the node's resources, extended scalars and devices are debited (a
//      fraction joins its best device, the first such on ties; whole
//      devices take the first fully free ones up to round(req[0])).
// Only the n_vic real victims are visited: the reference's iterations
// past n_vic add -0.0 everywhere and leave `moves` as it was (its own
// note at :721-726), so skipping them changes no bit.  all_ok starts as
// n_vic <= K.
//
// Design: ONE thread-block cluster (16 blocks where the card allows a
// cluster that wide, else 8), each block owning a contiguous slice of the
// nodes.  A block first copies its slice of the pools into the outputs
// (and fills `moves` with -1) and keeps, per node, what the fit test
// reads in shared memory: free + releasing (+ EPS) per resource, the
// accel avail (the score), (extended + releasing) + EPS per key, the
// device max, the whole-device count + EPS, the device memory and the
// valid bit.  A cached value is the same f32 expression over the same
// operands as the test's, so its bits are the test's; only the node just
// debited changes, and its row is recomputed from the new free, extended
// and device rows.  Rows past a block's shared memory live in the global
// scratch `cache` (same layout).  Per victim each block finds its best
// node (score desc, index asc) and puts it in a slot of its shared
// memory; one cluster barrier, and warp 0 of every block reduces the
// slots through distributed shared memory (the same winner everywhere);
// the owning block's warp 0 debits the node, a lane per resource, key and
// device (the fraction's device by a warp argmax, the whole devices by a
// ballot prefix count), in the outputs and in the cached row.  The slots
// alternate between two buffers, so one cluster barrier a victim
// suffices.
// Bound: bytes (the pools read once and the outputs written once; per
// victim the victim's rows and one node's rows).
#include <cooperative_groups.h>

#include <algorithm>

#include "kai_common.cuh"

namespace cg = cooperative_groups;

#define RV_THREADS 512
#define RV_WARPS (RV_THREADS / 32)
// shared memory a block keeps rows in
#define RV_SMEM (200 * 1024)
// the head of a block's shared memory: the block's two slots and the
// warps' bests
#define RV_HEAD ((2 * 3 + RV_WARPS * 3) * (int)sizeof(int))

// the cached row of a node: [R] free + releasing + EPS, [1] accel avail,
// [E] (extended + releasing) + EPS, device max, whole count + EPS, device
// memory, valid; its stride is odd (bank spread)
__host__ __device__ __forceinline__ int rv_stride(int R, int E) {
  return (R + E + 5) | 1;
}

__global__ void __launch_bounds__(RV_THREADS) replace_victims_kernel(
    const int* __restrict__ idxs, const int* __restrict__ n_vic_p, int K,
    const float* __restrict__ req, const int* __restrict__ device,
    const float* __restrict__ accel_mem, const float* __restrict__ held,
    const int* __restrict__ filter_class, const float* __restrict__ extended,
    const float* __restrict__ dev_mem, const u8* __restrict__ valid,
    const u8* __restrict__ fmask, const float* __restrict__ releasing,
    const float* __restrict__ dev_releasing,
    const float* __restrict__ ext_releasing, const float* __restrict__ free_in,
    const float* __restrict__ dev_in, const float* __restrict__ ext_in,
    int N, int M, int R, int D, int E, int slice, int cap,
    float* __restrict__ free_, float* __restrict__ dev,
    float* __restrict__ ext, int* __restrict__ moves,
    u8* __restrict__ all_ok, float* __restrict__ cache) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), csize = cluster.num_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ float rv_smem[];
  float* s_score = rv_smem;                      // [2] the block's best
  int* s_idx = (int*)(s_score + 2);              // [2]
  int* s_any = s_idx + 2;                        // [2]
  float* s_ws = (float*)(s_any + 2);             // [RV_WARPS] each warp's
  int* s_wi = (int*)(s_ws + RV_WARPS);           // [RV_WARPS]
  int* s_wa = s_wi + RV_WARPS;                   // [RV_WARPS]
  float* rows = (float*)(s_wa + RV_WARPS);       // [cap, WS]
  const int WS = rv_stride(R, E);
  const int iA = R, iE = R + 1, iDM = R + 1 + E, iW = iDM + 1, iMem = iW + 1,
            iV = iMem + 1;
  const float one_m_eps = (float)(1.0 - 1e-6);
  const int lo = rank * slice, hi = min(N, lo + slice);
  auto row = [&](int n) -> float* {
    return n - lo < cap ? rows + (size_t)(n - lo) * WS
                        : cache + (size_t)n * WS;
  };
  // ---- the slice: outputs initialised, rows cached ------------------------
  for (int x = rank * RV_THREADS + threadIdx.x; x < M;
       x += csize * RV_THREADS)
    moves[x] = -1;
  for (int n = lo + threadIdx.x; n < hi; n += RV_THREADS) {
    float* w = row(n);
    for (int r = 0; r < R; ++r) {
      const float f = free_in[(size_t)n * R + r];
      free_[(size_t)n * R + r] = f;
      const float a = __fadd_rn(f, releasing[(size_t)n * R + r]);
      w[r] = __fadd_rn(a, KAI_EPS);
      if (r == 0) w[iA] = a;
    }
    for (int x = 0; x < E; ++x) {
      const float f = ext_in[(size_t)n * E + x];
      ext[(size_t)n * E + x] = f;
      w[iE + x] = __fadd_rn(__fadd_rn(f, ext_releasing[(size_t)n * E + x]),
                            KAI_EPS);
    }
    float dmax = -INFINITY, whole = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float f = dev_in[(size_t)n * D + d];
      dev[(size_t)n * D + d] = f;
      const float da = __fadd_rn(f, dev_releasing[(size_t)n * D + d]);
      dmax = fmaxf(dmax, da);
      whole = __fadd_rn(whole, da >= one_m_eps ? 1.0f : 0.0f);
    }
    w[iDM] = dmax;
    w[iW] = __fadd_rn(whole, KAI_EPS);
    w[iMem] = dev_mem[n];
    w[iV] = valid[n] ? 1.0f : 0.0f;
  }
  __syncthreads();
  const int n_vic = *n_vic_p;
  const int loops = n_vic < K ? n_vic : K;
  bool ok = n_vic <= K;
  for (int kk = 0; kk < loops; ++kk) {
    const int m = idxs[kk];
    const bool is_frac = device[m] >= 0;
    const float mem = accel_mem[m], hm = held[m];
    const float* rq = req + (size_t)m * R;
    const float* xq = extended + (size_t)m * E;
    const u8* fm = fmask + (size_t)filter_class[m] * N;
    // ---- 1. fit + score over the slice, thread-local best ---------------
    float best = -INFINITY;
    int best_i = INT_MAX, any = 0;
    for (int n = lo + threadIdx.x; n < hi; n += RV_THREADS) {
      const float* w = row(n);
      bool fit = w[iV] != 0.0f && fm[n];
      for (int r = 0; r < R; ++r) fit = fit && (w[r] >= rq[r]);
      for (int x = 0; x < E; ++x) fit = fit && (w[iE + x] >= xq[x]);
      const float p_n =
          mem > 0.0f ? __fdiv_rn(mem, fmaxf(w[iMem], KAI_EPS)) : hm;
      fit = fit && (is_frac ? w[iDM] >= __fsub_rn(p_n, KAI_EPS)
                            : w[iW] >= rq[0]);
      const float score = fit ? -w[iA] : -INFINITY;
      any |= fit ? 1 : 0;
      if (kai_better(score, n, best, best_i)) {
        best = score;
        best_i = n;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_down_sync(0xffffffffu, best, o);
      const int i2 = __shfl_down_sync(0xffffffffu, best_i, o);
      if (kai_better(s2, i2, best, best_i)) {
        best = s2;
        best_i = i2;
      }
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) {
      s_ws[warp] = best;
      s_wi[warp] = best_i;
      s_wa[warp] = any;
    }
    __syncthreads();
    // ---- 2. the block's best to its slot; every block's warp 0 reduces
    // the slots of the cluster ---------------------------------------------
    const int par = kk & 1;
    if (warp == 0) {
      float b = lane < RV_WARPS ? s_ws[lane] : -INFINITY;
      int bi = lane < RV_WARPS ? s_wi[lane] : INT_MAX;
      const int a = __any_sync(0xffffffffu, lane < RV_WARPS && s_wa[lane]);
      for (int o = 16; o > 0; o >>= 1) {
        const float s2 = __shfl_down_sync(0xffffffffu, b, o);
        const int i2 = __shfl_down_sync(0xffffffffu, bi, o);
        if (kai_better(s2, i2, b, bi)) {
          b = s2;
          bi = i2;
        }
      }
      if (lane == 0) {
        s_score[par] = b;
        s_idx[par] = bi;
        s_any[par] = a;
      }
    }
    cluster.sync();
    if (warp == 0) {
      float b = -INFINITY;
      int bi = INT_MAX, a = 0;
      if (lane < csize) {
        b = cluster.map_shared_rank(s_score, lane)[par];
        bi = cluster.map_shared_rank(s_idx, lane)[par];
        a = cluster.map_shared_rank(s_any, lane)[par];
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float s2 = __shfl_down_sync(0xffffffffu, b, o);
        const int i2 = __shfl_down_sync(0xffffffffu, bi, o);
        if (kai_better(s2, i2, b, bi)) {
          b = s2;
          bi = i2;
        }
      }
      const int node = __shfl_sync(0xffffffffu, bi < N ? bi : 0, 0);
      const bool placed = __any_sync(0xffffffffu, a);
      if (rank == 0 && lane == 0) {
        moves[m] = placed ? node : -1;
        ok = ok && placed;
      }
      // ---- 3. the owning block's warp 0 debits the node ----------------
      if (placed && node >= lo && node < hi) {
        float* w = row(node);
        const float p =
            mem > 0.0f ? __fdiv_rn(mem, fmaxf(w[iMem], KAI_EPS)) : hm;
        for (int r = lane; r < R; r += 32) {
          const float dl = r == 0 ? (is_frac ? p : rq[0]) : rq[r];
          const float f = __fadd_rn(free_[(size_t)node * R + r], -dl);
          free_[(size_t)node * R + r] = f;
          const float av = __fadd_rn(f, releasing[(size_t)node * R + r]);
          w[r] = __fadd_rn(av, KAI_EPS);
          if (r == 0) w[iA] = av;
        }
        for (int x = lane; x < E; x += 32) {
          const float f = __fadd_rn(ext[(size_t)node * E + x], -xq[x]);
          ext[(size_t)node * E + x] = f;
          w[iE + x] = __fadd_rn(
              __fadd_rn(f, ext_releasing[(size_t)node * E + x]), KAI_EPS);
        }
        float* dv = dev + (size_t)node * D;
        const float* dr = dev_releasing + (size_t)node * D;
        // the device row as the fit test saw it: the fraction's device is
        // its first maximum
        float fb = -INFINITY;
        int fd = INT_MAX;
        for (int d = lane; d < D; d += 32) {
          const float da = __fadd_rn(dv[d], dr[d]);
          if (kai_better(da, d, fb, fd)) {
            fb = da;
            fd = d;
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
          const float s2 = __shfl_xor_sync(0xffffffffu, fb, o);
          const int i2 = __shfl_xor_sync(0xffffffffu, fd, o);
          if (kai_better(s2, i2, fb, fd)) {
            fb = s2;
            fd = i2;
          }
        }
        const int k = (int)rintf(rq[0]);
        int taken = 0, nwhole = 0;
        float dmax = -INFINITY;
        for (int d0 = 0; d0 < D; d0 += 32) {
          const int d = d0 + lane;
          const float da = d < D ? __fadd_rn(dv[d], dr[d]) : 0.0f;
          const bool fully = d < D && da >= one_m_eps;
          const unsigned bal = __ballot_sync(0xffffffffu, fully);
          const int upto = taken + __popc(bal & (0xffffffffu >> (31 - lane)));
          taken += __popc(bal);
          if (d < D) {
            const float dd = is_frac ? __fmul_rn(p, d == fd ? 1.0f : 0.0f)
                                     : (fully && upto <= k ? 1.0f : 0.0f);
            const float nd = __fadd_rn(dv[d], -dd);
            dv[d] = nd;
            const float na = __fadd_rn(nd, dr[d]);
            dmax = fmaxf(dmax, na);
            nwhole += na >= one_m_eps ? 1 : 0;
          }
        }
        for (int o = 16; o > 0; o >>= 1)
          dmax = fmaxf(dmax, __shfl_xor_sync(0xffffffffu, dmax, o));
        nwhole = __reduce_add_sync(0xffffffffu, nwhole);
        if (lane == 0) {
          w[iDM] = dmax;
          w[iW] = __fadd_rn((float)nwhole, KAI_EPS);
        }
      }
    }
    __syncthreads();
  }
  if (rank == 0 && threadIdx.x == 0) *all_ok = ok ? 1 : 0;
  // no block leaves while another may still read its slots
  cluster.sync();
}

// The cluster width this card takes (16 blocks where a cluster that wide
// fits, else the portable 8), found once; 0 when neither launches.
static int rv_cluster_size() {
  static int size = -1;
  if (size >= 0) return size;
  size = 0;
  if (cudaFuncSetAttribute(replace_victims_kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(replace_victims_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           RV_SMEM + 1024) != cudaSuccess) {
    cudaGetLastError();
    return size;
  }
  const int sizes[2] = {16, 8};
  for (int cs : sizes) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(RV_THREADS);
    cfg.dynamicSmemBytes = RV_SMEM + 1024;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, replace_victims_kernel, &cfg) ==
            cudaSuccess &&
        n > 0) {
      size = cs;
      break;
    }
    cudaGetLastError();
  }
  return size;
}

// `free_in`, `dev_in`, `ext_in` are the pools; `free_`, `dev`, `ext`,
// `moves` and `all_ok` are written in full; `cache` is a scratch of N rows
// of rv_stride(R, E) floats (the rows past a block's shared memory).
KAI_EXPORT int kai_replace_victims(
    const int* idxs, const int* n_vic, int K, const float* req,
    const int* device, const float* accel_mem, const float* held,
    const int* filter_class, const float* extended, const float* dev_mem,
    const u8* valid, const u8* fmask, const float* releasing,
    const float* dev_releasing, const float* ext_releasing,
    const float* free_in, const float* dev_in, const float* ext_in, int N,
    int M, int R, int D, int E, float* free_, float* dev, float* ext,
    int* moves, u8* all_ok, float* cache, cudaStream_t stream) {
  if (K < 1 || N < 1 || M < 1 || R < 1 || D < 0 || E < 0 || !cache)
    return KAI_ERR_ARGS;
  const int cs = rv_cluster_size();
  if (!cs) return static_cast<int>(cudaErrorNotSupported);
  const int WS = rv_stride(R, E);
  const int slice = (N + cs - 1) / cs;
  const size_t head = RV_HEAD;
  const int cap =
      std::min(slice, (int)((RV_SMEM - head) / (WS * sizeof(float))));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(RV_THREADS);
  cfg.dynamicSmemBytes = head + (size_t)cap * WS * sizeof(float);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, replace_victims_kernel, idxs, n_vic, K, req, device, accel_mem,
      held, filter_class, extended, dev_mem, valid, fmask, releasing,
      dev_releasing, ext_releasing, free_in, dev_in, ext_in, N, M, R, D, E,
      slice, cap, free_, dev, ext, moves, all_ok, cache);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
