// K6 freed_by_mask — resources released by evicting a masked set of
// running pods, per node, per device, per extended scalar and per queue.
//
// Replaces kai_scheduler_tpu/ops/victims.py:143 `freed_by_mask`: five
// segment sums over the running-pod axis (node [N, R], device [N, D] as a
// fractional-share sum plus a whole-device bit sum, extended [N, E], leaf
// queue [Q, R] and its non-preemptible part) and the roll-up of the two
// queue tables through the ancestor chain, einsum("qa,qr->ar").
//
// The reference's segment sums add in ascending pod order from +0.0
// (XLA's scatter), and its einsum adds in ascending q.  The wrapper hands
// in two CSR lists of the running pods, stable in pod index: by
// max(node, 0) and by max(queue, 0) (the reference's own segment of a
// masked pod: a masked pod with node or queue -1 sums into node or queue
// 0).  They depend only on the snapshot and are built once per action.
// An unmasked pod adds nothing, and the snapshotter's padding rows (node
// and queue -1, thousands on an incremental snapshot) all sit in node 0's
// and queue 0's lists, so the design makes the adds follow the masked
// pods and keeps the walk over the lists cheap and parallel:
//   - node warps, one warp per node: the warp reads its node's list 256
//     entries at a time (8 a lane, coalesced, every load started before
//     the mask gathers), finds the masked ones with a ballot and broadcasts
//     them in list order; lane c owns output column c (the R resources,
//     then the D devices, then the E extended scalars) and adds the
//     pod's value in that order.  Only the masked pods reach the adds;
//     node 0's padding costs 1/256 of a list read per entry.  The device
//     columns keep the fractional share and the whole-device bits apart
//     and add them at the end, as the reference adds its two tables.
//   - queue slices (blockIdx < Q * S, so they start first): each leaf
//     queue's list is cut into S slices, one block each (the wrapper
//     picks S so that a slice holds about a tile, 2,048 entries, of the
//     longest list).  A block sums its slice's masked requests (all, and
//     the non-preemptible ones) as a tree, with the sum of their
//     magnitudes and whether all are whole numbers.  The queue's last
//     block to finish (a per-queue counter) adds the slices' sums in
//     slice order while every slice so far is whole and the running
//     magnitude stays below 2^24: then every partial sum of any subset is
//     an integer below 2^24, exactly representable in f32, so every order
//     of addition gives the bits of the ascending one (and never -0.0: a
//     sum from +0.0 is -0.0 only if every summand is -0.0, and +0.0 +
//     -0.0 is +0.0 in round-to-nearest; a computed sum of whole
//     non-negative numbers reaches 2^24 exactly when the true sum does).
//     From the first slice that fails the test, that block adds the rest
//     of the queue's pods serially in ascending list order, from the
//     exact sum so far.  The non-preemptible part is a subset of the
//     masked pods, so the same test covers it.
//   - the roll-up: the last queue to finish (a second counter; the
//     wrapper's launch zeroes both) rolls the leaf tables up the chain,
//     one thread per (kind, ancestor, resource), acc + chain[q, a] *
//     leaf[q, r] over q ascending.
//   - queues_only (reclaim's `freeable`, which reads only the rolled-up
//     queue table): the grid is the queue slices; the node, device and
//     extended tables are neither computed nor written.
// A pod's device index is < D (the snapshot builder's invariant).
//
// Bound: bytes — the mask once, the masked pods' rows once (requests,
// device, share, device bits, preemptible, node, queue, extended) and the
// outputs written once (chip_smoke.py computes it from each captured
// call).  resident_churn (M = 55,968 pods with the snapshotter's padding,
// N = 11,256, Q = 8, R = 3, D = 8, E = 1): reclaim's queue-only call with
// 49,255 masked pods reads ~0.89 MB, ~0.00027 ms at 3.35 TB/s; its stale
// call (no pod masked) ~0.00018 ms, nearly all the output tables.
// saturated_sequential's attempt (a scenario's few victims): ~0.00055 ms.
// The kernel is latency-bound: a node warp costs two dependent L2 round
// trips per 256 list entries, a queue slice three per 2,048, and the
// queue's last slice and the roll-up a few more.
//
// Build (ptxas -v, sm_90a): 40 registers, 2,308 bytes of shared memory,
// 0 bytes of stack frame, spill stores or spill loads (its per-lane arrays
// are indexed by unrolled constants).
#include "kai_common.cuh"

#define FM_THREADS 512
#define FM_WARPS (FM_THREADS / 32)
#define FM_NU 8                      // node list entries per lane a step
#define FM_U 4                       // queue list entries per lane a step
#define FM_TILE (FM_THREADS * FM_U)  // queue tile
#define FM_MAXR 12
#define FM_EXACT_LIMIT 16777216.0f   // 2^24

// one masked pod's value in output column c of a node: resources, then
// devices (fractional share into acc, whole-device bits into whole), then
// extended scalars
__device__ __forceinline__ void fm_node_add(
    int m, int c, int R, int D, int E, const float* __restrict__ req,
    const int* __restrict__ device, const float* __restrict__ held,
    const int* __restrict__ devices_mask, const float* __restrict__ extended,
    float& acc, float& whole) {
  if (c < R) {
    acc = __fadd_rn(acc, req[(size_t)m * R + c]);
  } else if (c < R + D) {
    const int d = c - R, dv = device[m];
    if (dv >= 0) {
      if (dv == d) acc = __fadd_rn(acc, held[m]);
    } else {
      whole = __fadd_rn(whole, (float)((devices_mask[m] >> d) & 1));
    }
  } else if (c < R + D + E) {
    acc = __fadd_rn(acc, extended[(size_t)m * E + (c - R - D)]);
  }
}

__global__ void __launch_bounds__(FM_THREADS) freed_by_mask_kernel(
    const u8* __restrict__ mask, const float* __restrict__ req,
    const int* __restrict__ device, const float* __restrict__ held,
    const int* __restrict__ devices_mask, const u8* __restrict__ preemptible,
    const float* __restrict__ extended, const int* __restrict__ node_off,
    const int* __restrict__ node_pods, const int* __restrict__ queue_off,
    const int* __restrict__ queue_pods, const u8* __restrict__ chain, int N,
    int R, int D, int Q, int E, int S, float* __restrict__ part,
    float* __restrict__ leaf, int* __restrict__ done,
    float* __restrict__ freed_n, float* __restrict__ freed_d,
    float* __restrict__ freed_e, float* __restrict__ freed_q,
    float* __restrict__ freed_q_np) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.x >= Q * S) {
    // ---- node warps ------------------------------------------------------
    const int n = (blockIdx.x - Q * S) * FM_WARPS + warp;
    if (n >= N) return;
    const int b = node_off[n], e_ = node_off[n + 1];
    const int C = R + D + E;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      float acc = 0.0f, whole = 0.0f;
      for (int k0 = b; k0 < e_; k0 += 32 * FM_NU) {
        int m[FM_NU];
        bool on[FM_NU];
#pragma unroll
        for (int u = 0; u < FM_NU; ++u) {
          const int k = k0 + u * 32 + lane;
          m[u] = k < e_ ? node_pods[k] : -1;
        }
#pragma unroll
        for (int u = 0; u < FM_NU; ++u) on[u] = m[u] >= 0 && mask[m[u]];
#pragma unroll
        for (int u = 0; u < FM_NU; ++u) {
          unsigned bal = __ballot_sync(0xffffffffu, on[u]);
          while (bal) {  // warp-uniform: the masked pods in list order
            const int j = __ffs(bal) - 1;
            bal &= bal - 1;
            const int mm = __shfl_sync(0xffffffffu, m[u], j);
            fm_node_add(mm, c, R, D, E, req, device, held, devices_mask,
                        extended, acc, whole);
          }
        }
      }
      if (c < R) {
        freed_n[(size_t)n * R + c] = acc;
      } else if (c < R + D) {
        freed_d[(size_t)n * D + (c - R)] = __fadd_rn(acc, whole);
      } else if (c < C) {
        freed_e[(size_t)n * E + (c - R - D)] = acc;
      }
    }
    return;
  }

  // ---- queue slices ------------------------------------------------------
  __shared__ float s_red[FM_WARPS][3 * FM_MAXR];
  __shared__ int s_last;
  const int q = blockIdx.x / S, slice = blockIdx.x % S;
  const int qb = queue_off[q], qe = queue_off[q + 1];
  const int per = (qe - qb + S - 1) / S;
  const int b = min(qe, qb + slice * per), e_ = min(qe, b + per);
  // slice record: [2R sums (all, non-preemptible), R magnitudes, whole]
  const int rec = 3 * R + 1;
  float* my = part + ((size_t)q * S + slice) * rec;
  const int j = tid, r_j = j % R;
  float acc = 0.0f, mag = 0.0f;
  bool all_whole = true;
  for (int t0 = b; t0 < e_; t0 += FM_TILE) {
    int m[FM_U];
    bool on[FM_U], np[FM_U];
#pragma unroll
    for (int u = 0; u < FM_U; ++u) {
      const int k = t0 + u * FM_THREADS + tid;
      m[u] = k < e_ ? queue_pods[k] : -1;
    }
#pragma unroll
    for (int u = 0; u < FM_U; ++u) {
      on[u] = m[u] >= 0 && mask[m[u]];
      np[u] = on[u] && !preemptible[m[u]];
    }
    // this thread's part of the tile's sums, per resource: all masked,
    // non-preemptible, magnitudes; and whether every summand is whole
    bool whole = true;
    for (int r = 0; r < R; ++r) {
      float sa = 0.0f, sn = 0.0f, sm = 0.0f;
#pragma unroll
      for (int u = 0; u < FM_U; ++u) {
        if (!on[u]) continue;
        const float v = req[(size_t)m[u] * R + r];
        whole = whole && v == truncf(v);
        sa = __fadd_rn(sa, v);
        sm = __fadd_rn(sm, fabsf(v));
        if (np[u]) sn = __fadd_rn(sn, v);
      }
      for (int off = 16; off > 0; off >>= 1) {
        sa = __fadd_rn(sa, __shfl_down_sync(0xffffffffu, sa, off));
        sn = __fadd_rn(sn, __shfl_down_sync(0xffffffffu, sn, off));
        sm = __fadd_rn(sm, __shfl_down_sync(0xffffffffu, sm, off));
      }
      if (lane == 0) {
        s_red[warp][r] = sa;
        s_red[warp][R + r] = sn;
        s_red[warp][2 * R + r] = sm;
      }
    }
    all_whole = __syncthreads_and(whole) && all_whole;
    if (j < 2 * R) {
      for (int w = 0; w < FM_WARPS; ++w) {
        acc = __fadd_rn(acc, s_red[w][j]);
        mag = __fadd_rn(mag, s_red[w][2 * R + r_j]);
      }
    }
    __syncthreads();
  }
  if (j < 2 * R) my[j] = acc;
  if (j < R) my[2 * R + j] = mag;
  if (j == 0) my[3 * R] = all_whole ? 1.0f : 0.0f;

  // ---- the queue's last slice: its sums, in order -----------------------
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done + 1 + q, 1) == S - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (j < 2 * R) {
    const float* qp = part + (size_t)q * S * rec;
    float sum = 0.0f, total = 0.0f;
    int sl = 0;
    for (; sl < S; ++sl) {
      const float* pr = qp + (size_t)sl * rec;
      const float pm = __ldcg(pr + 2 * R + r_j);
      if (__ldcg(pr + 3 * R) == 0.0f ||
          !(__fadd_rn(total, pm) < FM_EXACT_LIMIT))
        break;
      total = __fadd_rn(total, pm);
      sum = __fadd_rn(sum, __ldcg(pr + j));
    }
    if (sl < S) {
      // a fractional summand or a large total: from this slice on, the
      // queue's pods in ascending list order, serially
      const bool np_kind = j >= R;
      for (int k = min(qe, qb + sl * per); k < qe; ++k) {
        const int mm = queue_pods[k];
        if (!mask[mm] || (np_kind && preemptible[mm])) continue;
        sum = __fadd_rn(sum, req[(size_t)mm * R + r_j]);
      }
    }
    leaf[(size_t)(j / R) * Q * R + (size_t)q * R + r_j] = sum;
  }

  // ---- the roll-up, by the last queue to finish -------------------------
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(done, 1) == Q - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int t = tid; t < 2 * Q * R; t += FM_THREADS) {
    const int kind = t / (Q * R);
    const int a = (t / R) % Q, r = t % R;
    const float* src = leaf + (size_t)kind * Q * R;
    float ra = 0.0f;
    for (int qq = 0; qq < Q; ++qq) {
      const float c = chain[(size_t)qq * Q + a] ? 1.0f : 0.0f;
      ra = __fadd_rn(ra, __fmul_rn(c, __ldcg(src + (size_t)qq * R + r)));
    }
    (kind == 0 ? freed_q : freed_q_np)[(size_t)a * R + r] = ra;
  }
}

KAI_EXPORT int kai_freed_by_mask(
    const u8* mask, const float* req, const int* device, const float* held,
    const int* devices_mask, const u8* preemptible, const float* extended,
    const int* node_off, const int* node_pods, const int* queue_off,
    const int* queue_pods, const u8* chain, int N, int R, int D, int Q, int E,
    int S, int queues_only, float* part, float* leaf, int* done,
    float* freed_n, float* freed_d, float* freed_q, float* freed_q_np,
    float* freed_e, cudaStream_t stream) {
  if (N < 1 || R < 1 || R > FM_MAXR || D < 0 || Q < 1 || E < 0 || S < 1 ||
      !part || !leaf || !done || !freed_q || !freed_q_np ||
      (!queues_only && (!freed_n || (D && !freed_d) || (E && !freed_e))))
    return KAI_ERR_ARGS;
  cudaError_t err =
      cudaMemsetAsync(done, 0, (size_t)(Q + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      (long long)Q * S + (queues_only ? 0 : (N + FM_WARPS - 1) / FM_WARPS);
  if (blocks > INT_MAX) return KAI_ERR_ARGS;
  freed_by_mask_kernel<<<(int)blocks, FM_THREADS, 0, stream>>>(
      mask, req, device, held, devices_mask, preemptible, extended, node_off,
      node_pods, queue_off, queue_pods, chain, N, R, D, Q, E, S, part, leaf,
      done, freed_n, freed_d, freed_e, freed_q, freed_q_np);
  return static_cast<int>(cudaGetLastError());
}
