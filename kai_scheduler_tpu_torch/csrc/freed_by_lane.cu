// K8 freed_by_lane — what each wavefront lane's victims release, per node
// and per queue, from a pod-to-lane assignment.
//
// Replaces kai_scheduler_tpu/ops/victims.py:738 `_freed_by_lane` (the
// chunked victim wavefront calls it once per chunk): two segment sums over
// the running-pod axis keyed by (lane, node) and (lane, leaf queue), the
// optional lane-prefix (`compose`: lane b's pool is the union of lanes
// <= b, a jnp.cumsum over the lane axis), the roll-up of the queue sums
// through the ancestor chain, einsum("qa,bqr->bar"), and
// own_incr = sum_r own_n > EPS.  With `freed_d` (the placement config
// tracks devices: per-task snapshots with fractional or whole-device
// pods) the device table [B, N, D] too: the reference's two segment sums
// (:776-791), the fractional pods' accel_held at (lane, node, device), then
// plus one per devices_mask bit of the whole-device pods at (lane, node),
// lane-prefix composed as the node table is.  With `freed_e` (the placement
// config's extended mode: MIG slices) the extended table [B, N, E] too
// (:800-805): each live pod's extended row summed at (lane, node), composed
// likewise.
//
// A pod belongs to at most one lane, so the sums can run in the
// reference's order (ascending pod index from +0.0, XLA's scatter) with no
// atomics, over K6's CSR pod lists (by max(node, 0) and by max(queue, 0),
// stable in pod index, built once per action):
//   - node blocks: one thread per node walks its pods in order and adds
//     each live pod's request into own_n[lane, node] (the output buffer,
//     zeroed first); then own_incr over the lanes; with the device table,
//     a second walk adds each live fractional pod's share into
//     own_d[lane, node, device] and a third, at each lane's first
//     whole-device pod, counts that lane's bits per device over the node's
//     list and adds the count (a sum of ones: exact, so the reference's
//     per_d + per_w is per_d + count); with the extended table, a walk
//     that adds each live pod's E keys into own_e[lane, node, :]; then,
//     with compose, the lane prefix of each of its 3 (+ D) (+ E) columns in
//     place;
//   - queue blocks, one per leaf queue: the queue's pods in chunks of
//     FL_CHUNK staged in shared memory (lane id, request), then one thread
//     per (lane, resource) adds the chunk's matching pods in order into the
//     [B, Q, R] scratch; then, with compose, the lane prefix per resource;
//   - a second grid rolls the leaf sums up the chain, one thread per
//     (lane, ancestor, resource), over q ascending (a chain entry of 0
//     adds +0.0 in the reference, which leaves the sum unchanged, so it is
//     skipped).
// The lane prefix is jnp.cumsum's order on the CPU: XLA rewrites it into
// blocks of 16 summed left to right from +0.0, scans the block totals the
// same way and adds each block's exclusive prefix (numerics.cumsum_blocked);
// lanes are limited to FL_MAX_LANES (two levels of totals).
// Bound: bytes — the live pods' rows once, the [B, N, R], [B, N, D],
// [B, N, E] and [B, Q, R] outputs written (and, with compose, read and
// written again).
#include "kai_common.cuh"

#define FL_THREADS 256
#define FL_CHUNK 512
#define FL_MAX_LANES 4096
#define FL_MAX_D 32
#define FL_MAX_E 8

// jnp.cumsum order of n <= 256 floats in a local array, in place
__device__ void fl_scan_local(float* t, int n) {
  float tot[16];
  const int nb = (n + 15) / 16;
  for (int k = 0; k < nb; ++k) {
    float acc = 0.0f;
    const int e = min(n, 16 * k + 16);
    for (int i = 16 * k; i < e; ++i) {
      acc = __fadd_rn(acc, t[i]);
      t[i] = acc;
    }
    tot[k] = e < 16 * k + 16 ? __fadd_rn(acc, 0.0f) : acc;  // zero padding
  }
  if (nb <= 1) return;
  float run = 0.0f;
  for (int k = 0; k < nb; ++k) {  // nb <= 16: the totals' scan is one block
    const float excl = run;
    run = __fadd_rn(run, tot[k]);
    const int e = min(n, 16 * k + 16);
    for (int i = 16 * k; i < e; ++i) t[i] = __fadd_rn(t[i], excl);
  }
}

// jnp.cumsum order of n <= FL_MAX_LANES floats at x[i * stride], in place
__device__ void fl_scan_blocked(float* x, int n, size_t stride) {
  float tot[FL_MAX_LANES / 16];
  const int nb = (n + 15) / 16;
  for (int k = 0; k < nb; ++k) {
    float acc = 0.0f;
    const int e = min(n, 16 * k + 16);
    for (int i = 16 * k; i < e; ++i) {
      acc = __fadd_rn(acc, x[i * stride]);
      x[i * stride] = acc;
    }
    tot[k] = e < 16 * k + 16 ? __fadd_rn(acc, 0.0f) : acc;
  }
  if (nb <= 1) return;
  fl_scan_local(tot, nb);
  for (int k = 0; k < nb; ++k) {
    const float excl = k ? tot[k - 1] : 0.0f;
    const int e = min(n, 16 * k + 16);
    for (int i = 16 * k; i < e; ++i)
      x[i * stride] = __fadd_rn(x[i * stride], excl);
  }
}

__global__ void __launch_bounds__(FL_THREADS) freed_by_lane_kernel(
    const int* __restrict__ lane, const float* __restrict__ req,
    const int* __restrict__ node_off, const int* __restrict__ node_pods,
    const int* __restrict__ queue_off, const int* __restrict__ queue_pods,
    const int* __restrict__ device, const float* __restrict__ held,
    const int* __restrict__ devices_mask, const float* __restrict__ ext,
    int N, int Q, int B, int D, int E, int compose, float* __restrict__ leaf,
    float* __restrict__ freed_n, u8* __restrict__ own_incr,
    float* __restrict__ freed_d, float* __restrict__ freed_e) {
  const int node_blocks = (N + FL_THREADS - 1) / FL_THREADS;
  const size_t lane_stride_n = (size_t)N * 3;
  if ((int)blockIdx.x < node_blocks) {
    const int n = blockIdx.x * FL_THREADS + threadIdx.x;
    if (n >= N) return;
    for (int k = node_off[n]; k < node_off[n + 1]; ++k) {
      const int m = node_pods[k];
      const int l = lane[m];
      if (l < 0 || l >= B) continue;
      float* o = freed_n + (size_t)l * lane_stride_n + (size_t)n * 3;
      for (int r = 0; r < 3; ++r)
        o[r] = __fadd_rn(o[r], req[(size_t)m * 3 + r]);
    }
    for (int b = 0; b < B; ++b) {
      const float* o = freed_n + (size_t)b * lane_stride_n + (size_t)n * 3;
      own_incr[(size_t)b * N + n] =
          __fadd_rn(__fadd_rn(o[0], o[1]), o[2]) > KAI_EPS ? 1 : 0;
    }
    if (compose)
      for (int r = 0; r < 3; ++r)
        fl_scan_blocked(freed_n + (size_t)n * 3 + r, B, lane_stride_n);
    if (freed_e) {
      // the extended keys, in ascending pod order per cell
      const size_t lane_stride_e = (size_t)N * E;
      float* own_e = freed_e + (size_t)n * E;
      for (int k = node_off[n]; k < node_off[n + 1]; ++k) {
        const int m = node_pods[k];
        const int l = lane[m];
        if (l < 0 || l >= B) continue;
        float* o = own_e + (size_t)l * lane_stride_e;
        for (int e = 0; e < E; ++e)
          o[e] = __fadd_rn(o[e], ext[(size_t)m * E + e]);
      }
      if (compose)
        for (int e = 0; e < E; ++e)
          fl_scan_blocked(own_e + e, B, lane_stride_e);
    }
    if (!freed_d) return;
    const size_t lane_stride_d = (size_t)N * D;
    float* own_d = freed_d + (size_t)n * D;
    const int k0 = node_off[n], k1 = node_off[n + 1];
    // the fractional shares, in ascending pod order per cell
    for (int k = k0; k < k1; ++k) {
      const int m = node_pods[k];
      const int l = lane[m], dv = device[m];
      if (l < 0 || l >= B || dv < 0 || dv >= D) continue;
      float* o = own_d + (size_t)l * lane_stride_d + dv;
      *o = __fadd_rn(*o, held[m]);
    }
    // the whole-device pods' bits: a count per (lane, device), added once
    // at the lane's first whole-device pod on this node
    for (int k = k0; k < k1; ++k) {
      const int m = node_pods[k];
      const int l = lane[m];
      if (l < 0 || l >= B || device[m] >= 0) continue;
      bool first = true;
      for (int j = k0; j < k && first; ++j)
        first = !(lane[node_pods[j]] == l && device[node_pods[j]] < 0);
      if (!first) continue;
      float* o = own_d + (size_t)l * lane_stride_d;
      for (int d = 0; d < D; ++d) {
        int cnt = 0;
        for (int j = k; j < k1; ++j) {
          const int m2 = node_pods[j];
          cnt += lane[m2] == l && device[m2] < 0 &&
                 ((devices_mask[m2] >> d) & 1);
        }
        if (cnt) o[d] = __fadd_rn(o[d], (float)cnt);
      }
    }
    if (compose)
      for (int d = 0; d < D; ++d)
        fl_scan_blocked(own_d + d, B, lane_stride_d);
    return;
  }
  // ---- one block per leaf queue -------------------------------------------
  __shared__ int s_lane[FL_CHUNK];
  __shared__ float s_req[FL_CHUNK * 3];
  const int q = blockIdx.x - node_blocks;
  const int b0 = queue_off[q], e0 = queue_off[q + 1];
  const size_t lane_stride_q = (size_t)Q * 3;
  for (int c0 = b0; c0 < e0; c0 += FL_CHUNK) {
    const int len = min(FL_CHUNK, e0 - c0);
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      const int m = queue_pods[c0 + t];
      const int l = lane[m];
      s_lane[t] = (l >= 0 && l < B) ? l : -1;
      for (int r = 0; r < 3; ++r) s_req[t * 3 + r] = req[(size_t)m * 3 + r];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < B * 3; j += blockDim.x) {
      const int l = j / 3, r = j % 3;
      float* dst = leaf + (size_t)l * lane_stride_q + (size_t)q * 3 + r;
      float acc = *dst;
      for (int t = 0; t < len; ++t)
        if (s_lane[t] == l) acc = __fadd_rn(acc, s_req[t * 3 + r]);
      *dst = acc;
    }
    __syncthreads();
  }
  if (compose && threadIdx.x < 3)
    fl_scan_blocked(leaf + (size_t)q * 3 + threadIdx.x, B, lane_stride_q);
}

__global__ void freed_by_lane_rollup_kernel(const float* __restrict__ leaf,
                                            const u8* __restrict__ chain,
                                            int Q, int B,
                                            float* __restrict__ freed_q) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)B * Q * 3) return;
  const int r = t % 3;
  const int a = (t / 3) % Q;
  const size_t b = t / ((size_t)Q * 3);
  const float* src = leaf + b * Q * 3 + r;
  float acc = 0.0f;
  for (int q = 0; q < Q; ++q)
    if (chain[(size_t)q * Q + a]) acc = __fadd_rn(acc, src[(size_t)q * 3]);
  freed_q[t] = acc;
}

// `leaf` is a [B, Q, 3] scratch; every output is written in full.  A null
// `freed_d` builds no device table (`device`, `held`, `devices_mask` may
// then be null too); a null `freed_e` no extended table (`ext` may then be
// null).
KAI_EXPORT int kai_freed_by_lane(
    const int* lane, const float* req, const int* node_off,
    const int* node_pods, const int* queue_off, const int* queue_pods,
    const u8* chain, const int* device, const float* held,
    const int* devices_mask, const float* ext, int N, int R, int Q, int B,
    int D, int E, int compose, float* leaf, float* freed_n, float* freed_q,
    u8* own_incr, float* freed_d, float* freed_e, cudaStream_t stream) {
  if (N < 1 || R != 3 || Q < 1 || B < 1 || B > FL_MAX_LANES)
    return KAI_ERR_ARGS;
  if (freed_d && (D < 1 || D > FL_MAX_D || !device || !held || !devices_mask))
    return KAI_ERR_ARGS;
  if (freed_e && (E < 1 || E > FL_MAX_E || !ext)) return KAI_ERR_ARGS;
  cudaError_t e = cudaMemsetAsync(freed_n, 0, (size_t)B * N * 3 * sizeof(float),
                                  stream);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(leaf, 0, (size_t)B * Q * 3 * sizeof(float), stream);
  if (e == cudaSuccess && freed_d)
    e = cudaMemsetAsync(freed_d, 0, (size_t)B * N * D * sizeof(float), stream);
  if (e == cudaSuccess && freed_e)
    e = cudaMemsetAsync(freed_e, 0, (size_t)B * N * E * sizeof(float), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (N + FL_THREADS - 1) / FL_THREADS + Q;
  freed_by_lane_kernel<<<blocks, FL_THREADS, 0, stream>>>(
      lane, req, node_off, node_pods, queue_off, queue_pods, device, held,
      devices_mask, ext, N, Q, B, freed_d ? D : 0, freed_e ? E : 0, compose,
      leaf, freed_n, own_incr, freed_d, freed_e);
  const size_t total = (size_t)B * Q * 3;
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  freed_by_lane_rollup_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                stream>>>(leaf, chain, Q, B, freed_q);
  return static_cast<int>(cudaGetLastError());
}
