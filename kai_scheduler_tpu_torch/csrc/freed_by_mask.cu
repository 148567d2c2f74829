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
// (XLA's scatter), and its einsum adds in ascending q; f32 addition is not
// associative, so atomics would change the bits once sums carry fractions
// or pass 2^24.  Instead the wrapper hands in two CSR lists of the running
// pods, stable in pod index: by max(node, 0) and by max(queue, 0) (the
// reference's own segment of a masked pod).  They depend only on the
// snapshot and are built once per action.
//   - node blocks: one thread per node loops over its pods in order and
//     adds the masked ones (resources, then per device the fractional
//     share and the whole-device bits — kept apart and added at the end,
//     as the reference adds its two device tables — then extended);
//   - queue blocks, one per leaf queue: the queue's pods in chunks of
//     FM_CHUNK — the block loads a chunk's masked requests (all masked
//     pods, and the non-preemptible ones) into shared memory in parallel,
//     then one thread per (kind, resource) adds them in order; an
//     unmasked pod adds +0.0, which leaves a sum that starts at +0.0
//     unchanged, so the bits equal the reference's skip;
//   - a second grid of one block rolls the leaf sums up the chain, one
//     thread per (ancestor, resource): acc + chain[q, a] * leaf[q, r] over
//     q ascending.
// A pod's device index is < D (the snapshot builder's invariant).
// Bound: bytes (the masked pods' rows and the outputs, once each).
#include "kai_common.cuh"

#define FM_THREADS 256
#define FM_CHUNK 512

__global__ void freed_by_mask_kernel(
    const u8* __restrict__ mask, const float* __restrict__ req,
    const int* __restrict__ device, const float* __restrict__ held,
    const int* __restrict__ devices_mask, const u8* __restrict__ preemptible,
    const float* __restrict__ extended, const int* __restrict__ node_off,
    const int* __restrict__ node_pods, const int* __restrict__ queue_off,
    const int* __restrict__ queue_pods, int N, int R, int D, int Q, int E,
    float* __restrict__ leaf, float* __restrict__ freed_n,
    float* __restrict__ freed_d, float* __restrict__ freed_e) {
  const int node_blocks = (N + FM_THREADS - 1) / FM_THREADS;
  if ((int)blockIdx.x < node_blocks) {
    const int n = blockIdx.x * FM_THREADS + threadIdx.x;
    if (n >= N) return;
    const int b = node_off[n], e_ = node_off[n + 1];
    for (int r = 0; r < R; ++r) {
      float acc = 0.0f;
      for (int k = b; k < e_; ++k) {
        const int m = node_pods[k];
        if (mask[m]) acc = __fadd_rn(acc, req[(size_t)m * R + r]);
      }
      freed_n[(size_t)n * R + r] = acc;
    }
    for (int d = 0; d < D; ++d) {
      float frac = 0.0f, whole = 0.0f;
      for (int k = b; k < e_; ++k) {
        const int m = node_pods[k];
        if (!mask[m]) continue;
        if (device[m] >= 0) {
          if (device[m] == d) frac = __fadd_rn(frac, held[m]);
        } else {
          whole = __fadd_rn(whole, (float)((devices_mask[m] >> d) & 1));
        }
      }
      freed_d[(size_t)n * D + d] = __fadd_rn(frac, whole);
    }
    for (int x = 0; x < E; ++x) {
      float acc = 0.0f;
      for (int k = b; k < e_; ++k) {
        const int m = node_pods[k];
        if (mask[m]) acc = __fadd_rn(acc, extended[(size_t)m * E + x]);
      }
      freed_e[(size_t)n * E + x] = acc;
    }
    return;
  }
  // ---- one block per leaf queue -------------------------------------------
  extern __shared__ float fm_smem[];  // [2][FM_CHUNK][R]
  const int q = blockIdx.x - node_blocks;
  const int b = queue_off[q], e_ = queue_off[q + 1];
  const int j = threadIdx.x;  // j < 2R: (kind, resource) accumulator
  float acc = 0.0f;
  for (int c0 = b; c0 < e_; c0 += FM_CHUNK) {
    const int len = min(FM_CHUNK, e_ - c0);
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      const int m = queue_pods[c0 + t];
      const bool on = mask[m] != 0;
      const bool np = on && !preemptible[m];
      for (int r = 0; r < R; ++r) {
        const float v = req[(size_t)m * R + r];
        fm_smem[(size_t)t * R + r] = on ? v : 0.0f;
        fm_smem[(size_t)(FM_CHUNK + t) * R + r] = np ? v : 0.0f;
      }
    }
    __syncthreads();
    if (j < 2 * R) {
      const float* src = fm_smem + (size_t)(j / R) * FM_CHUNK * R + j % R;
      for (int t = 0; t < len; ++t) acc = __fadd_rn(acc, src[(size_t)t * R]);
    }
    __syncthreads();
  }
  if (j < 2 * R) leaf[(size_t)(j / R) * Q * R + (size_t)q * R + j % R] = acc;
}

__global__ void freed_rollup_kernel(const float* __restrict__ leaf,
                                    const u8* __restrict__ chain, int Q,
                                    int R, float* __restrict__ freed_q,
                                    float* __restrict__ freed_q_np) {
  for (int t = threadIdx.x; t < 2 * Q * R; t += blockDim.x) {
    const int kind = t / (Q * R);
    const int a = (t / R) % Q, r = t % R;
    const float* src = leaf + (size_t)kind * Q * R;
    float acc = 0.0f;
    for (int q = 0; q < Q; ++q) {
      const float c = chain[(size_t)q * Q + a] ? 1.0f : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(c, src[(size_t)q * R + r]));
    }
    (kind == 0 ? freed_q : freed_q_np)[(size_t)a * R + r] = acc;
  }
}

KAI_EXPORT int kai_freed_by_mask(
    const u8* mask, const float* req, const int* device, const float* held,
    const int* devices_mask, const u8* preemptible, const float* extended,
    const int* node_off, const int* node_pods, const int* queue_off,
    const int* queue_pods, const u8* chain, int N, int R, int D, int Q, int E,
    float* leaf, float* freed_n, float* freed_d, float* freed_q,
    float* freed_q_np, float* freed_e, cudaStream_t stream) {
  // the chunk's shared memory stays within the default 48 KiB
  if (N < 1 || R < 1 || R > 12 || D < 0 || Q < 1 || E < 0)
    return KAI_ERR_ARGS;
  const int blocks = (N + FM_THREADS - 1) / FM_THREADS + Q;
  const size_t smem = (size_t)2 * FM_CHUNK * R * sizeof(float);
  freed_by_mask_kernel<<<blocks, FM_THREADS, smem, stream>>>(
      mask, req, device, held, devices_mask, preemptible, extended, node_off,
      node_pods, queue_off, queue_pods, N, R, D, Q, E, leaf, freed_n, freed_d,
      freed_e);
  freed_rollup_kernel<<<1, FM_THREADS, 0, stream>>>(leaf, chain, Q, R,
                                                     freed_q, freed_q_np);
  return static_cast<int>(cudaGetLastError());
}
