// K15 repack_fill — the repack plan's destinations: canonical
// ascending-node first fit of each selected victim outside the target rack.
//
// Replaces the kernel body of kai_scheduler_tpu/ops/repack.py:106
// `plan_repack`, the `lax.scan` over the P plan slots (:224-248): for slot
// p in order, the pod `slot_pod[p]` (-1 = unused) fits node n when
//   dest_ok[n] & filter_masks[filter_class[pod], n]
//   & all_r(free_d[n, r] + EPS >= req[pod, r]),
// the slot takes the lowest such n (jnp.argmax of the fit row), and that
// node's row is debited by the pod's request before the next slot.  An
// unused slot, or a pod that fits nowhere, writes -1.
//
// One block walks the slots in order (each one depends on the debits of
// the ones before it): its threads test the nodes strided, a block-wide
// min finds the first fit, thread 0 debits the row in the working copy of
// the pool, and __syncthreads orders the slots.  Latency-bound: P
// dependent steps over N nodes.
// Bound: bytes — the pool, the two masks' rows and the slots' pods once.
#include "kai_common.cuh"

#define RP_THREADS 1024

__global__ void __launch_bounds__(RP_THREADS) repack_fill_kernel(
    const int* __restrict__ slot_pod, const float* __restrict__ req,
    const int* __restrict__ filter_class, const u8* __restrict__ dest_ok,
    const u8* __restrict__ filter_masks, const float* __restrict__ free0,
    int P, int N, int X, float* __restrict__ free_d,
    int* __restrict__ nodes_p) {
  __shared__ int s_min[RP_THREADS];
  const int t = threadIdx.x;
  for (size_t i = t; i < (size_t)N * 3; i += blockDim.x) free_d[i] = free0[i];
  __syncthreads();
  for (int p = 0; p < P; ++p) {
    const int pod = slot_pod[p];
    const int ps = pod > 0 ? pod : 0;
    const float v0 = req[(size_t)ps * 3], v1 = req[(size_t)ps * 3 + 1],
                v2 = req[(size_t)ps * 3 + 2];
    const int fc = min(max(filter_class[ps], 0), X - 1);
    const u8* fm = filter_masks + (size_t)fc * N;
    int first = INT_MAX;
    if (pod >= 0) {
      for (int n = t; n < N; n += blockDim.x) {
        const float* f = free_d + (size_t)n * 3;
        if (dest_ok[n] && fm[n] && __fadd_rn(f[0], KAI_EPS) >= v0 &&
            __fadd_rn(f[1], KAI_EPS) >= v1 &&
            __fadd_rn(f[2], KAI_EPS) >= v2) {
          first = n;
          break;  // strided ascending: the thread's first fit is its least
        }
      }
    }
    s_min[t] = first;
    __syncthreads();
    for (int h = blockDim.x >> 1; h > 0; h >>= 1) {
      if (t < h) s_min[t] = min(s_min[t], s_min[t + h]);
      __syncthreads();
    }
    const int node = s_min[0];
    if (t == 0) {
      if (node != INT_MAX) {
        float* f = free_d + (size_t)node * 3;
        f[0] = __fsub_rn(f[0], v0);
        f[1] = __fsub_rn(f[1], v1);
        f[2] = __fsub_rn(f[2], v2);
        nodes_p[p] = node;
      } else {
        nodes_p[p] = -1;
      }
    }
    __syncthreads();
  }
}

// `free_d` is an [N, 3] scratch (the working pool, copied from `free0`)
KAI_EXPORT int kai_repack_fill(const int* slot_pod, const float* req,
                               const int* filter_class, const u8* dest_ok,
                               const u8* filter_masks, const float* free0,
                               int P, int N, int X, int M, float* free_d,
                               int* nodes_p, cudaStream_t stream) {
  if (P < 1 || N < 1 || X < 1 || M < 1) return KAI_ERR_ARGS;
  repack_fill_kernel<<<1, RP_THREADS, 0, stream>>>(
      slot_pod, req, filter_class, dest_ok, filter_masks, free0, P, N, X,
      free_d, nodes_p);
  return static_cast<int>(cudaGetLastError());
}
