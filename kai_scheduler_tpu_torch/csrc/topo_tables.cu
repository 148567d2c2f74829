// K11 topo_tables — the domain tables of the uniform path's required
// topology levels.
//
// Replaces kai_scheduler_tpu/ops/allocate.py:1461 `topo_tables_build` and
// :1490 `topo_tables_update` (closures of `allocate`, run once per action
// and after every chunk's commit):
//   build:  c_y[y, n]        whole replicas of type y on node n's idle +
//                            releasing + victim-freed pool, zero where the
//                            type did not fit at the action's start (and
//                            in the junk column N);
//           dom_caps_y[y, d] the sum of c_y over domain d's nodes;
//           agg[d]           the domain's aggregate accelerator, summed in
//                            ascending node order from +0.0 (XLA:CPU's
//                            scatter-add order; the values may carry
//                            fractions).
//   update: the nodes the chunk's taken lanes placed on get their counts
//           recomputed from the committed pools; each count's change goes
//           into the caps of the node's domain at every level (integer
//           atomics: the order cannot show), and each placed replica's
//           accelerator request leaves its node's domains in entry order
//           (lane-major), per domain, as the reference's scatter adds it.
//
// Domain ids are dense below ND = N * L and each belongs to one level, so
// a domain's nodes are one CSR row (dom_ptr, dom_nodes: ascending nodes,
// built once per action from the static node -> domain table) and the
// levels' updates never touch the same id.  Entries whose node has no
// domain at a level go to the reference's junk id and change nothing.
//
// Bound: bytes — the build reads the pools, the fit table and the CSR once
// and writes the tables; the update touches at most B*T nodes, and its
// entry-order walk is (B T)^2 / 2 integer compares at most.
#include "kai_common.cuh"

#define TT_THREADS 256

// whole replicas of req fitting in avail (ref _replica_count, unmasked)
__device__ __forceinline__ int tt_replicas(const float* avail,
                                           const float* req) {
  float m = INFINITY;
  for (int r = 0; r < 3; ++r) {
    const float c = req[r] > KAI_EPS
                        ? __fdiv_rn(__fadd_rn(avail[r], KAI_EPS),
                                    fmaxf(req[r], KAI_EPS))
                        : INFINITY;
    m = fminf(m, c);
  }
  return static_cast<int>(fminf(fmaxf(floorf(m), 0.0f), 1e9f));
}

__global__ void __launch_bounds__(TT_THREADS) tt_counts_kernel(
    const u8* __restrict__ fp_build, const float* __restrict__ avail,
    const float* __restrict__ type_req, int N, int Y,
    int* __restrict__ c_y) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Y * (N + 1)) return;
  const int y = i / (N + 1), n = i % (N + 1);
  c_y[i] = (n < N && fp_build[(size_t)y * N + n])
               ? tt_replicas(avail + (size_t)n * 3, type_req + y * 3)
               : 0;
}

__global__ void __launch_bounds__(TT_THREADS) tt_domains_kernel(
    const int* __restrict__ dom_ptr, const int* __restrict__ dom_nodes,
    const float* __restrict__ avail, const int* __restrict__ c_y, int N,
    int ND, int Y, int* __restrict__ caps, float* __restrict__ agg) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= ND) return;
  const int lo = dom_ptr[d], hi = dom_ptr[d + 1];
  float a = 0.0f;
  for (int j = lo; j < hi; ++j)
    a = __fadd_rn(a, avail[(size_t)dom_nodes[j] * 3]);
  agg[d] = a;
  for (int y = 0; y < Y; ++y) {
    unsigned int s = 0;  // int32 arithmetic, wrapping as the reference's
    for (int j = lo; j < hi; ++j)
      s += (unsigned int)c_y[(size_t)y * (N + 1) + dom_nodes[j]];
    caps[(size_t)y * ND + d] = (int)s;
  }
}

// entry k's node when its lane was taken and it placed, else -1
__device__ __forceinline__ int tt_node(const u8* take, const int* nodes_b,
                                       int T, int k) {
  return take[k / T] ? max(nodes_b[k], -1) : -1;
}

__global__ void __launch_bounds__(TT_THREADS) tt_update_kernel(
    const int* __restrict__ dom_of, const u8* __restrict__ fp_build,
    const float* __restrict__ avail, const u8* __restrict__ take,
    const int* __restrict__ nodes_b, const float* __restrict__ req0_b,
    const float* __restrict__ type_req, int N, int L, int Y, int T, int K,
    int* __restrict__ caps, float* __restrict__ agg,
    int* __restrict__ c_y) {
  const int ND = N * L;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K * (L + 1)) return;
  if (i < K) {
    // the first entry on a node recomputes its counts and pushes the
    // changes into every level's domain
    const int k = i, n = tt_node(take, nodes_b, T, k);
    if (n < 0) return;
    for (int e = 0; e < k; ++e)
      if (tt_node(take, nodes_b, T, e) == n) return;
    for (int y = 0; y < Y; ++y) {
      const size_t o = (size_t)y * (N + 1) + n;
      const int c_new = fp_build[(size_t)y * N + n]
                            ? tt_replicas(avail + (size_t)n * 3,
                                          type_req + y * 3)
                            : 0;
      const int d = (int)((unsigned int)c_new - (unsigned int)c_y[o]);
      c_y[o] = c_new;
      if (d == 0) continue;
      for (int lvl = 0; lvl < L; ++lvl) {
        const int dom = dom_of[(size_t)lvl * N + n];
        if (dom < ND) atomicAdd(caps + (size_t)y * ND + dom, d);
      }
    }
    return;
  }
  // (level, entry): the first entry of a domain walks the later entries in
  // the same domain, in entry order, and debits the aggregate
  const int lvl = (i - K) / K, k = (i - K) % K;
  const int n = tt_node(take, nodes_b, T, k);
  if (n < 0) return;
  const int* dl = dom_of + (size_t)lvl * N;
  const int dom = dl[n];
  if (dom >= ND) return;
  for (int e = 0; e < k; ++e) {
    const int m = tt_node(take, nodes_b, T, e);
    if (m >= 0 && dl[m] == dom) return;
  }
  float a = agg[dom];
  for (int e = k; e < K; ++e) {
    const int m = tt_node(take, nodes_b, T, e);
    if (m >= 0 && dl[m] == dom) a = __fadd_rn(a, -req0_b[e / T]);
  }
  agg[dom] = a;
}

// the CSR holds the valid, labelled nodes only: no validity mask needed
KAI_EXPORT int kai_topo_tables_build(const int* dom_ptr, const int* dom_nodes,
                                     const u8* fp_build, const float* avail,
                                     const float* type_req, int N, int L,
                                     int Y, int* caps, float* agg, int* c_y,
                                     cudaStream_t stream) {
  if (N < 1 || L < 1 || Y < 1) return KAI_ERR_ARGS;
  const int ND = N * L;
  const int nc = Y * (N + 1);
  tt_counts_kernel<<<(nc + TT_THREADS - 1) / TT_THREADS, TT_THREADS, 0,
                     stream>>>(fp_build, avail, type_req, N, Y, c_y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  tt_domains_kernel<<<(ND + TT_THREADS - 1) / TT_THREADS, TT_THREADS, 0,
                      stream>>>(dom_ptr, dom_nodes, avail, c_y, N, ND, Y,
                                caps, agg);
  return static_cast<int>(cudaGetLastError());
}

KAI_EXPORT int kai_topo_tables_update(
    const int* dom_of, const u8* fp_build, const float* avail, const u8* take,
    const int* nodes_b, const float* req0_b, const float* type_req, int N,
    int L, int Y, int B, int T, int* caps, float* agg, int* c_y,
    cudaStream_t stream) {
  if (N < 1 || L < 1 || Y < 1 || B < 1 || T < 1) return KAI_ERR_ARGS;
  const int K = B * T;
  const int work = K * (L + 1);
  tt_update_kernel<<<(work + TT_THREADS - 1) / TT_THREADS, TT_THREADS, 0,
                     stream>>>(dom_of, fp_build, avail, take, nodes_b, req0_b,
                               type_req, N, L, Y, T, K, caps, agg, c_y);
  return static_cast<int>(cudaGetLastError());
}
