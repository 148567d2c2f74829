// K4 sparse_accept — the first wavefront lane whose claims over-subscribe
// a node.
//
// Replaces kai_scheduler_tpu/ops/allocate.py:283 `sparse_entry_tables`
// and :313 `sparse_accept_first_bad` (called at :1726).  One block: the
// K = B*T claim entries (node, lane-major index) are sorted stably by node
// in shared memory — a bitonic sort of the unique keys (node << 32 |
// index), which is the stable order — then two block-wide prefix sums
// give every entry its node-cumulative claim, reproducing the reference's
// `cs - (cs - req_s)[sidx]`, checked against the pipeline pool
// (free + releasing + extra) and, for the bind-now subset, against the
// idle pool, both with EPS; a block-wide min gives the first violating
// lane (B when every claim fits).
//
// The claims are whole-unit requests in the snapshots this path runs
// (uniform replicas of whole accelerators, cores and GiB), so every f32
// prefix sum is exact and its order does not matter.
//
// Bound: launch latency — the inputs are a few KB (K = 2,048 entries at
// the headline); the sort's log^2 K shared-memory passes are the cost.
// Up to SA_SMEM_KP (padded) entries the keys and prefix sums live in
// shared memory; beyond, in a global scratch buffer the wrapper passes
// (same code, slower memory).
#include "kai_common.cuh"

#define SA_THREADS 1024
#define SA_SMEM_KP 4096

extern __shared__ __align__(16) unsigned char sa_smem[];

// inclusive block scan of three floats per thread (Hillis-Steele over the
// per-thread totals); every thread must call it
__device__ void sa_scan3(float* tot /* [SA_THREADS*3] */, float v[3]) {
  const int t = threadIdx.x;
  for (int r = 0; r < 3; ++r) tot[t * 3 + r] = v[r];
  __syncthreads();
  for (int off = 1; off < SA_THREADS; off <<= 1) {
    float add[3] = {0.f, 0.f, 0.f};
    if (t >= off)
      for (int r = 0; r < 3; ++r) add[r] = tot[(t - off) * 3 + r];
    __syncthreads();
    for (int r = 0; r < 3; ++r) tot[t * 3 + r] = __fadd_rn(tot[t * 3 + r], add[r]);
    __syncthreads();
  }
  for (int r = 0; r < 3; ++r) v[r] = tot[t * 3 + r];
  __syncthreads();
}

__global__ void __launch_bounds__(SA_THREADS) sparse_accept_kernel(
    const int* __restrict__ nodes_b, const u8* __restrict__ ent_ok,
    const u8* __restrict__ pipe_b, const float* __restrict__ req_b,
    const float* __restrict__ free_, const float* __restrict__ pipe_pool,
    int B, int T, int N, int Kp, unsigned char* scratch,
    int* __restrict__ first_bad, int* __restrict__ node_e,
    int* __restrict__ lane_e) {
  const int K = B * T;
  const int tid = threadIdx.x;
  // [Kp] keys, then [Kp, 3] pipe and [Kp, 3] bind claim prefix sums: in
  // shared memory, or in the global scratch for large chunks
  unsigned char* base = scratch ? scratch : sa_smem;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base);
  float* cs = reinterpret_cast<float*>(keys + Kp);
  float* csb = cs + (size_t)Kp * 3;
  float* tot = scratch ? reinterpret_cast<float*>(sa_smem)
                       : csb + (size_t)Kp * 3;        // [SA_THREADS, 3]
  __shared__ int s_bad;
  if (tid == 0) s_bad = B;

  // ---- entries, lane-major; junk entries carry node N -------------------
  for (int i = tid; i < Kp; i += SA_THREADS) {
    if (i < K) {
      const int ne = ent_ok[i] ? nodes_b[i] : N;
      node_e[i] = ne;
      lane_e[i] = i / T;
      keys[i] = (static_cast<unsigned long long>(ne) << 32) |
                static_cast<unsigned int>(i);
    } else {
      keys[i] = ~0ull;
    }
  }
  __syncthreads();

  // ---- bitonic sort (unique keys: the stable node order) ----------------
  for (int size = 2; size <= Kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < (Kp >> 1); i += SA_THREADS) {
        const int pos = 2 * i - (i & (stride - 1));
        const int partner = pos + stride;
        const bool asc = (pos & size) == 0;
        const unsigned long long a = keys[pos], c = keys[partner];
        if ((a > c) == asc) {
          keys[pos] = c;
          keys[partner] = a;
        }
      }
      __syncthreads();
    }
  }

  // ---- per-entry claims and their prefix sums ---------------------------
  const int chunk = (Kp + SA_THREADS - 1) / SA_THREADS;
  const int lo = min(tid * chunk, Kp), hi = min(lo + chunk, Kp);
  float run[3] = {0.f, 0.f, 0.f}, runb[3] = {0.f, 0.f, 0.f};
  for (int i = lo; i < hi; ++i) {
    const unsigned long long key = keys[i];
    float rq[3] = {0.f, 0.f, 0.f}, rb[3] = {0.f, 0.f, 0.f};
    if (i < K) {
      const int idx = static_cast<int>(key & 0xffffffffu);
      const int ln = idx / T;
      const bool ok = ent_ok[idx] != 0;
      const bool bind = ok && !pipe_b[idx];
      for (int r = 0; r < 3; ++r) {
        const float q = req_b[ln * 3 + r];
        rq[r] = ok ? q : 0.0f;
        rb[r] = bind ? q : 0.0f;
      }
    }
    for (int r = 0; r < 3; ++r) {
      run[r] = __fadd_rn(run[r], rq[r]);
      runb[r] = __fadd_rn(runb[r], rb[r]);
      cs[i * 3 + r] = run[r];
      csb[i * 3 + r] = runb[r];
    }
  }
  float ex[3] = {run[0], run[1], run[2]};
  float exb[3] = {runb[0], runb[1], runb[2]};
  sa_scan3(tot, ex);
  sa_scan3(tot, exb);
  for (int r = 0; r < 3; ++r) {  // inclusive -> exclusive offset
    ex[r] = __fsub_rn(ex[r], run[r]);
    exb[r] = __fsub_rn(exb[r], runb[r]);
  }
  for (int i = lo; i < hi; ++i)
    for (int r = 0; r < 3; ++r) {
      cs[i * 3 + r] = __fadd_rn(cs[i * 3 + r], ex[r]);
      csb[i * 3 + r] = __fadd_rn(csb[i * 3 + r], exb[r]);
    }
  __syncthreads();

  // ---- every entry against its node's pools -----------------------------
  int bad = B;
  for (int i = tid; i < K; i += SA_THREADS) {
    const unsigned long long key = keys[i];
    const int node = static_cast<int>(key >> 32);
    if (node >= N) continue;  // junk entries sort last and never violate
    const int idx = static_cast<int>(key & 0xffffffffu);
    const int ln = idx / T;
    // sidx: first sorted position of this node's segment
    int a = 0, z = i;
    const unsigned long long seg_key = static_cast<unsigned long long>(node) << 32;
    while (a < z) {
      const int mid = (a + z) >> 1;
      if (keys[mid] < seg_key) a = mid + 1; else z = mid;
    }
    const int s = a;
    const int sidx_idx = static_cast<int>(keys[s] & 0xffffffffu);
    const int sln = sidx_idx / T;
    const bool s_ok = ent_ok[sidx_idx] != 0;
    const bool s_bind = s_ok && !pipe_b[sidx_idx];
    bool viol = false;
    for (int r = 0; r < 3; ++r) {
      const float rs = s_ok ? req_b[sln * 3 + r] : 0.0f;
      const float rbs = s_bind ? req_b[sln * 3 + r] : 0.0f;
      const float cum_e = __fsub_rn(cs[i * 3 + r], __fsub_rn(cs[s * 3 + r], rs));
      const float cumb_e =
          __fsub_rn(csb[i * 3 + r], __fsub_rn(csb[s * 3 + r], rbs));
      viol = viol || (cum_e > __fadd_rn(pipe_pool[node * 3 + r], KAI_EPS));
      viol = viol ||
             (cumb_e > __fadd_rn(fmaxf(free_[node * 3 + r], 0.0f), KAI_EPS));
    }
    if (viol) bad = min(bad, ln);
  }
  if (bad < B) atomicMin(&s_bad, bad);
  __syncthreads();
  if (tid == 0) *first_bad = s_bad;
}

// `scratch` (Kp * 32 bytes, Kp = B*T padded to a power of two) is needed
// only when Kp > SA_SMEM_KP; pass null otherwise
KAI_EXPORT int kai_sparse_accept(const int* nodes_b, const u8* ent_ok,
                                 const u8* pipe_b, const float* req_b,
                                 const float* free_, const float* pipe_pool,
                                 int B, int T, int N, int R,
                                 unsigned char* scratch, int* first_bad,
                                 int* node_e, int* lane_e,
                                 cudaStream_t stream) {
  if (B < 1 || T < 1 || N < 1 || R != 3) return KAI_ERR_ARGS;
  int Kp = 2;
  while (Kp < B * T) Kp <<= 1;
  if (Kp > SA_SMEM_KP && scratch == nullptr) return KAI_ERR_ARGS;
  if (Kp <= SA_SMEM_KP) scratch = nullptr;
  const size_t smem = (scratch ? 0 : (size_t)Kp * (8 + 24)) +
                      (size_t)SA_THREADS * 12;
  cudaError_t e = cudaFuncSetAttribute(
      sparse_accept_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  sparse_accept_kernel<<<1, SA_THREADS, smem, stream>>>(
      nodes_b, ent_ok, pipe_b, req_b, free_, pipe_pool, B, T, N, Kp, scratch,
      first_bad, node_e, lane_e);
  return static_cast<int>(cudaGetLastError());
}
