// K12 affinity_mask and K13 anti_mark — the in-cycle affinity gates.
//
// The cycle keeps one claimed-domain table, `anti_used` bool
// [TA + 1, AD + 1]: row t is a term row (a cross-gang required anti term,
// a shared host port, or an anchor of required positive affinity), column
// d a domain id of `dom_static` [L + 1, N] (rows 0..L-1 the topology
// levels, a node lacking a level's label its own domain N*L + node, row L
// the per-node level; padded nodes the junk id AD = N*L + N).  Row TA and
// column AD are junk.
//
// K12 replaces kai_scheduler_tpu/ops/allocate.py:171 `anti_forbid_nodes`
// and :232 `attract_allow_nodes` under the chunk's lane axis (:1670-1680,
// victims.py:1349-1357), with `n.valid & domain_mask` of `_attempt_gang`
// (:1259) folded in: one thread per (lane, node) walks the lane's gang's
// KT avoid slots and KP need slots; per slot it gathers the row's level,
// the node's domain at that level and the table's bit (and, for a need
// row, the row's static claim on the node).  An avoid row that claimed
// the domain forbids the node; a need row that claimed neither statically
// nor in this cycle forbids it; unused slots (-1) pass.  The clamps are the
// reference's: the slot to [0, TA - 1], the level to [0, L], the gang to
// [0, G - 1] (JAX's gathers clamp; the junk lanes' gang index is G).
//
// K13 replaces :189 `anti_mark_placements` (the scatter-max of True): one
// thread per (lane, mark slot, task) writes True at (row, domain of the
// task's node) where the lane was taken, the task placed and the slot
// used, and at the junk cell (TA, AD) otherwise, as the reference's
// scatter does.  Every write stores True, so plain stores in any order
// give the same table: no atomics.  It marks the table in place: each
// action clones the table it is handed once and marks that copy.
//
// Bound: K12 reads the table's bits at the lanes' rows and the nodes'
// domains (the table, 3.2 MB at TA = 321 and 10,000 nodes, sits in L2),
// the domain rows and the static claims once, and writes B x N bytes: it
// is bytes-bound, a few loads a (lane, node).  K13 writes at most
// B x KT x T cells: launch-bound.
#include "kai_common.cuh"

#define AF_THREADS 256

__global__ void __launch_bounds__(AF_THREADS) affinity_mask_kernel(
    const u8* __restrict__ anti_used, const int* __restrict__ dom_static,
    const int* __restrict__ term_level, const int* __restrict__ avoids,
    const int* __restrict__ needs, const u8* __restrict__ attract_static,
    const u8* __restrict__ valid, const int* __restrict__ cand, int N, int L,
    int TA, int G, int KT, int KP, int attract, u8* __restrict__ out) {
  const int b = blockIdx.y;
  const int n = blockIdx.x * AF_THREADS + threadIdx.x;
  if (n >= N) return;
  const size_t AD1 = (size_t)N * L + N + 1;
  const int gi = min(max(cand[b], 0), G - 1);
  bool ok = valid[n] != 0;
  for (int k = 0; k < KT && ok; ++k) {
    const int s = avoids[(size_t)gi * KT + k];
    if (s < 0) continue;
    const int t = min(max(s, 0), TA - 1);
    const int lvl = min(max(term_level[t], 0), L);
    const int dom = dom_static[(size_t)lvl * N + n];
    if (anti_used[(size_t)t * AD1 + dom]) ok = false;
  }
  if (attract) {
    for (int k = 0; k < KP && ok; ++k) {
      const int s = needs[(size_t)gi * KP + k];
      if (s < 0) continue;
      const int t = min(max(s, 0), TA - 1);
      const int lvl = min(max(term_level[t], 0), L);
      const int dom = dom_static[(size_t)lvl * N + n];
      if (!anti_used[(size_t)t * AD1 + dom] &&
          !attract_static[(size_t)t * N + n])
        ok = false;
    }
  }
  out[(size_t)b * N + n] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(AF_THREADS) anti_mark_kernel(
    const int* __restrict__ dom_static, const int* __restrict__ term_level,
    const int* __restrict__ marks, const int* __restrict__ cand,
    const int* __restrict__ nodes_b, const u8* __restrict__ take, int B,
    int T, int N, int L, int TA, int G, int KT, u8* __restrict__ anti_used) {
  const long long idx = (long long)blockIdx.x * AF_THREADS + threadIdx.x;
  if (idx >= (long long)B * KT * T) return;
  const int b = (int)(idx / ((long long)KT * T));
  const int r = (int)(idx % ((long long)KT * T));
  const int k = r / T, t = r % T;
  const size_t AD = (size_t)N * L + N;
  const int gi = min(max(cand[b], 0), G - 1);
  const int m = marks[(size_t)gi * KT + k];
  const int node = nodes_b[(size_t)b * T + t];
  if (take[b] && node >= 0 && m >= 0) {
    const int row = min(max(m, 0), TA - 1);
    const int lvl = min(max(term_level[row], 0), L);
    const int dom = dom_static[(size_t)lvl * N + node];
    anti_used[(size_t)row * (AD + 1) + dom] = 1;
  } else {
    anti_used[(size_t)TA * (AD + 1) + AD] = 1;
  }
}

KAI_EXPORT int kai_affinity_mask(const u8* anti_used, const int* dom_static,
                                 const int* term_level, const int* avoids,
                                 const int* needs, const u8* attract_static,
                                 const u8* valid, const int* cand, int B,
                                 int N, int L, int TA, int G, int KT, int KP,
                                 int attract, u8* out, cudaStream_t stream) {
  if (B < 1 || B > 65535 || N < 1 || L < 0 || TA < 1 || G < 1 || KT < 0 ||
      KP < 0 || (attract && (!needs || !attract_static)))
    return KAI_ERR_ARGS;
  const dim3 grid((N + AF_THREADS - 1) / AF_THREADS, B);
  affinity_mask_kernel<<<grid, AF_THREADS, 0, stream>>>(
      anti_used, dom_static, term_level, avoids, needs, attract_static, valid,
      cand, N, L, TA, G, KT, KP, attract, out);
  return static_cast<int>(cudaGetLastError());
}

KAI_EXPORT int kai_anti_mark(const int* dom_static, const int* term_level,
                             const int* marks, const int* cand,
                             const int* nodes_b, const u8* take, int B, int T,
                             int N, int L, int TA, int G, int KT,
                             u8* anti_used, cudaStream_t stream) {
  if (B < 1 || T < 1 || N < 1 || L < 0 || TA < 1 || G < 1 || KT < 1)
    return KAI_ERR_ARGS;
  const long long total = (long long)B * KT * T;
  const unsigned blocks = (unsigned)((total + AF_THREADS - 1) / AF_THREADS);
  anti_mark_kernel<<<blocks, AF_THREADS, 0, stream>>>(
      dom_static, term_level, marks, cand, nodes_b, take, B, T, N, L, TA, G,
      KT, anti_used);
  return static_cast<int>(cudaGetLastError());
}
