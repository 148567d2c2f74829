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
// (:1259) folded in.  An avoid row that claimed a node's domain (at the
// row's level) forbids the node; a need row that claimed it neither
// statically nor in this cycle forbids it; unused slots (-1) pass.  The
// clamps are the reference's: the slot to [0, TA - 1], the level to
// [0, L], the gang to [0, G - 1] (JAX's gathers clamp; the junk lanes'
// gang index is G).
//
// Design (`affinity_mask_nodes_kernel`): a block is one lane and 2,048
// nodes (128 threads x 16 consecutive nodes; 4 nodes a thread, 512 a
// block, when that grid would give the card fewer than two blocks an SM,
// as one lane does).  Warp 0 resolves the lane's gang once and lists its
// USED avoid and need slots in shared memory (the table row's base, the
// level's row of dom_static, the need row's static row), 32 raw slots a
// round; unused slots cost nothing.  Each thread reads its nodes' valid
// bytes as one vector before it waits on the list, then per listed slot
// its domain ids as int4 vectors and one table byte a node: at the
// per-node level, where a valid node's domain is N L + node, the one or
// two aligned 16-byte words holding its nodes' cells are read beside the
// domain ids and taken where those ids run consecutively; elsewhere (a
// topology level, an invalid node) a gather a node.  A need row's static
// bytes are one vector.  The mask is kept as bits and written as one
// vector.  B x ceil(N / 2,048) blocks (1,280 at 256 lanes and 10,000
// nodes; the one-thread-a-node grid it replaces had 10,240).  A lane
// whose gang uses no slot writes `valid`.  N not a multiple of the vector
// (16 or 4 nodes) or rows off a 16-byte boundary take byte loads.
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
// is bytes-bound, a few loads a (lane, used slot, node).  K13 writes at most
// B x KT x T cells: launch-bound.
#include "kai_common.cuh"

#define AF_THREADS 256
// K12: threads a block, raw slots a metadata round, and the grid below
// which a thread takes 4 nodes instead of 16 (two blocks an SM)
#define AM_THREADS 128
#define AM_SLOTS 32
#define AM_WIDE_BLOCKS 264

// one used slot of a lane's gang: its table row's base, its level's row of
// dom_static, and (need rows) its static-claim row; -1 for an avoid row
struct AmSlot {
  long long cell;
  int dom;
  int stat;
};

// bit i: byte i of w is not 0
__device__ __forceinline__ unsigned am_nz4(unsigned w) {
  return ((w & 0xFFu) != 0) | (((w >> 8) & 0xFFu) != 0) << 1 |
         (((w >> 16) & 0xFFu) != 0) << 2 | ((w >> 24) != 0) << 3;
}

// bit i: p[i] is not 0, for the NPT bytes at p (node n0 + i < N)
template <int NPT>
__device__ __forceinline__ unsigned am_bytes(const u8* __restrict__ p, int n0,
                                             int N, bool full) {
  unsigned m = 0;
  if (full) {
    if (NPT == 16) {
      const uint4 w = *reinterpret_cast<const uint4*>(p);
      m = am_nz4(w.x) | am_nz4(w.y) << 4 | am_nz4(w.z) << 8 |
          am_nz4(w.w) << 12;
    } else {
      m = am_nz4(*reinterpret_cast<const unsigned*>(p));
    }
  } else {
#pragma unroll
    for (int i = 0; i < NPT; ++i)
      if (n0 + i < N && p[i] != 0) m |= 1u << i;
  }
  return m;
}

// u[i] for a runtime i < 8, by selects (u stays in registers)
__device__ __forceinline__ unsigned am_pick(const unsigned u[8], int i) {
  unsigned v = u[0];
#pragma unroll
  for (int j = 1; j < 8; ++j) v = i == j ? u[j] : v;
  return v;
}

// bit i: p[i] is not 0, for NPT consecutive bytes at any alignment: the
// one or two aligned 16-byte words that hold them, shifted into place
template <int NPT>
__device__ __forceinline__ unsigned am_window(const u8* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint4* base = reinterpret_cast<const uint4*>(a & ~(uintptr_t)15);
  const int off = (int)(a & 15);
  const uint4 w0 = base[0];
  const uint4 w1 = off + NPT > 16 ? base[1] : w0;
  const unsigned u[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  const int q = off >> 2, r = 8 * (off & 3);
  unsigned m = 0;
#pragma unroll
  for (int k = 0; k < NPT / 4; ++k)
    m |= am_nz4(__funnelshift_r(am_pick(u, q + k), am_pick(u, q + k + 1),
                                r)) << (4 * k);
  return m;
}

// bytes of 1 and 0 from the low 4 bits of m
__device__ __forceinline__ unsigned am_spread4(unsigned m) {
  return (m & 1u) | (m & 2u) << 7 | (m & 4u) << 14 | (m & 8u) << 21;
}

// One lane's mask over NPT consecutive nodes a thread (see the header).
template <int NPT>
__device__ __forceinline__ void affinity_mask_body(
    const u8* __restrict__ anti_used, const int* __restrict__ dom_static,
    const int* __restrict__ term_level, const int* __restrict__ avoids,
    const int* __restrict__ needs, const u8* __restrict__ attract_static,
    const u8* __restrict__ valid, const int* __restrict__ cand, int N, int L,
    int TA, int G, int KT, int KP, int attract, int vec,
    u8* __restrict__ out, AmSlot* slots, int* n_slots) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * AM_THREADS + threadIdx.x) * NPT;
  const bool full = vec && n0 + NPT <= N;
  const long long AD1 = (long long)N * L + N + 1;
  // the valid nodes first: they do not wait on the lane's slots
  unsigned ok = n0 < N ? am_bytes<NPT>(valid + n0, n0, N, full) : 0u;
  const int gi = min(max(cand[b], 0), G - 1);
  const int K = KT + (attract ? KP : 0);
  // raw slots [avoids | needs] in rounds of 32: warp 0 lists the used ones
  for (int k0 = 0; k0 < K; k0 += AM_SLOTS) {
    if (threadIdx.x < 32) {
      const int k = k0 + lane;
      int s = -1;
      if (k < KT)
        s = avoids[(size_t)gi * KT + k];
      else if (k < K)
        s = needs[(size_t)gi * KP + (k - KT)];
      const unsigned used = __ballot_sync(0xffffffffu, s >= 0);
      if (s >= 0) {
        const int t = min(max(s, 0), TA - 1);
        const int lvl = min(max(term_level[t], 0), L);
        AmSlot sl;
        sl.cell = (long long)t * AD1;
        sl.dom = lvl * N;
        sl.stat = k < KT ? -1 : t;
        slots[__popc(used & ((1u << lane) - 1u))] = sl;
      }
      if (lane == 0) *n_slots = __popc(used);
    }
    __syncthreads();
    const int ns = *n_slots;
    if (n0 < N) {
      for (int j = 0; j < ns && ok; ++j) {
        const AmSlot sl = slots[j];
        const u8* row = anti_used + sl.cell;
        // at the per-node level a valid node's domain is N L + node: the
        // window of its cells is read beside the domain ids and used where
        // those ids run consecutively (else a gather a node)
        const bool per_node = full && sl.dom == L * N;
        const unsigned spec =
            per_node ? am_window<NPT>(row + (size_t)L * N + n0) : 0u;
        int dom[NPT];
        if (full) {
          const int4* src =
              reinterpret_cast<const int4*>(dom_static + sl.dom + n0);
#pragma unroll
          for (int q = 0; q < NPT / 4; ++q) {
            const int4 d = src[q];
            dom[4 * q] = d.x;
            dom[4 * q + 1] = d.y;
            dom[4 * q + 2] = d.z;
            dom[4 * q + 3] = d.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < NPT; ++i)
            dom[i] = n0 + i < N ? dom_static[sl.dom + n0 + i] : 0;
        }
        bool run = per_node;
#pragma unroll
        for (int i = 0; i < NPT; ++i) run = run && dom[i] == L * N + n0 + i;
        unsigned hit = spec;
        if (!run) {
          hit = 0;
#pragma unroll
          for (int i = 0; i < NPT; ++i)
            if (n0 + i < N && row[dom[i]] != 0) hit |= 1u << i;
        }
        if (sl.stat < 0)
          ok &= ~hit;
        else
          ok &= hit | am_bytes<NPT>(attract_static + (size_t)sl.stat * N + n0,
                                    n0, N, full);
      }
    }
    __syncthreads();
  }
  if (n0 >= N) return;
  u8* dst = out + (size_t)b * N + n0;
  if (full) {
    if (NPT == 16)
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(am_spread4(ok), am_spread4(ok >> 4), am_spread4(ok >> 8),
                     am_spread4(ok >> 12));
    else
      *reinterpret_cast<unsigned*>(dst) = am_spread4(ok);
  } else {
#pragma unroll
    for (int i = 0; i < NPT; ++i)
      if (n0 + i < N) dst[i] = (ok >> i) & 1u;
  }
}

// wide: 16 nodes a thread; else 4 (small grids: more blocks in flight)
__global__ void __launch_bounds__(AM_THREADS, 10) affinity_mask_nodes_kernel(
    const u8* __restrict__ anti_used, const int* __restrict__ dom_static,
    const int* __restrict__ term_level, const int* __restrict__ avoids,
    const int* __restrict__ needs, const u8* __restrict__ attract_static,
    const u8* __restrict__ valid, const int* __restrict__ cand, int N, int L,
    int TA, int G, int KT, int KP, int attract, int vec, int wide,
    u8* __restrict__ out) {
  __shared__ AmSlot slots[AM_SLOTS];
  __shared__ int n_slots;
  if (wide)
    affinity_mask_body<16>(anti_used, dom_static, term_level, avoids, needs,
                           attract_static, valid, cand, N, L, TA, G, KT, KP,
                           attract, vec, out, slots, &n_slots);
  else
    affinity_mask_body<4>(anti_used, dom_static, term_level, avoids, needs,
                          attract_static, valid, cand, N, L, TA, G, KT, KP,
                          attract, vec, out, slots, &n_slots);
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
  const int wide =
      (long long)B * ((N + AM_THREADS * 16 - 1) / (AM_THREADS * 16)) >=
      AM_WIDE_BLOCKS;
  const int npt = wide ? 16 : 4;
  // vectors when every row of valid, dom_static, attract_static and out
  // starts on an npt-byte boundary (and the bases on 16 bytes)
  const uintptr_t align = (uintptr_t)valid | (uintptr_t)dom_static |
                          (uintptr_t)out |
                          (attract ? (uintptr_t)attract_static : 0);
  const int vec = (N % npt == 0) && (align % 16 == 0);
  const int per_block = AM_THREADS * npt;
  const dim3 grid((N + per_block - 1) / per_block, B);
  affinity_mask_nodes_kernel<<<grid, AM_THREADS, 0, stream>>>(
      anti_used, dom_static, term_level, avoids, needs, attract_static, valid,
      cand, N, L, TA, G, KT, KP, attract, vec, wide, out);
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
