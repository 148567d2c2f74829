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
// A pod belongs to at most one lane, so every sum runs in the reference's
// order (ascending pod index from +0.0, XLA's scatter) with no float
// atomics, over K6's CSR pod lists (by max(node, 0) and by max(queue, 0),
// stable in pod index, built once per action).  Only live pods
// (0 <= lane < B) add anything: the reference sends every other pod to a
// dropped segment.  Five launches:
//   0. fl_zero_kernel: +0.0 into the node outputs (and 0 into own_incr) in
//      16-byte stores over each buffer.  A chunk's victims are few, so
//      nearly every cell of the [B, N, *] tables stays +0.0 (a sum of +0.0
//      from +0.0, composed or not); a flat fill writes them at the memory
//      rate, where a block's per-lane runs of a few nodes did not;
//   1. fl_count_kernel: the live pods of each FL_SEG-entry segment of the
//      queue lists;
//   2. fl_scatter_kernel: the live pods of the queue lists compacted in
//      list order (each segment's offset is the sum of the counts before
//      it), and each leaf queue's start in the compacted list;
//   3. freed_by_lane_kernel, two kinds of blocks in one grid:
//      - one block per leaf queue: its live pods staged in shared memory
//        FL_QCHUNK at a time, one thread per (lane, resource) adding the
//        chunk's pods of its lane in order into a [B, 3] table in shared
//        memory; with compose the lane prefix there; the [B, 3] rows
//        written to the [B, Q, 3] scratch;
//      - one block per tile of TN nodes (and column slab; TN the widest
//        tile whose table fits two blocks an SM, at most N / 512): a tile
//        with no live pod returns at once; else its [B, TN, C] table
//        (C = 3 (+ D) (+ E) columns, or a slab of them) in shared memory,
//        zeroed there; the tile's pod lists (one contiguous range of the
//        node CSR) read FL_THREADS entries at a time and their live pods
//        compacted in order (warp ballots and a block prefix), so node
//        0's padding rows cost one coalesced pass; one thread per (node,
//        column) adds that node's compacted pods in order into the cells
//        (lane, node, column) — the only writer of those cells, so no
//        atomics and the reference's bits; whole-device bits are counted
//        per (lane, node, device) in an integer table and each count added
//        once after the fractional shares (exact: the reference's per_d +
//        per_w); own_incr from the table; with compose the lane prefix of
//        every column in shared memory; the tile's cells written;
//   4. freed_by_lane_rollup_kernel: the leaf sums rolled up the chain, one
//      thread per (lane, ancestor, resource), over q ascending (a chain
//      entry of 0 adds +0.0 in the reference, which leaves the sum
//      unchanged, so it is skipped).
// The lane prefix is jnp.cumsum's order on the CPU: XLA rewrites it into
// blocks of 16 summed left to right from +0.0, scans the block totals the
// same way and adds each block's exclusive prefix (numerics.cumsum_blocked);
// in shared memory every (16-lane block, column) runs in parallel, then
// every column's totals (one level for B <= 256, two up to FL_MAX_LANES),
// then every cell adds its block's prefix.
// Bound: bytes — the live pods' rows once, the [B, N, R], [B, N, D],
// [B, N, E], [B, N] and [B, Q, R] outputs written once (the design writes
// the few tiles with a live pod twice: the fill, then the tile).
#include <algorithm>

#include "kai_common.cuh"

#define FL_THREADS 512
#define FL_WARPS (FL_THREADS / 32)
#define FL_SEG 1024
#define FL_QCHUNK 1024
#define FL_MAX_LANES 4096
#define FL_MAX_D 32
#define FL_MAX_E 8
// nodes a tile takes at most (a tile with a live pod sums, scans and
// writes all of its [B, TN, C] cells)
#define FL_TILE_NODES 8
// shared memory of a node tile that keeps two blocks on an SM, and of a
// one-node slab (large B x C)
#define FL_TILE_SMEM (100 * 1024)
#define FL_SLAB_SMEM (200 * 1024)
// a node tile's fixed shared memory: the compacted pods (pod, lane, node),
// the tile's CSR offsets, the warp counts, each cell column's table and
// offset in a lane's rows
#define FL_TILE_FIXED                                                   \
  ((3 * FL_THREADS + FL_TILE_NODES + 1 + FL_WARPS + 1 +                 \
    2 * FL_TILE_NODES * (3 + FL_MAX_D + FL_MAX_E)) *                    \
   (int)sizeof(int))

// jnp.cumsum order of n <= 256 floats at t[i * stride] (the block totals
// of up to FL_MAX_LANES lanes), in place
__device__ void fl_scan_totals(float* t, int n, int stride) {
  float tot[16];
  const int nb = (n + 15) / 16;
  for (int k = 0; k < nb; ++k) {
    float acc = 0.0f;
    const int e = min(n, 16 * k + 16);
    for (int i = 16 * k; i < e; ++i) {
      acc = __fadd_rn(acc, t[i * stride]);
      t[i * stride] = acc;
    }
    tot[k] = e < 16 * k + 16 ? __fadd_rn(acc, 0.0f) : acc;  // zero padding
  }
  if (nb <= 1) return;
  float run = 0.0f;
  for (int k = 0; k < nb; ++k) {  // nb <= 16: the totals' scan is one block
    const float excl = run;
    run = __fadd_rn(run, tot[k]);
    const int e = min(n, 16 * k + 16);
    for (int i = 16 * k; i < e; ++i)
      t[i * stride] = __fadd_rn(t[i * stride], excl);
  }
}

// the next cell x + blockDim.x of a [rows, J] table walked as (row, col),
// with dr = blockDim.x / J, dc = blockDim.x % J (no division a step)
__device__ __forceinline__ void fl_step(int& r, int& c, int dr, int dc,
                                        int J) {
  c += dc;
  r += dr;
  if (c >= J) {
    c -= J;
    ++r;
  }
}

// jnp.cumsum order over the B lanes of every column of a [B, J] table in
// shared memory, in place; `tot` holds [ceil(B / 16), J] block totals.
// Every thread of the block calls it; it ends with a barrier.
__device__ void fl_scan_smem(float* T, float* tot, int B, int J) {
  const int nb = (B + 15) / 16;
  const int dr = blockDim.x / J, dc = blockDim.x % J;
  for (int k = threadIdx.x / J, j = threadIdx.x % J; k < nb;
       fl_step(k, j, dr, dc, J)) {
    const int e = min(B, 16 * k + 16);
    float acc = 0.0f;
    for (int l = 16 * k; l < e; ++l) {
      acc = __fadd_rn(acc, T[l * J + j]);
      T[l * J + j] = acc;
    }
    tot[k * J + j] = e < 16 * k + 16 ? __fadd_rn(acc, 0.0f) : acc;
  }
  __syncthreads();
  if (nb <= 1) return;
  for (int j = threadIdx.x; j < J; j += blockDim.x)
    fl_scan_totals(tot + j, nb, J);
  __syncthreads();
  for (int l = threadIdx.x / J, j = threadIdx.x % J; l < B;
       fl_step(l, j, dr, dc, J)) {
    const int k = l >> 4;
    T[l * J + j] = __fadd_rn(T[l * J + j], k ? tot[(k - 1) * J + j] : 0.0f);
  }
  __syncthreads();
}

__device__ __forceinline__ bool fl_live(int l, int B) {
  return l >= 0 && l < B;
}

// block-wide sum of one int a thread (every thread calls it)
__device__ int fl_block_sum(int v, int* s_w) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < FL_WARPS; ++w) t += s_w[w];
  __syncthreads();
  return t;
}

// ---- 0. zeros: the node outputs (a tile with a live pod overwrites its
// cells), in 16-byte stores where the region is aligned ----------------------
struct FlZero {
  char* p[5];
  size_t n[5];
};

__global__ void __launch_bounds__(FL_THREADS) fl_zero_kernel(FlZero z) {
  const size_t t = (size_t)blockIdx.x * FL_THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * FL_THREADS;
  for (int r = 0; r < 5; ++r) {
    char* p = z.p[r];
    const size_t n = z.n[r];
    if (!p) continue;
    const size_t a = (16 - ((uintptr_t)p & 15)) & 15;
    const size_t h = a < n ? a : n;
    const size_t n16 = (n - h) / 16;
    float4* q = (float4*)(p + h);
    for (size_t i = t; i < h; i += stride) p[i] = 0;
    for (size_t i = t; i < n16; i += stride)
      q[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (size_t i = h + n16 * 16 + t; i < n; i += stride) p[i] = 0;
  }
}

// ---- 1. live pods per segment of the queue lists; the node tiles that
// hold one, listed once each (the list's order does not matter: each tile
// is summed alone) -------------------------------------------------------
__global__ void __launch_bounds__(FL_THREADS) fl_count_kernel(
    const int* __restrict__ lane, const int* __restrict__ node,
    const int* __restrict__ pods, int M, int B, int TN,
    int* __restrict__ seg_cnt, int* __restrict__ tile_flag,
    int* __restrict__ dense, int* __restrict__ ndense) {
  __shared__ int s_w[FL_WARPS];
  int c = 0;
  for (int i = threadIdx.x; i < FL_SEG; i += FL_THREADS) {
    const int k = blockIdx.x * FL_SEG + i;
    if (k >= M) continue;
    const int m = pods[k];
    if (!fl_live(lane[m], B)) continue;
    ++c;
    const int t = max(node[m], 0) / TN;
    if (atomicExch(tile_flag + t, 1) == 0) dense[atomicAdd(ndense, 1)] = t;
  }
  c = fl_block_sum(c, s_w);
  if (threadIdx.x == 0) seg_cnt[blockIdx.x] = c;
}

// ---- 2. the live pods of the queue lists, compacted in list order -------
// Thread t owns the segment's entries [4t, 4t + 4): a block exclusive scan
// of the per-thread counts gives each live entry its place.  live_off[q]
// is the compacted position of queue_off[q] (the last segment's block also
// takes the offsets equal to M).
__global__ void __launch_bounds__(FL_THREADS) fl_scatter_kernel(
    const int* __restrict__ lane, const int* __restrict__ pods,
    const int* __restrict__ queue_off, int M, int Q, int B,
    const int* __restrict__ seg_cnt, int* __restrict__ live_list,
    int* __restrict__ live_off) {
  constexpr int PER = FL_SEG / FL_THREADS;
  __shared__ int s_w[FL_WARPS];
  __shared__ int s_pre[FL_SEG + 1];
  const int s = blockIdx.x, k0 = s * FL_SEG;
  int b = 0;
  for (int i = threadIdx.x; i < s; i += FL_THREADS) b += seg_cnt[i];
  const int base = fl_block_sum(b, s_w);
  int m[PER];
  bool live[PER];
  int c = 0;
  for (int j = 0; j < PER; ++j) {
    const int k = k0 + threadIdx.x * PER + j;
    m[j] = k < M ? pods[k] : 0;
    live[j] = k < M && fl_live(lane[m[j]], B);
    c += live[j] ? 1 : 0;
  }
  // exclusive scan of the per-thread counts
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (ln >= o) inc += y;
  }
  if (ln == 31) s_w[w] = inc;
  __syncthreads();
  int wbase = 0;
  for (int v = 0; v < w; ++v) wbase += s_w[v];
  int pos = wbase + inc - c;
  for (int j = 0; j < PER; ++j) {
    s_pre[threadIdx.x * PER + j] = pos;
    if (live[j]) live_list[base + pos++] = m[j];
  }
  if (threadIdx.x == FL_THREADS - 1) s_pre[FL_SEG] = pos;
  __syncthreads();
  for (int q = threadIdx.x; q <= Q; q += FL_THREADS) {
    const int p = queue_off[q];
    if (p >= M) {
      if (s == gridDim.x - 1) live_off[q] = base + s_pre[min(FL_SEG, M - k0)];
    } else if (p >= k0 && p < k0 + FL_SEG) {
      live_off[q] = base + s_pre[p - k0];
    }
  }
}

// ---- 3. node tiles and leaf queues ----------------------------------------
__global__ void __launch_bounds__(FL_THREADS) freed_by_lane_kernel(
    const int* __restrict__ lane, const float* __restrict__ req,
    const int* __restrict__ node_off, const int* __restrict__ node_pods,
    const int* __restrict__ live_list, const int* __restrict__ live_off,
    const int* __restrict__ dense, const int* __restrict__ ndense,
    const int* __restrict__ device, const float* __restrict__ held,
    const int* __restrict__ devices_mask, const float* __restrict__ ext,
    int N, int Q, int B, int D, int E, int compose, int TN, int CS,
    int nslab, float* __restrict__ leaf, float* __restrict__ freed_n,
    u8* __restrict__ own_incr, float* __restrict__ freed_d,
    float* __restrict__ freed_e) {
  extern __shared__ float fl_smem[];
  const int nb = (B + 15) / 16;
  if ((int)blockIdx.x < Q) {
    // ---- one block per leaf queue: its live pods, in list order --------
    const int q = blockIdx.x;
    float* A = fl_smem;                           // [B, 3]
    float* tot = A + B * 3;                       // [nb, 3]
    int* s_l = (int*)(tot + nb * 3);              // [FL_QCHUNK]
    float* s_r = (float*)(s_l + FL_QCHUNK);       // [FL_QCHUNK, 3]
    for (int j = threadIdx.x; j < B * 3; j += FL_THREADS) A[j] = 0.0f;
    __syncthreads();
    const int lo = live_off[q], hi = live_off[q + 1];
    for (int c0 = lo; c0 < hi; c0 += FL_QCHUNK) {
      const int len = min(FL_QCHUNK, hi - c0);
      for (int t = threadIdx.x; t < len; t += FL_THREADS) {
        const int m = live_list[c0 + t];
        s_l[t] = lane[m];
        for (int r = 0; r < 3; ++r) s_r[t * 3 + r] = req[(size_t)m * 3 + r];
      }
      __syncthreads();
      for (int j = threadIdx.x; j < B * 3; j += FL_THREADS) {
        const int l = j / 3, r = j - l * 3;
        float acc = A[j];
        for (int t = 0; t < len; ++t)
          if (s_l[t] == l) acc = __fadd_rn(acc, s_r[t * 3 + r]);
        A[j] = acc;
      }
      __syncthreads();
    }
    if (compose) fl_scan_smem(A, tot, B, 3);
    for (int j = threadIdx.x; j < B * 3; j += FL_THREADS) {
      const int l = j / 3, r = j - l * 3;
      leaf[((size_t)l * Q + q) * 3 + r] = A[j];
    }
    return;
  }
  // ---- the (tile of TN nodes, column slab) pairs whose tile holds a live
  // pod, spread over the other blocks ------------------------------------
  const int C = 3 + D + E;
  const int ln = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int work = *ndense * nslab;
  for (int it = blockIdx.x - Q; it < work; it += gridDim.x - Q) {
    const int n0 = dense[it / nslab] * TN, tn = min(TN, N - n0);
    const int c0 = (it % nslab) * CS, CW = min(C, c0 + CS) - c0, J = tn * CW;
    const bool counts = D > 0 && c0 < 3 + D && c0 + CW > 3;
    const int k_lo = node_off[n0], k_hi = node_off[n0 + tn];
    __syncthreads();  // the last pair's reads of the table are done
    float* T = fl_smem;                                   // [B, J]
    int* W = (int*)(T + (size_t)B * J);                   // [B, J] if counts
    float* tot = (float*)(W + (counts ? (size_t)B * J : 0));  // [nb, J]
    int* s_m = (int*)(tot + (size_t)nb * J);              // [FL_THREADS]
    int* s_l = s_m + FL_THREADS;                          // [FL_THREADS]
    int* s_t = s_l + FL_THREADS;                          // [FL_THREADS]
    int* s_off = s_t + FL_THREADS;                  // [FL_TILE_NODES + 1]
    int* s_w = s_off + FL_TILE_NODES + 1;                 // [FL_WARPS + 1]
    int* s_tab = s_w + FL_WARPS + 1;                      // [J]
    int* s_dst = s_tab + J;                               // [J]
    const int dr = FL_THREADS / J, dc = FL_THREADS % J;
    for (int x = threadIdx.x; x < B * J; x += FL_THREADS) {
      T[x] = 0.0f;
      if (counts) W[x] = 0;
    }
    for (int t = threadIdx.x; t <= tn; t += FL_THREADS)
      s_off[t] = node_off[n0 + t];
    // cell column j = (node t, column c): its table (0 nodes, 1 devices,
    // 2 extended) and its offset in a lane's rows of that table
    for (int j = threadIdx.x; j < J; j += FL_THREADS) {
      const int t = j / CW, c = c0 + (j - t * CW);
      const int tb = c < 3 ? 0 : c < 3 + D ? 1 : 2;
      const int CX = tb == 0 ? 3 : tb == 1 ? D : E;
      s_tab[j] = tb;
      s_dst[j] = (n0 + t) * CX + (c - (tb == 0 ? 0 : tb == 1 ? 3 : 3 + D));
    }
    __syncthreads();
    for (int k_base = k_lo; k_base < k_hi; k_base += FL_THREADS) {
      // compact this step's live pods in list order
      const int k = k_base + threadIdx.x;
      int m = 0, l = -1;
      if (k < k_hi) {
        m = node_pods[k];
        l = lane[m];
      }
      const bool live = k < k_hi && fl_live(l, B);
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      if (ln == 0) s_w[w] = __popc(bal);
      __syncthreads();
      int before = 0, cnt = 0;
      for (int v = 0; v < FL_WARPS; ++v) {
        before += v < w ? s_w[v] : 0;
        cnt += s_w[v];
      }
      if (live) {
        const int i = before + __popc(bal & ((1u << ln) - 1u));
        int t = 0;  // the node of entry k: the last t with s_off[t] <= k
        for (int step = FL_TILE_NODES; step; step >>= 1)
          if (t + step < tn && s_off[t + step] <= k) t += step;
        s_m[i] = m;
        s_l[i] = l;
        s_t[i] = t;
      }
      __syncthreads();
      // each (node, column) cell stream adds its node's pods in order
      for (int j = threadIdx.x; j < J; j += FL_THREADS) {
        const int t = j / CW, c = c0 + (j - t * CW);
        for (int i = 0; i < cnt; ++i) {
          if (s_t[i] != t) continue;
          const int p = s_m[i];
          float* cell = T + (size_t)s_l[i] * J + j;
          if (c < 3) {
            *cell = __fadd_rn(*cell, req[(size_t)p * 3 + c]);
          } else if (c < 3 + D) {
            const int d = c - 3, dv = device[p];
            if (dv == d)
              *cell = __fadd_rn(*cell, held[p]);
            else if (dv < 0 && ((devices_mask[p] >> d) & 1))
              ++W[(size_t)s_l[i] * J + j];
          } else {
            *cell = __fadd_rn(*cell, ext[(size_t)p * E + (c - 3 - D)]);
          }
        }
      }
      __syncthreads();
    }
    // the whole-device counts after the shares; own_incr before the prefix
    if (counts)
      for (int l = threadIdx.x / J, j = threadIdx.x % J; l < B;
           fl_step(l, j, dr, dc, J))
        if (W[l * J + j])
          T[l * J + j] = __fadd_rn(T[l * J + j], (float)W[l * J + j]);
    if (c0 == 0)
      for (int x = threadIdx.x; x < B * tn; x += FL_THREADS) {
        const int l = x / tn, t = x - l * tn;
        const float* o = T + (size_t)l * J + t * CW;
        own_incr[(size_t)l * N + n0 + t] =
            __fadd_rn(__fadd_rn(o[0], o[1]), o[2]) > KAI_EPS ? 1 : 0;
      }
    __syncthreads();
    if (compose) fl_scan_smem(T, tot, B, J);
    for (int l = threadIdx.x / J, j = threadIdx.x % J; l < B;
         fl_step(l, j, dr, dc, J)) {
      const int tb = s_tab[j];
      float* X = tb == 0 ? freed_n : tb == 1 ? freed_d : freed_e;
      const int CX = tb == 0 ? 3 : tb == 1 ? D : E;
      X[(size_t)l * N * CX + s_dst[j]] = T[l * J + j];
    }
  }
}

// ---- 4. the chain roll-up ---------------------------------------------------
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

// the card's SMs, read once
static int fl_sms() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// a node tile's shared memory: the [B, J] table, the integer counts when
// the slab holds device columns, the block totals, the fixed part
static size_t fl_tile_bytes(int B, int J, bool counts) {
  const size_t nb = (B + 15) / 16;
  return (size_t)B * J * 4 * (counts ? 2 : 1) + nb * J * 4 + FL_TILE_FIXED;
}

// `leaf` is a [B, Q, 3] scratch and `scratch` holds max(1, ceil(M /
// FL_SEG)) + Q + 1 + M + 2 N + 1 ints (segment counts, compacted queue
// offsets, compacted pods, tile flags, the list of tiles with a live pod
// and its length); every output is written in full.  A null `freed_d`
// builds no device table (`device`, `held`, `devices_mask` may then be
// null too); a null `freed_e` no extended table (`ext` may then be null).
KAI_EXPORT int kai_freed_by_lane(
    const int* lane, const int* node, const float* req, const int* node_off,
    const int* node_pods, const int* queue_off, const int* queue_pods,
    const u8* chain, const int* device, const float* held,
    const int* devices_mask, const float* ext, int N, int R, int Q, int B,
    int D, int E, int M, int compose, float* leaf, int* scratch,
    float* freed_n, float* freed_q, u8* own_incr, float* freed_d,
    float* freed_e, cudaStream_t stream) {
  if (N < 1 || R != 3 || Q < 1 || B < 1 || B > FL_MAX_LANES || M < 0)
    return KAI_ERR_ARGS;
  if (freed_d && (D < 1 || D > FL_MAX_D || !device || !held || !devices_mask))
    return KAI_ERR_ARGS;
  if (freed_e && (E < 1 || E > FL_MAX_E || !ext)) return KAI_ERR_ARGS;
  const int Dd = freed_d ? D : 0, Ee = freed_e ? E : 0, C = 3 + Dd + Ee;
  // the widest node tile of at most FL_TILE_NODES whose table fits two
  // blocks an SM; else one node a tile and its columns in slabs
  int TN = 0, CS = C;
  for (int tn = std::min(FL_TILE_NODES, N); tn >= 1 && !TN; --tn)
    if (fl_tile_bytes(B, tn * C, Dd > 0) <= FL_TILE_SMEM) TN = tn;
  if (!TN) {
    TN = 1;
    while (CS > 3 && fl_tile_bytes(B, CS, Dd > 0) > FL_SLAB_SMEM) --CS;
  }
  const int nslab = (C + CS - 1) / CS;
  const int nb = (B + 15) / 16;
  const size_t q_bytes = (size_t)(B + nb) * 3 * 4 + FL_QCHUNK * 16;
  const size_t smem = std::max(q_bytes, fl_tile_bytes(B, TN * CS, Dd > 0));
  if (smem > FL_SLAB_SMEM + 8 * 1024) return KAI_ERR_ARGS;
  static size_t smem_set = 0;  // the attribute only grows
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        freed_by_lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const int nseg = std::max(1, (M + FL_SEG - 1) / FL_SEG);
  const int tiles = (N + TN - 1) / TN;
  int* seg_cnt = scratch;
  int* live_off = seg_cnt + nseg;
  int* live_list = live_off + Q + 1;
  int* tile_flag = live_list + M;
  int* dense = tile_flag + tiles;
  int* ndense = dense + tiles;
  FlZero z = {{(char*)freed_n, (char*)own_incr, (char*)freed_d,
               (char*)freed_e, (char*)tile_flag},
              {(size_t)B * N * 3 * 4, (size_t)B * N, (size_t)B * N * Dd * 4,
               (size_t)B * N * Ee * 4, (size_t)(2 * tiles + 1) * 4}};
  fl_zero_kernel<<<4 * fl_sms(), FL_THREADS, 0, stream>>>(z);
  fl_count_kernel<<<nseg, FL_THREADS, 0, stream>>>(
      lane, node, queue_pods, M, B, TN, seg_cnt, tile_flag, dense, ndense);
  fl_scatter_kernel<<<nseg, FL_THREADS, 0, stream>>>(
      lane, queue_pods, queue_off, M, Q, B, seg_cnt, live_list, live_off);
  // the tiles with a live pod are few: two blocks an SM walk the list
  const int node_blocks = std::min(tiles * nslab, 2 * fl_sms());
  freed_by_lane_kernel<<<Q + node_blocks, FL_THREADS, smem, stream>>>(
      lane, req, node_off, node_pods, live_list, live_off, dense, ndense,
      device, held, devices_mask, ext, N, Q, B, Dd, Ee, compose, TN, CS,
      nslab, leaf, freed_n, own_incr, freed_d, freed_e);
  const size_t total = (size_t)B * Q * 3;
  freed_by_lane_rollup_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                stream>>>(leaf, chain, Q, B, freed_q);
  return static_cast<int>(cudaGetLastError());
}
