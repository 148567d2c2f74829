// K10 dense_accept — the dense accept prefix of an allocate chunk and its
// weighted commit.
//
// Replaces kai_scheduler_tpu/ops/allocate.py:1730-1777 (the dense prefix
// test on the node, bind-now, device and device bind-now pools, the
// reference's `jnp.cumsum(axis=0)` over [B, N, R] and [B, N, D] lane deltas)
// and the commit :1779-1795 (`free - einsum(w, d_free)`, the same for the
// device pool, `qa + einsum(w, d_qa)` and `qan`).
//
// The lanes' claims come as K9's rows: for each lane, the final pools of the
// nodes it placed on.  Lane b's delta at node n is `free[n] - row` where b
// touched n and zero elsewhere, so a node's cumulative claim changes only at
// the lanes that touched it.  Two launches:
//   1. `accept_check`: one thread per (lane, slot) entry, the first slot of
//      its node in its lane, walks the lanes 0..b that touched the same node
//      and sums their deltas in XLA:CPU's cumsum order (blocks of 16 lanes
//      each summed left to right from +0.0, the block totals likewise, each
//      block's exclusive prefix added last), then tests lane b's
//      cumulative claim; a failing lane lowers `first_bad` (atomicMin: the
//      minimum is order-free).  The tests are monotone in the lane, so the
//      first failing lane is a lane that touched the node.  A grid-stride
//      pass over every node also tests the zero claim (`free - 0 >= floor`),
//      which holds for every lane or none.
//   2. `commit`: take = ok & gate_ok & (lane < first_bad); the lowest taken
//      lane at a node sums the taken lanes' deltas there in ascending lane
//      order from +0.0 and writes `free - sum` (and the device row); block 0
//      commits the queue tables the same way.
// The [B, N, R] and [B, N, D] cumulatives (82 MB each at 256 lanes x 10,000
// nodes x 8 devices) are never built.
//
// Bound: bytes — the rows and pools of the touched nodes, read once; the
// lane walk is (B T)^2 / 2 integer compares on shared memory at most.
#include "kai_common.cuh"

#define DA_THREADS 256
#define DA_MAXD 32
#define DA_BLOCK 16  // XLA:CPU's cumsum block

// slot of node n in lane b (its first), or -1
__device__ __forceinline__ int da_slot(const int* s_nodes, int b, int T,
                                       int n) {
  for (int t = 0; t < T; ++t)
    if (s_nodes[b * T + t] == n) return t;
  return -1;
}

__global__ void __launch_bounds__(DA_THREADS) accept_check_kernel(
    const int* __restrict__ nodes_b, const u8* __restrict__ ok,
    const float* __restrict__ free_rows, const float* __restrict__ dev_rows,
    const float* __restrict__ bind_rows,
    const float* __restrict__ devbind_rows, const float* __restrict__ free_,
    const float* __restrict__ dev, const float* __restrict__ rel_floor,
    const float* __restrict__ dev_floor, int B, int T, int N, int D,
    int track, int* __restrict__ first_bad) {
  extern __shared__ int s_nodes[];  // [B * T], -1 where the lane failed
  for (int i = threadIdx.x; i < B * T; i += blockDim.x)
    s_nodes[i] = ok[i / T] ? nodes_b[i] : -1;
  __syncthreads();
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;

  // the zero claim: every node (and device) must sit on or above its floor
  bool zero_bad = false;
  for (int i = gid; i < N * 3; i += stride)
    zero_bad = zero_bad || !(free_[i] >= rel_floor[i]);
  if (track)
    for (int i = gid; i < N * D; i += stride)
      zero_bad = zero_bad || !(dev[i] >= dev_floor[i]);
  if (zero_bad) atomicMin(first_bad, 0);

  for (int e = gid; e < B * T; e += stride) {
    const int b = e / T, t = e % T;
    const int n = s_nodes[e];
    if (n < 0 || da_slot(s_nodes, b, T, n) != t) continue;
    float excl_f[3] = {0.0f, 0.0f, 0.0f}, inb_f[3] = {0.0f, 0.0f, 0.0f};
    float excl_b[3] = {0.0f, 0.0f, 0.0f}, inb_b[3] = {0.0f, 0.0f, 0.0f};
    float excl_d[DA_MAXD], inb_d[DA_MAXD], excl_db[DA_MAXD], inb_db[DA_MAXD];
    for (int d = 0; d < D; ++d)
      excl_d[d] = inb_d[d] = excl_db[d] = inb_db[d] = 0.0f;
    int blk = 0;
    for (int c = 0; c <= b; ++c) {
      const int s = da_slot(s_nodes, c, T, n);
      if (s < 0) continue;
      if (c / DA_BLOCK != blk) {  // fold the finished block's total
        blk = c / DA_BLOCK;
        for (int r = 0; r < 3; ++r) {
          excl_f[r] = __fadd_rn(excl_f[r], inb_f[r]);
          excl_b[r] = __fadd_rn(excl_b[r], inb_b[r]);
          inb_f[r] = inb_b[r] = 0.0f;
        }
        if (track)
          for (int d = 0; d < D; ++d) {
            excl_d[d] = __fadd_rn(excl_d[d], inb_d[d]);
            excl_db[d] = __fadd_rn(excl_db[d], inb_db[d]);
            inb_d[d] = inb_db[d] = 0.0f;
          }
      }
      const size_t o = (size_t)c * T + s;
      for (int r = 0; r < 3; ++r) {
        inb_f[r] = __fadd_rn(inb_f[r],
                             __fsub_rn(free_[n * 3 + r], free_rows[o * 3 + r]));
        inb_b[r] = __fadd_rn(inb_b[r], bind_rows[o * 3 + r]);
      }
      if (track)
        for (int d = 0; d < D; ++d) {
          inb_d[d] = __fadd_rn(inb_d[d], __fsub_rn(dev[(size_t)n * D + d],
                                                   dev_rows[o * D + d]));
          inb_db[d] = __fadd_rn(inb_db[d], devbind_rows[o * D + d]);
        }
    }
    // lane b's cumulative claim: the block's inner sum plus its exclusive
    // prefix (+0.0 for the first block)
    bool bad = false;
    for (int r = 0; r < 3; ++r) {
      const float fr = free_[n * 3 + r];
      const float cf = __fadd_rn(inb_f[r], excl_f[r]);
      const float cb = __fadd_rn(inb_b[r], excl_b[r]);
      bad = bad || !(__fsub_rn(fr, cf) >= rel_floor[n * 3 + r]);
      bad = bad || !(cb <= __fadd_rn(fmaxf(fr, 0.0f), KAI_EPS));
    }
    if (track)
      for (int d = 0; d < D; ++d) {
        const float dv = dev[(size_t)n * D + d];
        const float cd = __fadd_rn(inb_d[d], excl_d[d]);
        const float cdb = __fadd_rn(inb_db[d], excl_db[d]);
        bad = bad || !(__fsub_rn(dv, cd) >= dev_floor[(size_t)n * D + d]);
        bad = bad || !(cdb <= __fadd_rn(fmaxf(dv, 0.0f), KAI_EPS));
      }
    if (bad) atomicMin(first_bad, b);
  }
}

__global__ void __launch_bounds__(DA_THREADS) commit_kernel(
    const int* __restrict__ nodes_b, const u8* __restrict__ ok,
    const u8* __restrict__ gate_ok, const float* __restrict__ free_rows,
    const float* __restrict__ dev_rows, const float* __restrict__ free_,
    const float* __restrict__ dev, const float* __restrict__ d_qa,
    const float* __restrict__ d_qan, const float* __restrict__ qa,
    const float* __restrict__ qan, int B, int T, int D, int Q, int track,
    const int* __restrict__ first_bad, u8* __restrict__ take,
    float* __restrict__ free2, float* __restrict__ dev2,
    float* __restrict__ qa2, float* __restrict__ qan2) {
  extern __shared__ int s_nodes[];  // [B * T], -1 where the lane is not taken
  const int fb = *first_bad;
  for (int i = threadIdx.x; i < B * T; i += blockDim.x) {
    const int b = i / T;
    s_nodes[i] = (ok[b] && gate_ok[b] && b < fb) ? nodes_b[i] : -1;
  }
  __syncthreads();
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  if (blockIdx.x == 0) {
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      take[b] = (ok[b] && gate_ok[b] && b < fb) ? 1 : 0;
    for (int i = threadIdx.x; i < Q * 3; i += blockDim.x) {
      float s = 0.0f, sn = 0.0f;
      for (int b = 0; b < B; ++b)
        if (ok[b] && gate_ok[b] && b < fb) {
          s = __fadd_rn(s, d_qa[(size_t)b * Q * 3 + i]);
          sn = __fadd_rn(sn, d_qan[(size_t)b * Q * 3 + i]);
        }
      qa2[i] = __fadd_rn(qa[i], s);
      qan2[i] = __fadd_rn(qan[i], sn);
    }
  }
  for (int e = gid; e < B * T; e += stride) {
    const int b = e / T, t = e % T;
    const int n = s_nodes[e];
    if (n < 0 || da_slot(s_nodes, b, T, n) != t) continue;
    bool owner = true;  // the lowest taken lane at this node commits it
    for (int c = 0; c < b && owner; ++c) owner = da_slot(s_nodes, c, T, n) < 0;
    if (!owner) continue;
    float sf[3] = {0.0f, 0.0f, 0.0f}, sd[DA_MAXD];
    for (int d = 0; d < D; ++d) sd[d] = 0.0f;
    for (int c = b; c < B; ++c) {
      const int s = da_slot(s_nodes, c, T, n);
      if (s < 0) continue;
      const size_t o = (size_t)c * T + s;
      for (int r = 0; r < 3; ++r)
        sf[r] = __fadd_rn(sf[r],
                          __fsub_rn(free_[n * 3 + r], free_rows[o * 3 + r]));
      if (track)
        for (int d = 0; d < D; ++d)
          sd[d] = __fadd_rn(sd[d], __fsub_rn(dev[(size_t)n * D + d],
                                             dev_rows[o * D + d]));
    }
    for (int r = 0; r < 3; ++r)
      free2[n * 3 + r] = __fsub_rn(free_[n * 3 + r], sf[r]);
    if (track)
      for (int d = 0; d < D; ++d)
        dev2[(size_t)n * D + d] = __fsub_rn(dev[(size_t)n * D + d], sd[d]);
  }
}

KAI_EXPORT int kai_dense_accept(
    const int* nodes_b, const u8* ok, const u8* gate_ok,
    const float* free_rows, const float* dev_rows, const float* bind_rows,
    const float* devbind_rows, const float* free_, const float* dev,
    const float* rel_floor, const float* dev_floor, const float* d_qa,
    const float* d_qan, const float* qa, const float* qan, int B, int T,
    int N, int D, int Q, int track, int* first_bad, u8* take, float* free2,
    float* dev2, float* qa2, float* qan2, cudaStream_t stream) {
  if (B < 1 || B > 16 * DA_BLOCK || T < 1 || N < 1 || D < 0 || D > DA_MAXD ||
      Q < 1)
    return KAI_ERR_ARGS;
  const size_t smem = (size_t)B * T * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        accept_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(commit_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int work = B * T > N ? B * T : N;
  const int blocks = (work + DA_THREADS - 1) / DA_THREADS;
  accept_check_kernel<<<blocks, DA_THREADS, smem, stream>>>(
      nodes_b, ok, free_rows, dev_rows, bind_rows, devbind_rows, free_, dev,
      rel_floor, dev_floor, B, T, N, D, track, first_bad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cblocks = (B * T + DA_THREADS - 1) / DA_THREADS;
  commit_kernel<<<cblocks, DA_THREADS, smem, stream>>>(
      nodes_b, ok, gate_ok, free_rows, dev_rows, free_, dev, d_qa, d_qan, qa,
      qan, B, T, D, Q, track, first_bad, take, free2, dev2, qa2, qan2);
  return static_cast<int>(cudaGetLastError());
}
