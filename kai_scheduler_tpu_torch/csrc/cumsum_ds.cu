// K5 cumsum_ds — compensated (double-single) prefix sum along axis 0.
//
// Replaces kai_scheduler_tpu/utils/numerics.py:30 `cumsum_ds`, which the
// victim solver runs over its [U, R] and [U, Q*R] per-unit tables
// (ops/victims.py:848, :861, :1083, :1090, :1106, :1199; U = the padded
// running-pod count).
//
// The reference is jax.lax.associative_scan with a two-sum combine; its
// bits depend on that function's recursion tree:
//   up:   level l+1 [i] = combine(level l [2i], level l [2i+1]),
//         for i < floor(n_l / 2), until a level holds < 2 elements;
//   down: result_l[2i+1] = result_{l+1}[i];
//         result_l[2i]   = combine(result_{l+1}[i-1], level l [2i]) (i >= 1);
//         result_l[0]    = level l [0].
// combine((sa, ea), (sb, eb)) = (s, (e + ea) + eb) with (s, e) the
// two-sum of sa and sb.  The output is s + e.  Level 0 is the input with
// e = +0.0.
//
// Element j of level l exists iff (j+1) 2^l <= U and covers rows
// [j 2^l, (j+1) 2^l).  An existing result reads only existing elements, so
// the tree may be run on a zero-padded power of two: the padding's values
// never reach an existing row.  A chunk of 256 consecutive elements is a
// subtree (levels 0..8 over it); the first even element of a chunk at every
// level below 8 combines the previous chunk's level-8 result (the last
// element of a full chunk at each of those levels is odd and inherits it).
// So the scan splits into
//   phase 1: each 256-row tile's up-sweep to its root (level 8);
//   phase 2: the same recursion over the n8 = floor(U / 256) tile roots,
//            in chunks of 256 again (roots of roots above 65,536 rows);
//   phase 3: each tile's up-sweep again and its down-sweep, seeded by its
//            root's result and the previous tile's.
// One warp runs one chunk of one column: a lane holds 8 consecutive rows,
// levels 1..3 in registers, levels 4..8 through lane shuffles (every lane
// of a subtree computes its combine, with the same operands in the same
// order).
//
// Layout: a block of 8 warps loads a [rows x columns] tile of the
// row-major input with coalesced loads into shared memory (8 columns of one
// 256-row tile, or fewer columns of several tiles when C < 8), each warp
// reads its column's rows from there, and phase 3 writes s + e back the
// same way.  Phase 1 (`cumsum_ds_tiles_kernel`) writes each full tile's
// root to a scratch; the last of a column group's blocks (an atomic ticket)
// runs phase 2 over that group's columns and resets its ticket.  Phase 3
// (`cumsum_ds_kernel`) is the second launch; below 256 rows it is the only
// one.  Every + and - of the combine is kept as written: --fmad=false, no
// reassociation.
// Bound: bytes (each element read once and written once; ~20 flops each).
// This design reads the input twice (phases 1 and 3) and the roots' scratch
// is U / 256 pairs a column.
#include "kai_common.cuh"

#define CS_WARPS 8
#define CS_THREADS (CS_WARPS * 32)
#define CS_CHUNK 256
// shared tile: 8 columns of 256 rows, or 1 column of 8 x 256 rows (+4 pad
// floats a column, 16-byte aligned rows)
#define CS_SMEM (CS_WARPS * (CS_CHUNK + 4))
// tile elements a thread loads and stores (8 warps' chunks of 256)
#define CS_PER_THREAD (CS_WARPS * CS_CHUNK / CS_THREADS)
#define CS_MAX_LEVELS 4

struct DS {
  float s, e;
};

__device__ __forceinline__ DS cs_combine(DS a, DS b) {
  const float s = __fadd_rn(a.s, b.s);
  const float bb = __fsub_rn(s, a.s);
  const float err =
      __fadd_rn(__fsub_rn(a.s, __fsub_rn(s, bb)), __fsub_rn(b.s, bb));
  return DS{s, __fadd_rn(__fadd_rn(err, a.e), b.e)};
}

__device__ __forceinline__ DS cs_shfl_xor(DS v, int m) {
  return DS{__shfl_xor_sync(0xffffffffu, v.s, m),
            __shfl_xor_sync(0xffffffffu, v.e, m)};
}

// The up-sweep of a warp's chunk: lane `lane` holds elements 8 lane .. +7
// in v.  a: level 1, b: level 2, up[m]: the level-(3+m) element holding
// this lane (up[5] the chunk's root, the same in every lane).
struct CsTree {
  DS a[4], b[2], up[6];
};

__device__ __forceinline__ void cs_up(const DS v[8], CsTree& t, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) t.a[i] = cs_combine(v[2 * i], v[2 * i + 1]);
  t.b[0] = cs_combine(t.a[0], t.a[1]);
  t.b[1] = cs_combine(t.a[2], t.a[3]);
  t.up[0] = cs_combine(t.b[0], t.b[1]);
#pragma unroll
  for (int m = 1; m < 6; ++m) {
    const int half = 1 << (m - 1);
    const DS own = t.up[m - 1];
    const DS oth = cs_shfl_xor(own, half);
    t.up[m] = (lane & half) ? cs_combine(oth, own) : cs_combine(own, oth);
  }
}

// The down-sweep: r is the root's result, x the result just before the
// chunk (hx: there is one).  A node hands its even child (x, combine(x,
// child)) and its odd child (the even child's result, its own result).
__device__ __forceinline__ void cs_down(const DS v[8], const CsTree& t,
                                        int lane, DS r, DS x, bool hx,
                                        DS out[8]) {
#pragma unroll
  for (int m = 5; m >= 1; --m) {
    const int half = 1 << (m - 1);
    const DS own = t.up[m - 1];
    const DS oth = cs_shfl_xor(own, half);
    const bool right = (lane & half) != 0;
    const DS left = right ? oth : own;
    const DS re = hx ? cs_combine(x, left) : left;
    if (right) {
      x = re;
      hx = true;
    } else {
      r = re;
    }
  }
  // level 3 (r, x, hx) -> level 2 b0 (rb0, x, hx), b1 (r, rb0)
  const DS rb0 = hx ? cs_combine(x, t.b[0]) : t.b[0];
  // level 1: a0 (ra0, x, hx), a1 (rb0, ra0), a2 (ra2, rb0), a3 (r, ra2)
  const DS ra0 = hx ? cs_combine(x, t.a[0]) : t.a[0];
  const DS ra2 = cs_combine(rb0, t.a[2]);
  out[0] = hx ? cs_combine(x, v[0]) : v[0];
  out[1] = ra0;
  out[2] = cs_combine(ra0, v[2]);
  out[3] = rb0;
  out[4] = cs_combine(rb0, v[4]);
  out[5] = ra2;
  out[6] = cs_combine(ra2, v[6]);
  out[7] = r;
}

// The shape of a launch: column groups of CG columns, blocks of S tiles
// (S x CG <= 8 warps).
struct CsShape {
  int U, C, CG, S, tiles, n8;
};

__device__ __forceinline__ CsShape cs_shape(int U, int C) {
  CsShape p;
  p.U = U;
  p.C = C;
  p.CG = C < CS_WARPS ? C : CS_WARPS;
  p.S = CS_WARPS / p.CG;
  p.tiles = (U + CS_CHUNK - 1) / CS_CHUNK;
  p.n8 = U / CS_CHUNK;
  return p;
}

// Row and column of element i of a block's [rows x Cb] tile: a multiply
// by 1 / Cb in f32 (exact below 2^12 elements and 8 columns: the quotient's
// fraction stays >= 1/16 from an integer), no integer division.
__device__ __forceinline__ void cs_rc(int i, int Cb, float inv, int* r,
                                      int* c) {
  *r = __float2int_rz(__fmul_rn(__fadd_rn((float)i, 0.5f), inv));
  *c = i - *r * Cb;
}

// Loads the block's [S 256 rows, Cb columns] tile into sm[col][row]
// (zero past U); returns the block's column count Cb.  Each thread issues
// its (at most 8) loads before it stores any.
__device__ __forceinline__ int cs_load_tile(const float* __restrict__ x,
                                            const CsShape& p, float* sm) {
  const int c0 = blockIdx.y * p.CG;
  const int Cb = min(p.CG, p.C - c0);
  const float inv = 1.0f / (float)Cb;
  const int RB = p.S * CS_CHUNK;
  const long long row0 = (long long)blockIdx.x * RB;
  float val[CS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < CS_PER_THREAD; ++k) {
    const int i = threadIdx.x + k * CS_THREADS;
    int r, c;
    cs_rc(i, Cb, inv, &r, &c);
    const long long gr = row0 + r;
    val[k] = i < RB * Cb && gr < p.U ? x[(size_t)gr * p.C + c0 + c] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < CS_PER_THREAD; ++k) {
    const int i = threadIdx.x + k * CS_THREADS;
    int r, c;
    cs_rc(i, Cb, inv, &r, &c);
    if (i < RB * Cb) sm[c * (RB + 4) + r] = val[k];
  }
  return Cb;
}

// Writes the block's tile of s + e from sm[col][row] to out (rows < U).
__device__ __forceinline__ void cs_store_tile(const CsShape& p, int Cb,
                                              const float* sm,
                                              float* __restrict__ out) {
  const int c0 = blockIdx.y * p.CG;
  const float inv = 1.0f / (float)Cb;
  const int RB = p.S * CS_CHUNK;
  const long long row0 = (long long)blockIdx.x * RB;
#pragma unroll
  for (int k = 0; k < CS_PER_THREAD; ++k) {
    const int i = threadIdx.x + k * CS_THREADS;
    int r, c;
    cs_rc(i, Cb, inv, &r, &c);
    const long long gr = row0 + r;
    if (i < RB * Cb && gr < p.U)
      out[(size_t)gr * p.C + c0 + c] = sm[c * (RB + 4) + r];
  }
}

// This warp's chunk of the tile: its tile index (or -1 when idle), column
// and the 8 values of its lane from shared memory.
__device__ __forceinline__ int cs_warp_tile(const CsShape& p, int Cb,
                                            const float* sm, int warp,
                                            int lane, int* col, DS v[8]) {
  const int tl = warp / p.CG, cc = warp - tl * p.CG;
  const int tile = blockIdx.x * p.S + tl;
  if (tl >= p.S || cc >= Cb || tile >= p.tiles) return -1;
  *col = blockIdx.y * p.CG + cc;
  const float4* src = reinterpret_cast<const float4*>(
      sm + cc * (p.S * CS_CHUNK + 4) + tl * CS_CHUNK + 8 * lane);
  const float4 lo = src[0], hi = src[1];
  v[0] = DS{lo.x, 0.0f};
  v[1] = DS{lo.y, 0.0f};
  v[2] = DS{lo.z, 0.0f};
  v[3] = DS{lo.w, 0.0f};
  v[4] = DS{hi.x, 0.0f};
  v[5] = DS{hi.y, 0.0f};
  v[6] = DS{hi.z, 0.0f};
  v[7] = DS{hi.w, 0.0f};
  return tile;
}

// The warp's down-sweep seeded by its tile's root result and the previous
// tile's (phase 2's results), its lane's 8 results written back to sm as
// s + e.
__device__ __forceinline__ void cs_finish_tile(const CsShape& p,
                                               const float2* lv, int tile,
                                               int col, const DS v[8],
                                               const CsTree& t, float* sm,
                                               int warp, int lane) {
  DS r = DS{0.0f, 0.0f}, xs = DS{0.0f, 0.0f};
  const float2* roots = lv + (size_t)col * p.n8;
  if (tile < p.n8) {
    const float2 w = __ldcg(roots + tile);
    r = DS{w.x, w.y};
  }
  if (tile > 0) {
    const float2 w = __ldcg(roots + tile - 1);
    xs = DS{w.x, w.y};
  }
  DS o[8];
  cs_down(v, t, lane, r, xs, tile > 0, o);
  const int tl = warp / p.CG, cc = warp - tl * p.CG;
  float4* dst = reinterpret_cast<float4*>(
      sm + cc * (p.S * CS_CHUNK + 4) + tl * CS_CHUNK + 8 * lane);
  dst[0] = make_float4(__fadd_rn(o[0].s, o[0].e), __fadd_rn(o[1].s, o[1].e),
                       __fadd_rn(o[2].s, o[2].e), __fadd_rn(o[3].s, o[3].e));
  dst[1] = make_float4(__fadd_rn(o[4].s, o[4].e), __fadd_rn(o[5].s, o[5].e),
                       __fadd_rn(o[6].s, o[6].e), __fadd_rn(o[7].s, o[7].e));
}

// Phase 2 over the tile roots of columns [c0, c0 + Cb), by one block: the
// roots' levels live in `lv` (level i: [C, n_i] pairs, column-major), each
// full chunk of a level's roots is one element of the next, until a level
// fits one chunk.  Results overwrite the elements in place.
__device__ void cs_roots(float2* lv, int C, int n8, int c0, int Cb) {
  int n[CS_MAX_LEVELS];
  size_t off[CS_MAX_LEVELS];
  int top = 0;
  n[0] = n8;
  off[0] = 0;
  while (n[top] > CS_CHUNK && top + 1 < CS_MAX_LEVELS) {
    n[top + 1] = n[top] / CS_CHUNK;
    off[top + 1] = off[top] + (size_t)C * n[top];
    ++top;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // up: each full chunk's root becomes an element of the next level
  for (int i = 0; i < top; ++i) {
    const int chunks = n[i] / CS_CHUNK;
    for (int u = warp; u < chunks * Cb; u += CS_WARPS) {
      const int c = c0 + u % Cb, ch = u / Cb;
      const float2* src = lv + off[i] + (size_t)c * n[i] + ch * CS_CHUNK;
      DS v[8];
      CsTree t;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float2 w = __ldcg(src + 8 * lane + q);
        v[q] = DS{w.x, w.y};
      }
      cs_up(v, t, lane);
      if (lane == 0)
        lv[off[i + 1] + (size_t)c * n[i + 1] + ch] =
            make_float2(t.up[5].s, t.up[5].e);
    }
    __syncthreads();
  }
  // down: the top level in one chunk, then each level below seeded by the
  // results of the level above
  for (int i = top; i >= 0; --i) {
    const int chunks = (n[i] + CS_CHUNK - 1) / CS_CHUNK;
    for (int u = warp; u < chunks * Cb; u += CS_WARPS) {
      const int c = c0 + u % Cb, ch = u / Cb;
      float2* col = lv + off[i] + (size_t)c * n[i];
      DS v[8], out[8];
      CsTree t;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = ch * CS_CHUNK + 8 * lane + q;
        const float2 w = j < n[i] ? __ldcg(col + j) : make_float2(0.f, 0.f);
        v[q] = DS{w.x, w.y};
      }
      cs_up(v, t, lane);
      DS r = t.up[5], x = DS{0.0f, 0.0f};
      bool hx = false;
      if (i < top) {
        const float2* above = lv + off[i + 1] + (size_t)c * n[i + 1];
        if (ch < n[i + 1]) {
          const float2 w = __ldcg(above + ch);
          r = DS{w.x, w.y};
        }
        if (ch > 0) {
          const float2 w = __ldcg(above + ch - 1);
          x = DS{w.x, w.y};
          hx = true;
        }
      }
      cs_down(v, t, lane, r, x, hx, out);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = ch * CS_CHUNK + 8 * lane + q;
        if (j < n[i]) col[j] = make_float2(out[q].s, out[q].e);
      }
    }
    __syncthreads();
  }
}

// Phases 1 and 2 (the first of two launches): the block's tile loaded,
// each warp's up-sweep, each full tile's root in lv, the group's ticket
// taken; the group's last block runs phase 2 and resets the ticket.
__global__ void __launch_bounds__(CS_THREADS) cumsum_ds_tiles_kernel(
    const float* __restrict__ x, int U, int C, float2* __restrict__ lv,
    unsigned* __restrict__ tickets) {
  __shared__ __align__(16) float sm[CS_SMEM];
  __shared__ bool last;
  const CsShape p = cs_shape(U, C);
  const int Cb = cs_load_tile(x, p, sm);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int col;
  DS v[8];
  const int tile = cs_warp_tile(p, Cb, sm, warp, lane, &col, v);
  if (tile >= 0) {
    CsTree t;
    cs_up(v, t, lane);
    if (lane == 0 && tile < p.n8)
      lv[(size_t)col * p.n8 + tile] = make_float2(t.up[5].s, t.up[5].e);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[blockIdx.y], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  cs_roots(lv, p.C, p.n8, blockIdx.y * p.CG, Cb);
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

// Phase 3: each tile's up-sweep again and its down-sweep, written out as
// s + e (the second launch; the only one below 256 rows).
__global__ void __launch_bounds__(CS_THREADS, 4) cumsum_ds_kernel(
    const float* __restrict__ x, int U, int C,
    const float2* __restrict__ lv, float* __restrict__ out) {
  __shared__ __align__(16) float sm[CS_SMEM];
  const CsShape p = cs_shape(U, C);
  const int Cb = cs_load_tile(x, p, sm);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int col;
  DS v[8];
  const int tile = cs_warp_tile(p, Cb, sm, warp, lane, &col, v);
  if (tile >= 0) {
    CsTree t;
    cs_up(v, t, lane);
    cs_finish_tile(p, lv, tile, col, v, t, sm, warp, lane);
  }
  __syncthreads();
  cs_store_tile(p, Cb, sm, out);
}

// scratch: the roots' levels, 2 C (n8 + n16 + ...) floats with n8 = U / 256
// and each next level the previous / 256 while the previous exceeds 256
// (numerics.py `_roots_floats`); tickets: ceil(C / 8) unsigned, zero when
// first used; the first kernel leaves them zero.
KAI_EXPORT int kai_cumsum_ds(const float* x, int U, int C, float* scratch,
                             unsigned* tickets, float* out,
                             cudaStream_t stream) {
  if (U < 1 || C < 1) return KAI_ERR_ARGS;
  const int CG = C < CS_WARPS ? C : CS_WARPS;
  const int S = CS_WARPS / CG;
  const int tiles = (U + CS_CHUNK - 1) / CS_CHUNK;
  const dim3 grid((tiles + S - 1) / S, (C + CG - 1) / CG);
  if (grid.y > 65535) return KAI_ERR_ARGS;
  float2* lv = reinterpret_cast<float2*>(scratch);
  if (U >= CS_CHUNK) {
    cumsum_ds_tiles_kernel<<<grid, CS_THREADS, 0, stream>>>(x, U, C, lv,
                                                            tickets);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cumsum_ds_kernel<<<grid, CS_THREADS, 0, stream>>>(x, U, C, lv, out);
  return static_cast<int>(cudaGetLastError());
}
