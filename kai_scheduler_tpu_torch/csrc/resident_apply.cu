// K16 resident_apply — scatter a packed journal delta into the resident
// snapshot, in place.
//
// Replaces kai_scheduler_tpu/ops/resident.py:213 `apply_delta`: for every
// leaf, the reference scans its (section, dtype) group's whole (idx, val)
// segment, rebases each entry by the leaf's offset in the group, drops
// what falls outside [0, leaf size) — the -1 padding included — and
// scatter-sets the rest.  A fixed-shape masked scatter per leaf.
//
// Here ONE launch covers the whole delta: one thread per padded entry of
// every non-empty group.  The thread finds its group in the table's entry
// prefix (at most 12 groups), skips idx < 0 and idx >= group size, finds
// its leaf by a binary search over the group's leaf offsets (ascending in
// the table; at most 26 leaves a group at the headline shape), and copies
// the value's BITS: a 32-bit store for f32 and i32 leaves, a byte store
// for bool leaves, no float arithmetic — NaN payloads and -0.0 land
// exactly.  The leaves are addressed through a table of base addresses:
// after a patch ship swapped some leaves the state is no longer one
// buffer.  The table travels by value (a __grid_constant__ parameter of
// under 2 KB), so a steady cycle uploads nothing but the delta.
//
// Precondition: no two entries address one element.  The packer
// guarantees it (leaf ranges are disjoint and each leaf's changed
// positions are unique), and chip_smoke.py checks it on every captured
// delta; with a duplicate, which value lands would be unordered.
//
// Bound: bytes — the padded idx and val segments read once and the
// changed elements written once; at the headline's steady buckets that
// is ~1.8 MB, about half a microsecond at 3.35 TB/s, so the kernel is
// launch-bound.
#include "kai_common.cuh"

#define RA_MAX_LEAVES 96
#define RA_MAX_GROUPS 12
#define RA_THREADS 256

struct KaiDeltaTable {
  unsigned long long leaf_base[RA_MAX_LEAVES];  // device address of leaf
  int leaf_off[RA_MAX_LEAVES];    // element offset in its group
  int leaf_size[RA_MAX_LEAVES];   // elements
  unsigned long long idx_ptr[RA_MAX_GROUPS];  // the group's idx segment
  unsigned long long val_ptr[RA_MAX_GROUPS];  // the group's val segment
  int grp_start[RA_MAX_GROUPS + 1];  // first entry of the group; [n] = all
  int grp_size[RA_MAX_GROUPS];       // elements of the group's leaves
  int grp_leaf_begin[RA_MAX_GROUPS];  // the group's leaves in the table
  int grp_leaf_end[RA_MAX_GROUPS];
  int grp_itemsize[RA_MAX_GROUPS];   // 4 (f32, i32) or 1 (bool)
  int n_groups;
  int total;
};

__global__ void __launch_bounds__(RA_THREADS) resident_apply_kernel(
    const __grid_constant__ KaiDeltaTable tab) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= tab.total) return;
  int g = 0;
  while (g + 1 < tab.n_groups && tab.grp_start[g + 1] <= e) ++g;
  const int j = e - tab.grp_start[g];
  const int idx = reinterpret_cast<const int*>(tab.idx_ptr[g])[j];
  if (idx < 0 || idx >= tab.grp_size[g]) return;
  // the last leaf of the group whose offset is <= idx
  int lo = tab.grp_leaf_begin[g], hi = tab.grp_leaf_end[g] - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.leaf_off[mid] <= idx) lo = mid; else hi = mid - 1;
  }
  const int local = idx - tab.leaf_off[lo];
  if (local < 0 || local >= tab.leaf_size[lo]) return;
  if (tab.grp_itemsize[g] == 4) {
    reinterpret_cast<unsigned int*>(tab.leaf_base[lo])[local] =
        reinterpret_cast<const unsigned int*>(tab.val_ptr[g])[j];
  } else {
    reinterpret_cast<u8*>(tab.leaf_base[lo])[local] =
        reinterpret_cast<const u8*>(tab.val_ptr[g])[j];
  }
}

// `tab` is a host pointer; the table is copied into the launch's
// parameters, so it need not outlive the call
KAI_EXPORT int kai_resident_apply(const KaiDeltaTable* tab,
                                  cudaStream_t stream) {
  if (tab == nullptr || tab->n_groups < 1 || tab->n_groups > RA_MAX_GROUPS ||
      tab->total < 1)
    return KAI_ERR_ARGS;
  for (int g = 0; g < tab->n_groups; ++g) {
    if (tab->grp_itemsize[g] != 4 && tab->grp_itemsize[g] != 1)
      return KAI_ERR_ARGS;
    if (tab->grp_leaf_begin[g] < 0 || tab->grp_leaf_end[g] > RA_MAX_LEAVES ||
        tab->grp_leaf_begin[g] >= tab->grp_leaf_end[g])
      return KAI_ERR_ARGS;
  }
  const int blocks = (tab->total + RA_THREADS - 1) / RA_THREADS;
  resident_apply_kernel<<<blocks, RA_THREADS, 0, stream>>>(*tab);
  return static_cast<int>(cudaGetLastError());
}
