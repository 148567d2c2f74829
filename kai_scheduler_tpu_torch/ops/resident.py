"""Packed journal deltas and their scatter-apply (kernel K16).

Port of ``kai_scheduler_tpu/ops/resident.py``.  On the resident path the
cluster snapshot stays on the device across cycles and a patched cycle
uploads only a **packed journal delta**: fixed-shape sparse ``(flat
element index, value)`` segments, one pair of arrays per ``(section,
dtype)`` group (``nodes.float32``, ``gangs.bool``, ...), which
:func:`apply_delta` writes into the device-resident ``ClusterState`` in
place.

Element addressing is a virtual concatenation per group: leaves are
numbered in :func:`~..state.cluster_state.leaf_paths` order (the
reference's pytree flatten order), and each leaf's elements occupy
``[offset, offset + leaf.size)`` of its group's flat index space
(:func:`leaf_layout`), so the host packer and the device apply address
elements identically by construction.  Segment lengths bucket to powers
of two with a floor (:data:`MIN_BUCKET`); padding slots carry ``idx ==
-1``.  The host packer (:func:`pack_delta`) diffs the new host mirror
against the previous one element-wise (NaN-stable on float leaves,
identity short-circuited) and returns the delta and a merged mirror that
keeps the previous cycle's arrays for unchanged leaves.  The host mirror
is the dict of numpy leaves keyed by dotted path that
``build_snapshot(..., return_host=True)`` returns.

:func:`apply_delta` on a CUDA state launches K16
(``csrc/resident_apply.cu``) once for the whole delta, or raises; on a
CPU state it runs :func:`apply_delta_plain`, the reference's per-leaf
rebase, mask and scatter.
"""
from __future__ import annotations

import copy
import ctypes
import threading

import numpy as np
import torch

from .. import kernels
from ..state.cluster_state import (ClusterState, leaf_paths, state_leaves)

__all__ = ["MIN_BUCKET", "DeltaShapeError", "leaf_layout", "pack_delta",
           "apply_delta", "apply_delta_plain", "empty_delta",
           "delta_nbytes"]

#: minimum padded segment length per (section, dtype) group: a quiet
#: cycle's delta stays a few KB, and churn jitter in near-floor groups
#: never crosses a bucket boundary
MIN_BUCKET = 256


class DeltaShapeError(ValueError):
    """A leaf changed shape/dtype between mirrors — not patchable (the
    caller falls back to the full rebuild)."""


def _bucket(n: int) -> int:
    """Padded segment length: 0 stays 0 (a group with no changes ships
    zero bytes), anything else pads to a power of two with a floor."""
    if n <= 0:
        return 0
    b = MIN_BUCKET
    while b < n:
        b <<= 1
    return b


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.dtype(leaf.dtype).name


def _numel(leaf) -> int:
    return leaf.numel() if isinstance(leaf, torch.Tensor) else int(leaf.size)


def _group_key(path: str, leaf) -> str:
    """``section.dtype`` — the segment table a leaf belongs to."""
    return f"{path.split('.')[0]}.{_dtype_name(leaf)}"


def leaf_layout(paths_leaves) -> list[tuple[str, int]]:
    """``(group key, flat offset)`` per leaf, in order: offsets are
    running sums of the leaf sizes per group."""
    cursor: dict[str, int] = {}
    out = []
    for path, leaf in paths_leaves:
        key = _group_key(path, leaf)
        off = cursor.get(key, 0)
        out.append((key, off))
        cursor[key] = off + _numel(leaf)
    return out


def _groups(paths_leaves) -> list[tuple[str, str]]:
    """Sorted ``(group key, dtype name)`` pairs present in the state."""
    seen: dict[str, str] = {}
    for path, leaf in paths_leaves:
        seen.setdefault(_group_key(path, leaf), _dtype_name(leaf))
    return sorted(seen.items())


def _paths_leaves(tree) -> list[tuple[str, object]]:
    """``(dotted path, leaf)`` in leaf_paths order, for a host mirror dict
    or a ``ClusterState``."""
    if isinstance(tree, ClusterState):
        tree = state_leaves(tree)
    return [(p, tree[p]) for p in leaf_paths()]


def empty_delta(tree) -> dict:
    """A structurally valid no-op delta for a host mirror or a state
    (zero-size segments in every group)."""
    pl = _paths_leaves(tree)
    return {
        "idx": {k: np.zeros((0,), np.int32) for k, _d in _groups(pl)},
        "val": {k: np.zeros((0,), np.dtype(d)) for k, d in _groups(pl)},
    }


def delta_nbytes(delta: dict) -> int:
    """Total bytes the delta puts on the wire (idx + val segments)."""
    return int(sum(a.nbytes for part in delta.values()
                   for a in part.values()))


def pack_delta(old_state: dict, new_state: dict,
               min_buckets: dict | None = None
               ) -> tuple[dict, dict, dict]:
    """Diff two host mirrors into a packed journal delta.

    Returns ``(delta, merged_state, stats)``: the fixed-structure delta
    dict, a merged mirror whose unchanged leaves keep the OLD array
    objects, and ``stats`` with ``leaves`` / ``elements`` / ``bytes``
    plus ``buckets`` (the padded length chosen per group).

    ``min_buckets`` is the hysteresis floor per group (the previous
    cycle's buckets), so segment lengths only grow and the delta's
    signature settles after one cycle.

    Raises :class:`DeltaShapeError` when any leaf changed shape or dtype.
    """
    paths_old = _paths_leaves(old_state)
    layout = leaf_layout(paths_old)
    idx_acc: dict[str, list] = {}
    val_acc: dict[str, list] = {}
    merged = {}
    changed_leaves = 0
    elements = 0
    for (path, old), (cls, off) in zip(paths_old, layout):
        new = new_state[path]
        if new is old:
            merged[path] = old
            continue
        if (getattr(new, "shape", None) != old.shape
                or new.dtype != old.dtype):
            raise DeltaShapeError(
                f"leaf {path}: {getattr(new, 'shape', None)}/{new.dtype} "
                f"!= {old.shape}/{old.dtype}")
        diff = new != old
        if new.dtype.kind == "f":
            # NaN-stable: an unset-sentinel NaN must not read as a changed
            # element forever
            diff &= ~(np.isnan(new) & np.isnan(old))
        flat = np.flatnonzero(diff)
        if not len(flat):
            merged[path] = old
            continue
        changed_leaves += 1
        elements += len(flat)
        idx_acc.setdefault(cls, []).append(
            flat.astype(np.int32) + np.int32(off))
        val_acc.setdefault(cls, []).append(new.ravel()[flat])
        merged[path] = new
    delta: dict = {"idx": {}, "val": {}}
    buckets: dict[str, int] = {}
    min_buckets = min_buckets or {}
    for key, dtype_name in _groups(paths_old):
        idx_parts = idx_acc.get(key, [])
        n = int(sum(len(p) for p in idx_parts))
        k = max(_bucket(n), int(min_buckets.get(key, 0)))
        buckets[key] = k
        idx = np.full((k,), -1, np.int32)
        val = np.zeros((k,), np.dtype(dtype_name))
        if n:
            idx[:n] = np.concatenate(idx_parts)
            val[:n] = np.concatenate(val_acc[key])
        delta["idx"][key] = idx
        delta["val"][key] = val
    stats = {"leaves": changed_leaves, "elements": elements,
             "bytes": delta_nbytes(delta), "buckets": buckets}
    return delta, merged, stats


# ---------------------------------------------------------------------------
# the scatter-apply: plain version and K16
# ---------------------------------------------------------------------------

def apply_delta_plain(state: ClusterState, delta: dict) -> ClusterState:
    """The reference's ``apply_delta`` on CPU tensors, in place: every
    leaf scans its group's whole segment, rebases each entry by its
    offset, drops what falls outside ``[0, size)`` (the ``-1`` padding
    included) and scatter-sets the rest (``index_put_``)."""
    pl = _paths_leaves(state)
    for (_path, leaf), (cls, off) in zip(pl, leaf_layout(pl)):
        idx = delta["idx"][cls]
        if idx.numel() == 0:
            continue
        val = delta["val"][cls]
        local = idx - off
        ok = (local >= 0) & (local < leaf.numel())
        leaf.view(-1).index_put_((local[ok].long(),),
                                 val[ok].to(leaf.dtype))
    return state


#: the kernel's table bounds (csrc/resident_apply.cu): every leaf of the
#: state, every (section, dtype) group
MAX_LEAVES = 96
MAX_GROUPS = 12


class _DeltaTable(ctypes.Structure):
    """``KaiDeltaTable`` of ``csrc/resident_apply.cu``, passed to the
    kernel by value (its ``__grid_constant__`` parameter)."""

    _fields_ = [("leaf_base", ctypes.c_uint64 * MAX_LEAVES),
                ("leaf_off", ctypes.c_int * MAX_LEAVES),
                ("leaf_size", ctypes.c_int * MAX_LEAVES),
                ("idx_ptr", ctypes.c_uint64 * MAX_GROUPS),
                ("val_ptr", ctypes.c_uint64 * MAX_GROUPS),
                ("grp_start", ctypes.c_int * (MAX_GROUPS + 1)),
                ("grp_size", ctypes.c_int * MAX_GROUPS),
                ("grp_leaf_begin", ctypes.c_int * MAX_GROUPS),
                ("grp_leaf_end", ctypes.c_int * MAX_GROUPS),
                ("grp_itemsize", ctypes.c_int * MAX_GROUPS),
                ("n_groups", ctypes.c_int),
                ("total", ctypes.c_int)]


_ITEMSIZE = {torch.float32: 4, torch.int32: 4, torch.bool: 1}

#: the leaf table of the last state K16 was given: (the state's leaves,
#: the table's leaf fields filled, group key -> (leaf begin, leaf end,
#: group size, itemsize, dtype)) — rebuilt when the leaves change
#: (a full rebuild, or a patch ship that swapped leaves)
_LEAF_TABLE: list = [None]
_LEAF_TABLE_LOCK = threading.Lock()


def _leaf_table(leaves: tuple[torch.Tensor, ...], pl) -> tuple:
    key = tuple((id(t), t.data_ptr()) for t in leaves)
    with _LEAF_TABLE_LOCK:
        hit = _LEAF_TABLE[0]
        if hit is not None and hit[0] == key:
            return hit[2], hit[3]
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"apply_delta: {len(leaves)} leaves, the kernel "
                         f"takes at most {MAX_LEAVES}")
    layout = leaf_layout(pl)
    order = sorted(range(len(pl)), key=lambda i: (layout[i][0], i))
    tab = _DeltaTable()
    groups: dict[str, list] = {}
    for slot, i in enumerate(order):
        (path, t), (cls, off) = pl[i], layout[i]
        if t.dtype not in _ITEMSIZE:
            raise ValueError(f"apply_delta: leaf {path} has dtype {t.dtype}")
        tab.leaf_base[slot] = t.data_ptr()
        tab.leaf_off[slot] = off
        tab.leaf_size[slot] = t.numel()
        g = groups.setdefault(cls, [slot, slot, 0, _ITEMSIZE[t.dtype],
                                    t.dtype])
        g[1] = slot + 1
        g[2] = off + t.numel()
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"apply_delta: {len(groups)} groups, the kernel "
                         f"takes at most {MAX_GROUPS}")
    groups = {k: tuple(v) for k, v in groups.items()}
    with _LEAF_TABLE_LOCK:
        _LEAF_TABLE[0] = (key, leaves, tab, groups)
    return tab, groups


def apply_delta(state: ClusterState, delta: dict) -> ClusterState:
    """Scatter a packed journal delta into ``state`` IN PLACE and return
    it.  A CUDA state launches K16 once for the whole delta (nothing when
    every segment is empty) or raises; a CPU state runs
    :func:`apply_delta_plain`."""
    pl = _paths_leaves(state)
    leaves = tuple(t for _p, t in pl)
    if not kernels.on_card(leaves[0]):
        return apply_delta_plain(state, delta)
    dev = kernels.require_cuda("resident_apply", dict(pl))
    tab, groups = _leaf_table(leaves, pl)
    tab = copy.copy(tab)
    segs = []
    for key in sorted(groups):
        idx = delta["idx"].get(key)
        val = delta["val"].get(key)
        if idx is None or val is None:
            raise ValueError(f"apply_delta: delta lacks group {key}")
        if idx.numel() == 0:
            continue
        begin, end, size, item, dtype = groups[key]
        kernels.require_cuda("resident_apply", {"idx": idx, "val": val},
                             {"idx": torch.int32, "val": dtype})
        if idx.device != dev or val.device != dev:
            raise ValueError(f"apply_delta: group {key} is on "
                             f"{idx.device}, the state on {dev}")
        if idx.shape != val.shape or idx.dim() != 1:
            raise ValueError(f"apply_delta: group {key} has idx "
                             f"{tuple(idx.shape)} and val {tuple(val.shape)}")
        segs.append((idx, val, size, begin, end, item))
    if not segs:
        return state
    total = 0
    for g, (idx, val, size, begin, end, item) in enumerate(segs):
        tab.idx_ptr[g] = idx.data_ptr()
        tab.val_ptr[g] = val.data_ptr()
        tab.grp_start[g] = total
        tab.grp_size[g] = size
        tab.grp_leaf_begin[g] = begin
        tab.grp_leaf_end[g] = end
        tab.grp_itemsize[g] = item
        total += idx.numel()
    tab.grp_start[len(segs)] = total
    tab.n_groups = len(segs)
    tab.total = total
    lib = kernels.library()
    rc = lib.kai_resident_apply(ctypes.addressof(tab),
                                kernels.stream_of(leaves[0]))
    kernels.check(rc, "resident_apply")
    kernels.count_launch("resident_apply")
    return state
