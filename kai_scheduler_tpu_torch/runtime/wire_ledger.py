"""The host-to-device transfer ledger.

Port of ``kai_scheduler_tpu/runtime/wire_ledger.py``.  The
:class:`TransferLedger` is the port's one choke point for host-to-device
uploads of snapshot data: :meth:`TransferLedger.device_put` takes a dict
of numpy arrays (nested dicts allowed), packs every leaf into ONE host
buffer (16-byte aligned slots; pinned when the target is a CUDA device),
copies it with ONE host-to-device copy, and returns the same dict
structure of tensors — typed views into the one device buffer.  Each
upload is recorded per leaf with its name, size, dtype, shape, content
fingerprint and a *reason*:

* ``full-build``     — ``build_snapshot``'s one-shot snapshot transfer;
* ``journal-patch``  — the incremental snapshotter's changed leaves
  (``state/incremental.py``), in one batched copy;
* ``delta-apply``    — the packed journal delta of a resident cycle
  (``ops/resident.py``), the only steady-state upload once the snapshot
  lives on the device; it is **transient** (consumed in the cycle that
  uploads it): counted on the wire, kept out of the residency gauge and
  the redundancy compare;
* ``fallback``       — the incremental snapshotter rebuilt in full;
* ``verify``         — the verifier's reference rebuild.

Derived surfaces, as in the reference: a redundancy detector (crc32 of
the full buffer, qualified by nbytes/dtype/shape, against the last upload
of the same ``(site, leaf)`` key), a device-residency gauge (the last
upload per leaf key, with a per-cycle peak), per-cycle summaries in a
bounded ring (:meth:`roll_cycle`, ``CycleResult.wire``), cumulative totals
and the accounted device-to-host readback :meth:`device_get`.

Left out until the slices that need them: the ``sharding`` argument and
the ``mesh-shard`` reason (the mesh slice), and the mirror of every
upload into the ``kai_wire_*`` registry metrics (the serving slice, which
also brings the ``/debug/wire`` endpoint that serves :meth:`wire_doc`).

Every access to ledger state holds ``_lock``; the copy itself runs
outside it.
"""
from __future__ import annotations

import contextlib
import threading
import zlib

import numpy as np
import torch

from ..device import resolve_device

__all__ = [
    "TransferLedger", "LEDGER", "REASON_FULL_BUILD",
    "REASON_JOURNAL_PATCH", "REASON_DELTA_APPLY", "REASON_FALLBACK",
    "REASON_VERIFY",
]

REASON_FULL_BUILD = "full-build"
REASON_JOURNAL_PATCH = "journal-patch"
REASON_DELTA_APPLY = "delta-apply"
REASON_FALLBACK = "fallback"
REASON_VERIFY = "verify"

#: leaves larger than this are size-counted but not fingerprinted (crc32
#: runs ~0.5 GB/s); far above every leaf of the headline snapshot
_FINGERPRINT_LIMIT_BYTES = 64 * 1024 * 1024

_TOTAL_FIELDS = ("leaves", "bytes", "redundant_leaves",
                 "redundant_bytes", "dispatches",
                 "unfingerprinted_bytes")

#: slot alignment inside the one upload buffer
_ALIGN = 16


def _flatten(tree, prefix=()) -> list[tuple[tuple, object]]:
    """``(key path, leaf)`` pairs of a dict tree, keys SORTED at every
    level (the reference's flatten order of dicts)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _unflatten(tree, leaves: dict):
    """Rebuild ``tree``'s dict structure with the leaves keyed by path."""
    def go(node, prefix):
        if isinstance(node, dict):
            return {k: go(v, prefix + (k,)) for k, v in node.items()}
        return leaves[prefix]
    return go(tree, ())


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty((0,), dtype)).dtype


def _fingerprint(leaf, limit: int) -> tuple | None:
    """Content fingerprint of a host array: full-buffer crc32 qualified by
    nbytes/dtype/shape.  None for non-numpy leaves and over-limit buffers
    (never counted redundant)."""
    if not isinstance(leaf, np.ndarray) or leaf.nbytes > limit:
        return None
    arr = np.ascontiguousarray(leaf)
    if arr.nbytes == 0:
        crc = 0
    else:
        try:
            crc = zlib.crc32(memoryview(arr).cast("B"))
        except (TypeError, ValueError):
            # 0-d and zero-stride views refuse the flat cast
            crc = zlib.crc32(arr.tobytes())
    return (crc, int(arr.nbytes), str(arr.dtype), tuple(arr.shape))


def _leaf_doc(name: str, leaf, reason: str, site: str,
              redundant: bool) -> dict:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    return {
        "leaf": name,
        "nbytes": _nbytes(leaf),
        "dtype": (str(dtype).replace("torch.", "") if dtype is not None
                  else type(leaf).__name__),
        "shape": list(shape) if shape is not None else [],
        "reason": reason,
        "site": site,
        "redundant": bool(redundant),
    }


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(getattr(leaf, "nbytes", 0))


def _upload(arrays: list[np.ndarray], dev: torch.device
            ) -> list[torch.Tensor]:
    """Pack ``arrays`` into one host buffer and copy it to ``dev`` in ONE
    copy; each returned tensor is a typed view into the device buffer."""
    offs, off = [], 0
    for a in arrays:
        offs.append(off)
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    total = max(off, _ALIGN)
    if dev.type == "cuda":
        host_t = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
        host = host_t.numpy()
    else:
        host = np.zeros((total,), np.uint8)
        host_t = torch.from_numpy(host)
    for a, o in zip(arrays, offs):
        if a.nbytes:
            host[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
    buf = (host_t.to(dev, non_blocking=True) if dev.type == "cuda"
           else host_t)
    return [buf[o:o + a.nbytes].view(_torch_dtype(a.dtype)).view(a.shape)
            for a, o in zip(arrays, offs)]


class TransferLedger:
    """Per-cycle, per-leaf host-to-device upload accounting.

    One process-global instance (:data:`LEDGER`) serves the package.
    Uploads between cycle rolls accumulate in an open window;
    :meth:`roll_cycle` closes the window into an immutable ring entry and
    returns the cycle summary.
    """

    def __init__(self, retain_cycles: int = 32,
                 max_events_per_cycle: int = 512,
                 fingerprint_limit_bytes: int = _FINGERPRINT_LIMIT_BYTES):
        self._lock = threading.Lock()
        #: immutable per-cycle documents, oldest first
        self._ring: list[dict] = []
        #: open-window bounded event docs
        self._window_events: list[dict] = []
        self._window_dropped = 0
        #: open-window aggregates by reason (dropped events still count)
        self._window_totals: dict[str, dict] = {}
        self._window_peak = 0
        #: (site, leaf) -> (fingerprint, nbytes): the resident set
        self._resident: dict[tuple[str, str], tuple] = {}
        self._resident_bytes = 0
        #: resident keys (re)uploaded in the open window
        self._window_uploaded_keys: set[tuple[str, str]] = set()
        #: accounted device-to-host readbacks (:meth:`device_get`)
        self._downloads: dict[str, dict] = {}
        self._window_downloads: dict[str, dict] = {}
        #: cumulative per-reason aggregates
        self._totals: dict[str, dict] = {}
        self._retain = max(1, int(retain_cycles))
        self.max_events_per_cycle = max(1, int(max_events_per_cycle))
        self.fingerprint_limit_bytes = int(fingerprint_limit_bytes)
        #: per-thread reason override (see :meth:`override_reason`)
        self._local = threading.local()

    # -- recording ---------------------------------------------------------

    @contextlib.contextmanager
    def override_reason(self, reason: str):
        """Re-label uploads made inside the block (the incremental
        snapshotter's fallback rebuild and the verifier's reference
        rebuild)."""
        prev = getattr(self._local, "reason", None)
        self._local.reason = reason
        try:
            yield
        finally:
            self._local.reason = prev

    def device_put(self, tree, *, device="cuda", reason: str,
                   site: str = "snapshot", replace_site: bool = False,
                   leaf_names: list[str] | None = None,
                   transient: bool = False):
        """Upload a dict tree of numpy arrays to ``device`` in ONE copy and
        record one event per leaf; returns the same dict structure of
        tensors.  A leaf that is already a tensor is moved on its own and
        counted by size, never fingerprinted.

        ``replace_site=True`` declares that the upload supersedes the
        site's whole resident set (a full rebuild); the default
        accumulates (a patch replaces only the leaves it ships).
        ``leaf_names`` overrides the derived names (the key paths joined
        with dots) and must follow the flatten order: dict keys sorted.
        ``transient=True`` marks a consumable upload (the packed delta):
        counted on the wire, kept out of the residency gauge and the
        redundancy compare, and not fingerprinted.
        """
        override = getattr(self._local, "reason", None)
        if override is not None:
            reason = override
        leaves_p = _flatten(tree)
        if not leaves_p:
            return tree
        if leaf_names is not None and len(leaf_names) != len(leaves_p):
            raise ValueError(
                f"leaf_names has {len(leaf_names)} entries for "
                f"{len(leaves_p)} leaves")
        dev = resolve_device(device)
        host = [(p, np.ascontiguousarray(leaf)) for p, leaf in leaves_p
                if not isinstance(leaf, torch.Tensor)]
        uploaded = dict(zip([p for p, _ in host],
                            _upload([a for _, a in host], dev)))
        for p, leaf in leaves_p:
            if isinstance(leaf, torch.Tensor):
                uploaded[p] = leaf.to(dev)
        out = _unflatten(tree, uploaded)
        limit = self.fingerprint_limit_bytes
        staged = []  # (name, leaf, nbytes, fingerprint)
        for i, (path, leaf) in enumerate(leaves_p):
            name = (leaf_names[i] if leaf_names is not None
                    else ".".join(map(str, path)) or f"[{i}]")
            staged.append((name, leaf, _nbytes(leaf),
                           None if transient
                           else _fingerprint(leaf, limit)))
        agg = dict.fromkeys(_TOTAL_FIELDS, 0)
        agg["dispatches"] = 1
        with self._lock:
            # replace_site: the site's leaves NOT re-uploaded here leave
            # the resident set — after the per-leaf compares, so a full
            # rebuild that re-ships identical bytes is still counted
            stale = ({k for k in self._resident if k[0] == site}
                     if replace_site else None)
            for name, leaf, nbytes, fp in staged:
                key = (site, name)
                if stale is not None:
                    stale.discard(key)
                redundant = False
                if not transient:
                    prev = self._resident.get(key)
                    redundant = (fp is not None and prev is not None
                                 and prev[0] == fp)
                    self._resident_bytes += nbytes - (
                        prev[1] if prev is not None else 0)
                    self._resident[key] = (fp, nbytes)
                    self._window_uploaded_keys.add(key)
                agg["leaves"] += 1
                agg["bytes"] += nbytes
                if redundant:
                    agg["redundant_leaves"] += 1
                    agg["redundant_bytes"] += nbytes
                if fp is None and not transient:
                    agg["unfingerprinted_bytes"] += nbytes
                if len(self._window_events) < self.max_events_per_cycle:
                    self._window_events.append(
                        _leaf_doc(name, leaf, reason, site, redundant))
                else:
                    self._window_dropped += 1
            for key in sorted(stale or ()):
                self._resident_bytes -= self._resident.pop(key)[1]
                self._window_uploaded_keys.discard(key)
            self._window_peak = max(self._window_peak,
                                    self._resident_bytes)
            for dst in (self._window_totals.setdefault(
                            reason, dict.fromkeys(_TOTAL_FIELDS, 0)),
                        self._totals.setdefault(
                            reason, dict.fromkeys(_TOTAL_FIELDS, 0))):
                for field in _TOTAL_FIELDS:
                    dst[field] += agg[field]
        return out

    def device_get(self, tree, *, reason: str, site: str = "snapshot"):
        """Accounted batched device-to-host readback of a dict tree of
        tensors: host numpy copies in the same structure, booked in a
        separate ``downloads`` ledger so upload invariants never absorb
        readback bytes."""
        leaves_p = _flatten(tree)
        host = {p: (leaf.detach().cpu().numpy()
                    if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
                for p, leaf in leaves_p}
        out = _unflatten(tree, host)
        nbytes = sum(a.nbytes for a in host.values())
        with self._lock:
            for dst in (self._window_downloads, self._downloads):
                t = dst.setdefault(reason, {"leaves": 0, "bytes": 0,
                                            "dispatches": 0})
                t["leaves"] += len(leaves_p)
                t["bytes"] += nbytes
                t["dispatches"] += 1
        return out

    def roll_cycle(self, cycle_id: int) -> dict:
        """Close the open window into an immutable ring entry and return
        the cycle summary (``CycleResult.wire``)."""
        with self._lock:
            by_reason = {r: dict(t)
                         for r, t in sorted(self._window_totals.items())}
            events = tuple(self._window_events)
            dropped = self._window_dropped
            peak = max(self._window_peak, self._resident_bytes)
            # resident bytes that stayed on the device this cycle without
            # touching the wire, vs bytes actually uploaded
            reused = sum(
                ent[1] for key, ent in self._resident.items()
                if key not in self._window_uploaded_keys)
            downloads = {r: dict(t) for r, t
                         in sorted(self._window_downloads.items())}
            self._window_events = []
            self._window_dropped = 0
            self._window_totals = {}
            self._window_downloads = {}
            self._window_uploaded_keys = set()
            self._window_peak = self._resident_bytes
            summary = {
                "cycle": int(cycle_id),
                "by_reason": by_reason,
                "dropped": dropped,
                "resident_bytes": self._resident_bytes,
                "resident_buffers": len(self._resident),
                "peak_resident_bytes": peak,
                "resident_reused_bytes": reused,
                "downloads": downloads,
            }
            for field in _TOTAL_FIELDS:
                summary[field] = sum(t[field] for t in by_reason.values())
            summary["resident_uploaded_bytes"] = summary["bytes"]
            entry = dict(summary)
            entry["events"] = events
            self._ring.append(entry)
            del self._ring[:-self._retain]
        return summary

    # -- reading -----------------------------------------------------------

    def totals(self) -> dict:
        """Cumulative per-reason aggregates since process start."""
        with self._lock:
            return {"by_reason": {r: dict(t) for r, t
                                  in sorted(self._totals.items())},
                    "downloads_by_reason": {
                        r: dict(t)
                        for r, t in sorted(self._downloads.items())},
                    "resident_bytes": self._resident_bytes,
                    "resident_buffers": len(self._resident)}

    def residency(self) -> dict:
        with self._lock:
            return {"buffers": len(self._resident),
                    "bytes": self._resident_bytes,
                    "peak_bytes": max(self._window_peak,
                                      self._resident_bytes)}

    def last(self, n: int = 1) -> list[dict]:
        """The most recent ``n`` rolled cycle documents, oldest first."""
        with self._lock:
            return list(self._ring[-max(1, n):])

    def wire_doc(self, cycles: int | None = None) -> dict:
        """The wire document: the rolled cycle ring (bounded by
        ``cycles``), the open window's partial aggregates, the residency
        gauge and the cumulative totals."""
        with self._lock:
            ring = list(self._ring if cycles is None
                        else self._ring[-max(1, cycles):])
            window = {
                "by_reason": {r: dict(t) for r, t
                              in sorted(self._window_totals.items())},
                "events": len(self._window_events),
                "dropped": self._window_dropped,
            }
            residency = {"buffers": len(self._resident),
                         "bytes": self._resident_bytes,
                         "peak_bytes": max(self._window_peak,
                                           self._resident_bytes)}
            totals = {r: dict(t) for r, t in sorted(self._totals.items())}
            downloads = {r: dict(t)
                         for r, t in sorted(self._downloads.items())}
        return {
            "cycles": [dict(c, events=list(c["events"])) for c in ring],
            "window": window,
            "residency": residency,
            "totals": {"by_reason": totals,
                       "downloads_by_reason": downloads},
        }


#: the process-global ledger every snapshot upload flows through
LEDGER = TransferLedger()
