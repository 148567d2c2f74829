"""Signature watcher of the cycle's entry points.

Port of ``kai_scheduler_tpu/runtime/compile_watch.py``.  The reference
wraps its jit entry points and attributes every jit cache miss to its
``(entry, abstract signature)`` pair, so that a signature drifting from
cycle to cycle (a padded dimension crossing a bucket) shows as a
recompile storm.  The port compiles nothing per signature: its entries
run eagerly, and its kernels are built once.  What stays meaningful is
the signature itself.  :class:`CompileWatcher` keeps the reference's
model of it — the tree structure of ``(args, kwargs)``, ``(shape,
dtype)`` for every tensor or array leaf, ``repr`` for every static leaf
(configs, ints, strings) — and counts a call whose signature it has not
seen as a "miss", timed like the reference's compile.  On the resident
path the one signature that moves is the packed delta's bucket tuple
(``ops/resident.py``), so a miss after the warm-up means the bucket
hysteresis broke: the watcher stays the tripwire the reference's soak
uses it for.  The reference's storm alarm and its knobs are left out: no
consumer of the port reads them yet.

Wrapped entries (the reference's names): ``resident_cycle``,
``fused_pipeline``, ``stale_gang_eviction``, ``set_fair_share``,
``pack_commit``, ``allocate``, ``run_victim_action``, ``analytics`` and
``repack``.  The mirror of the counts into the ``kai_compile_*``
registry metrics waits for the serving slice.

The wrapper is host-side: one tree walk and one tuple per call.  All
watcher state is accessed under ``_lock``.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
import zlib

import numpy as np
import torch

__all__ = ["CompileWatcher", "WATCHER", "watch"]


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _has_array(x) -> bool:
    """Whether a dataclass holds a tensor or array somewhere: such a
    dataclass is data (a state, a commit set) and is walked; any other is
    a static config and is a leaf."""
    if _is_array(x):
        return True
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return any(_has_array(getattr(x, f.name))
                   for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return any(_has_array(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_has_array(v) for v in x)
    return False


def _walk(x, leaves: list) -> str:
    """Append ``x``'s leaves to ``leaves``; returns its structure."""
    if _is_array(x):
        leaves.append(x)
        return "*"
    if isinstance(x, dict):
        keys = sorted(x)
        return ("{" + ",".join(f"{k!r}:{_walk(x[k], leaves)}" for k in keys)
                + "}")
    if isinstance(x, (list, tuple)):
        inner = ",".join(_walk(v, leaves) for v in x)
        return ("[" if isinstance(x, list) else "(") + inner + \
            ("]" if isinstance(x, list) else ")")
    if (dataclasses.is_dataclass(x) and not isinstance(x, type)
            and _has_array(x)):
        return (type(x).__name__ + "(" + ",".join(
            f"{f.name}={_walk(getattr(x, f.name), leaves)}"
            for f in dataclasses.fields(x)) + ")")
    if x is None:
        return "None"
    leaves.append(x)
    return "*"


def _signature(args, kwargs) -> tuple:
    """The abstract signature, modelled on the reference's: tree structure
    + per-leaf ``(shape, dtype)`` for tensors and arrays, ``repr`` for
    static leaves."""
    leaves: list = []
    structure = _walk((args, dict(sorted(kwargs.items()))), leaves)
    parts = []
    for leaf in leaves:
        if _is_array(leaf):
            parts.append(("a", tuple(leaf.shape),
                          str(leaf.dtype).replace("torch.", "")))
        else:
            parts.append(("s", repr(leaf)))
    return (structure, tuple(parts))


def _render_signature(sig: tuple) -> str:
    """Compact label: digest + the dominant array shapes."""
    digest = f"{zlib.crc32(repr(sig).encode()):08x}"
    counts: dict[str, int] = {}
    for part in sig[1]:
        if part[0] == "a":
            key = f"{part[2]}[{','.join(str(d) for d in part[1])}]"
            counts[key] = counts.get(key, 0) + 1
    top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:3]
    shapes = ", ".join(f"{k}×{n}" if n > 1 else k for k, n in top)
    return f"sig-{digest}" + (f" ({shapes}, …)" if shapes else "")


class CompileWatcher:
    """Attributes first-seen signatures to ``(entry, signature)`` pairs."""

    #: miss events kept, oldest dropped first
    RETAIN_EVENTS = 256

    def __init__(self):
        self._lock = threading.Lock()
        #: entry -> set of seen signatures
        self._seen: dict[str, set] = {}
        #: entry -> {"misses": n, "seconds": s, "calls": n}
        self._stats: dict[str, dict] = {}
        #: bounded ring of immutable miss-event docs, oldest first
        self._events: list[dict] = []

    # -- wrapping ----------------------------------------------------------

    def wrap(self, entry: str, fn):
        """Wrap ``fn``; every call classifies its signature, and a
        first-seen one is recorded as the entry's miss (timed around the
        call).  ``__wrapped__`` is the unwatched function."""
        with self._lock:
            self._seen.setdefault(entry, set())
            self._stats.setdefault(
                entry, {"misses": 0, "seconds": 0.0, "calls": 0})

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            sig = _signature(args, kwargs)
            if not self._observe_call(entry, sig):
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._observe_miss(entry, sig, time.perf_counter() - t0)
            return out

        wrapped.__wrapped__ = fn
        wrapped.__kai_entry__ = entry
        return wrapped

    def _observe_call(self, entry: str, sig: tuple) -> bool:
        """Register the call; True when the signature is new."""
        with self._lock:
            self._stats[entry]["calls"] += 1
            seen = self._seen[entry]
            if sig in seen:
                return False
            seen.add(sig)
            return True

    def _observe_miss(self, entry: str, sig: tuple,
                      seconds: float) -> None:
        with self._lock:
            st = self._stats[entry]
            st["misses"] += 1
            st["seconds"] += seconds
            self._events.append({
                "entry": entry,
                "signature": _render_signature(sig),
                "seconds": round(seconds, 6),
                "wall": time.time(),
            })
            del self._events[:-self.RETAIN_EVENTS]

    # -- reading -----------------------------------------------------------

    def entries(self) -> list[str]:
        with self._lock:
            return sorted(self._seen)

    def events(self, n: int | None = None) -> list[dict]:
        """Recent miss events, oldest first."""
        with self._lock:
            evs = self._events if n is None else self._events[-max(1, n):]
            return [dict(e) for e in evs]

    def report(self) -> dict:
        """Per-entry signatures, misses, calls and seconds, and the
        events."""
        with self._lock:
            entries = {
                name: {"signatures": len(self._seen[name]),
                       "misses": st["misses"], "calls": st["calls"],
                       "seconds": round(st["seconds"], 6)}
                for name, st in sorted(self._stats.items())}
            events = [dict(e) for e in self._events]
        return {"entries": entries, "events": events}


#: the process-global watcher the package's entry points wrap with
WATCHER = CompileWatcher()


def watch(entry: str, fn):
    """Hook one entry point into the global watcher::

        allocate_watched = compile_watch.watch("allocate", allocate)
    """
    return WATCHER.wrap(entry, fn)
