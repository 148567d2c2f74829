"""Compensated (double-single) prefix sums for long f32 scans.

Port of ``kai_scheduler_tpu/utils/numerics.py``.  The victim solver's
per-unit tables are cumulative sums over up to M (running pods) rows with
GiB-scale values, where a plain f32 scan drifts by more than a small
pod's request.  ``cumsum_ds`` keeps the scan in f32 but carries each
combine's rounding residue through Knuth's two-sum.

The reference runs the scan through ``jax.lax.associative_scan``, whose
bits depend on that function's fixed recursion tree: combine adjacent
pairs, scan the half-length result recursively, then combine each odd
prefix with the next even element.  Both versions here run exactly that
tree:

- :func:`cumsum_ds_plain` — level by level, strided slices in PyTorch
  (the CPU path and the kernel's oracle);
- **K5** (``csrc/cumsum_ds.cu``) — the same tree in tiles of 256 rows (a
  subtree each, one warp a tile and column: 8 rows a lane in registers,
  the upper levels through lane shuffles): the tiles' roots, the
  recursion over those roots by the last block of a column group, then
  each tile's down-sweep seeded by its root's result and the previous
  tile's.  Two launches (one below 256 rows); coalesced loads and stores
  through shared memory.

A left-to-right compensated sum (or ``torch.cumsum``) differs from the
reference in the last bit, so neither stands in for the other.

:func:`cumsum_blocked` is the reference's *plain* ``jnp.cumsum`` order on
the CPU: XLA rewrites the cumulative reduce-window into blocks of
:data:`SCAN_BLOCK` (each summed left to right from +0.0), scans the block
totals the same way, and adds each block's exclusive prefix.  Neither
``torch.cumsum`` (which accumulates f32 in double on the CPU and in no
fixed order on CUDA) nor a plain left-to-right sum gives those bits once
the values carry fractions.  The same blocks hold along axis 0 of a 3-D
array — the allocate chunk's cumulatives over lanes, ``[B, N, R]``,
``[B, N, D]`` and ``[B, Q, R]`` — fitted against ``jnp.cumsum`` at 8 to
300 lanes and up to 10,000 x 3 columns; K10 (``csrc/dense_accept.cu``)
walks its lanes in that order.
"""
from __future__ import annotations

import torch

from .. import kernels

Tensor = torch.Tensor


def _two_sum(a: Tensor, b: Tensor):
    """Knuth two-sum: ``s + err == a + b`` exactly (all f32)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _combine(sa: Tensor, ea: Tensor, sb: Tensor, eb: Tensor):
    s, e = _two_sum(sa, sb)
    return s, (e + ea) + eb


def _scan(s: Tensor, e: Tensor):
    """``associative_scan``'s recursion over axis 0 of ``(s, e)``."""
    n = s.shape[0]
    if n < 2:
        return s, e
    rs, re_ = _combine(s[0:n - 1:2], e[0:n - 1:2], s[1::2], e[1::2])
    os_, oe = _scan(rs, re_)
    # even prefix 2i (i >= 1) = odd prefix 2i-1 combined with element 2i
    m = (n + 1) // 2 - 1
    es, ee = _combine(os_[:m], oe[:m], s[2::2], e[2::2])
    out_s = torch.empty_like(s)
    out_e = torch.empty_like(e)
    out_s[0], out_e[0] = s[0], e[0]
    out_s[2::2], out_e[2::2] = es, ee
    out_s[1::2], out_e[1::2] = os_, oe
    return out_s, out_e


def cumsum_ds_plain(x: Tensor) -> Tensor:
    """Plain PyTorch version of K5: the compensated cumulative sum of
    ``x`` along axis 0 (any trailing shape), bit-equal to the reference's
    ``cumsum_ds``."""
    s, e = _scan(x, torch.zeros_like(x))
    return s + e


def cumsum_ds(x: Tensor, axis: int = 0) -> Tensor:
    """K5 — the compensated cumulative sum of f32 ``x`` along ``axis``.
    CPU tensors run :func:`cumsum_ds_plain`; CUDA tensors launch the
    kernel (256-row tiles of up to 8 columns of the trailing axes) or
    raise."""
    if axis != 0:
        x = x.movedim(axis, 0)
    if not kernels.on_card(x):
        out = cumsum_ds_plain(x)
    else:
        out = _cumsum_ds_cuda(x)
    return out.movedim(0, axis) if axis != 0 else out


#: block length of XLA:CPU's cumulative-sum rewrite (``jnp.cumsum``)
SCAN_BLOCK = 16


def _cumsum_seq(x: Tensor) -> Tensor:
    """Left-to-right f32 prefix sums along axis 0 from +0.0."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        acc = acc + x[i]
        out[i] = acc
    return out


def cumsum_blocked(x: Tensor, axis: int = 0) -> Tensor:
    """``jnp.cumsum(x, axis)`` in the reference's f32 order on the CPU (see
    the module docstring), in PyTorch ops — the same bits on any device.
    Integer and whole-unit inputs may use ``torch.cumsum`` instead."""
    if axis != 0:
        return cumsum_blocked(x.movedim(axis, 0)).movedim(0, axis)
    n = x.shape[0]
    if n <= SCAN_BLOCK:
        return _cumsum_seq(x)
    nb = -(-n // SCAN_BLOCK)
    pad = torch.zeros((nb * SCAN_BLOCK - n,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    xb = torch.cat([x, pad]).reshape((nb, SCAN_BLOCK) + x.shape[1:])
    inner = _cumsum_seq(xb.movedim(1, 0)).movedim(0, 1)  # [nb, 16, ...]
    tot = cumsum_blocked(inner[:, -1])
    excl = torch.cat([torch.zeros_like(tot[:1]), tot[:-1]])
    out = inner + excl[:, None]
    return out.reshape((nb * SCAN_BLOCK,) + x.shape[1:])[:n]


#: K5's tile of rows (one warp's chunk) and columns a block (its warps)
CUMSUM_DS_CHUNK = 256
CUMSUM_DS_GROUP = 8


def _roots_floats(U: int, C: int) -> int:
    """Floats of K5's scratch: the tile roots' levels (``U // 256`` pairs a
    column, then a level of every full chunk of 256 of them while a level
    exceeds one chunk)."""
    total, n = 0, U // CUMSUM_DS_CHUNK
    while True:
        total += n * C
        if n <= CUMSUM_DS_CHUNK:
            return 2 * total
        n //= CUMSUM_DS_CHUNK


#: K5's column-group tickets, a zeroed buffer a (device, stream): a
#: group's last block of the first launch resets its ticket
_TICKETS: dict = {}


def _tickets(x: Tensor, groups: int) -> Tensor:
    """The tickets of a K5 launch over ``groups`` column groups."""
    key = (x.device, kernels.stream_of(x).value)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < groups:
        buf = torch.zeros((max(groups, 64),), dtype=torch.int32,
                          device=x.device)
        _TICKETS[key] = buf
    return buf


def _cumsum_ds_cuda(x: Tensor) -> Tensor:
    if x.dtype != torch.float32:
        raise ValueError(f"cumsum_ds: dtype {x.dtype}, want float32")
    x = x.contiguous()
    U = x.shape[0]
    C = x[0].numel() if U else 1
    out = torch.empty_like(x)
    if U == 0 or C == 0:
        return out
    dev = kernels.require_cuda("cumsum_ds", dict(x=x))
    scratch = torch.empty((max(_roots_floats(U, C), 2),),
                          dtype=torch.float32, device=dev)
    tickets = _tickets(x, -(-C // min(C, CUMSUM_DS_GROUP)))
    rc = kernels.library().kai_cumsum_ds(
        kernels.ptr(x), U, C, kernels.ptr(scratch), kernels.ptr(tickets),
        kernels.ptr(out), kernels.stream_of(x))
    kernels.check(rc, "cumsum_ds")
    kernels.count_launch("cumsum_ds")
    return out
