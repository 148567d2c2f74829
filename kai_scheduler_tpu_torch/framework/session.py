"""Session — the per-cycle unit of work.

Port of ``kai_scheduler_tpu/framework/session.py`` (the classic allocate
cycle's part).  The Session is a value: the tensorized snapshot plus the
solver outputs, and "commit" is a translation from placement tensors back
to BindRequest objects via the SnapshotIndex.

The commit path moves ONE compact array device→host: results pack into
an i16 vector (indices < 32k; bools 8 per lane; the f32 queue tables as
i16 pairs) — the parity surface the port and the reference compare byte
for byte.  The analytics, repack and victim parts of the reference's
commit wait for the slices that port those actions.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..apis import types as apis
from ..device import resolve_device
from ..ops import drf
from ..ops.allocate import AllocateConfig, AllocationResult
from ..state.cluster_state import ClusterState, SnapshotIndex, build_snapshot

#: BindRequest backoff limit (the reference SessionConfig's default)
DEFAULT_BIND_BACKOFF_LIMIT = 3

#: fit_reason code → message (ref ``api/unschedule_info.go`` fit errors)
FIT_REASONS = {
    1: ("no node satisfies the pod requirements "
        "(resources / selector / taints / affinity)"),
    2: "an equivalent pod group already failed this cycle",
    3: "placement attempt failed (capacity or queue gates)",
}


def _bitpack(b: torch.Tensor) -> torch.Tensor:
    """bool [K] → i16 [ceil(K/8)], bit k = element 8i+k (zero-padded)."""
    pad = (-b.shape[0]) % 8
    if pad:
        b = torch.cat([b, torch.zeros((pad,), dtype=torch.bool,
                                      device=b.device)])
    pb = b.reshape(-1, 8).to(torch.int16)
    w = 2 ** torch.arange(8, dtype=torch.int16, device=b.device)
    return (pb * w).sum(-1, dtype=torch.int16)


def _bitunpack(p: "np.ndarray", k: int) -> "np.ndarray":
    return (((p.astype(np.int32)[:, None] >> np.arange(8)) & 1)
            .astype(bool).reshape(-1)[:k])


def _as_i16_pairs(x: torch.Tensor) -> torch.Tensor:
    """f32/i32 → i16 halves in memory order (little-endian: low, high),
    the reference's ``bitcast_convert_type(x, int16).ravel()``."""
    return x.contiguous().view(torch.int16).reshape(-1)


def _pack_commit(result: AllocationResult, state: ClusterState, *,
                 track_devices: bool) -> torch.Tensor:
    """The cycle's results as one i16 vector on the result's device."""
    parts = [
        (result.placements + 1).reshape(-1).to(torch.int16),
        _bitpack(result.pipelined.reshape(-1)),
        _bitpack(result.allocated),
        _bitpack(result.attempted),
        result.fit_reason.to(torch.int16),
        _bitpack(result.victim),
        (result.victim_move + 1).to(torch.int16),
        _as_i16_pairs(result.queue_allocated),
        _as_i16_pairs(state.queues.fair_share),
        _as_i16_pairs(result.wavefront_stats),
    ]
    if track_devices:
        parts.append(
            (result.placement_device + 1).reshape(-1).to(torch.int16))
    return torch.cat(parts)


@dataclasses.dataclass
class SessionConfig:
    """Cycle-level knobs (ref ``conf/scheduler_conf.go``): this slice's
    fields of the reference's SessionConfig."""

    allocate: AllocateConfig = dataclasses.field(
        default_factory=AllocateConfig)
    #: derive the kernel fast-path flags from the snapshot at open
    auto_tune: bool = True
    #: queue-hierarchy depth for fair-share recursion / capacity walks
    num_levels: int = 2
    #: proportion plugin kValue (time-based fairshare coupling)
    k_value: float = 0.0


def _auto_tune(config: SessionConfig, index: SnapshotIndex) -> SessionConfig:
    """Derive the allocate fast-path flags from the snapshot's index hints
    (the reference's ``_auto_tune``, allocate fields only)."""
    if index.max_queue_depth + 1 > config.num_levels:
        config = dataclasses.replace(
            config, num_levels=index.max_queue_depth + 1)
    devices = index.needs_device_table
    # the whole-gang kernel is the sequential greedy under BINPACK only
    uniform = (index.uniform_gangs and not devices
               and config.allocate.placement.binpack_accel
               and config.allocate.placement.binpack_cpu)
    sub_topo = (index.has_subgroup_topology
                or index.has_required_topology)
    return dataclasses.replace(
        config,
        allocate=dataclasses.replace(
            config.allocate, track_devices=devices,
            uniform_tasks=uniform, subgroup_topology=sub_topo,
            extended=index.has_extended_resources,
            dense_feasibility=index.dense_feasibility,
            preferred_topology=index.has_preferred_topology,
            anti_groups=index.has_anti_groups,
            attract_groups=index.has_attract_groups))


@dataclasses.dataclass
class Session:
    """One cycle's snapshot + derived tensors."""

    state: ClusterState
    index: SnapshotIndex
    config: SessionConfig

    @classmethod
    def open(cls, nodes: list[apis.Node], queues: list[apis.Queue],
             pod_groups: list[apis.PodGroup], pods: list[apis.Pod],
             topology: apis.Topology | None = None,
             config: SessionConfig | None = None, *,
             device: "str | torch.device" = "cuda",
             **snapshot_kwargs) -> "Session":
        """OpenSession: snapshot on ``device`` + proportion share
        division."""
        dev = resolve_device(device)
        state, index = build_snapshot(nodes, queues, pod_groups, pods,
                                      topology, device=dev,
                                      **snapshot_kwargs)
        return cls.from_state(state, index, config)

    @classmethod
    def from_state(cls, state: ClusterState, index: SnapshotIndex,
                   config: SessionConfig | None = None) -> "Session":
        """Open a session over an already-built snapshot: auto-tune the
        kernel config from the index hints, then divide fair shares."""
        config = config or SessionConfig()
        if config.auto_tune:
            config = _auto_tune(config, index)
        fair_share = drf.set_fair_share(state, num_levels=config.num_levels,
                                        k_value=config.k_value)
        state = dataclasses.replace(
            state, queues=dataclasses.replace(state.queues,
                                              fair_share=fair_share))
        return cls(state=state, index=index, config=config)

    # -- commit path ------------------------------------------------------

    def gather_host(self, result: AllocationResult) -> dict:
        """ONE compact device→host transfer of the cycle's results, merged
        with the snapshot-side numpy tables the host kept.  The packed i16
        array itself rides along as ``host["packed"]``."""
        g, q, r = self.state.gangs, self.state.queues, self.state.running
        G, T, M, Q = g.g, g.t, r.m, q.q
        R_ = self.state.nodes.free.shape[1]
        if self.state.nodes.n + 1 >= 2**15:
            # silently wrapped i16 node indices would bind pods to the
            # wrong nodes
            raise ValueError("i16 commit packing needs < 32k nodes")
        devices = self.index.needs_device_table
        flat = _pack_commit(result, self.state,
                            track_devices=devices).cpu().numpy()

        def take(n):
            nonlocal off
            part = flat[off:off + n]
            off += n
            return part

        def bits(k):
            return (k + 7) // 8

        off = 0
        out = dict(self.index.host_tables)
        out["packed"] = flat
        out["placements"] = (take(G * T).astype(np.int32) - 1
                             ).reshape(G, T)
        out["pipelined"] = _bitunpack(take(bits(G * T)),
                                      G * T).reshape(G, T)
        out["allocated"] = _bitunpack(take(bits(G)), G)
        out["attempted"] = _bitunpack(take(bits(G)), G)
        out["fit_reason"] = take(G).astype(np.int32)
        out["victim"] = _bitunpack(take(bits(M)), M)
        out["victim_move"] = take(M).astype(np.int32) - 1
        out["queue_allocated"] = np.frombuffer(
            take(Q * R_ * 2).tobytes(), np.float32).reshape(Q, R_)
        out["fair_share"] = np.frombuffer(
            take(Q * R_ * 2).tobytes(), np.float32).reshape(Q, R_)
        out["wavefront_stats"] = np.frombuffer(
            take(2 * 5 * 2).tobytes(), np.int32).reshape(2, 5)
        if devices:
            out["placement_device"] = (take(G * T).astype(np.int32) - 1
                                       ).reshape(G, T)
        else:
            out["placement_device"] = np.full((G, T), -1, np.int32)
        return out

    def bind_requests_from(self, result: AllocationResult,
                           host: dict | None = None
                           ) -> list[apis.BindRequest]:
        """Placement tensors → BindRequest objects (``cache.Bind``
        analogue).  Only allocated gangs bind; pipelined placements wait
        for their capacity to free (``stmt.Pipeline``)."""
        if host is None:
            host = self.gather_host(result)
        placements = host["placements"]
        devices = host["placement_device"]
        allocated = host["allocated"]
        pipelined = host["pipelined"]
        sel = allocated[:, None] & (placements >= 0) & ~pipelined
        sel[len(self.index.gang_names):] = False
        gi, ti = np.nonzero(sel)
        names = self.index.task_names_arr[gi, ti]
        keep = names != None  # noqa: E711  (object-array elementwise)
        if not keep.all():
            gi, ti, names = gi[keep], ti[keep], names[keep]
        node_names = self.index.node_names_arr[placements[gi, ti]]
        portion = host["task_portion"][gi, ti]
        mem = host["task_accel_mem"][gi, ti]
        is_frac = (portion > 0) | (mem > 0)
        count = np.where(
            is_frac, 0,
            np.rint(host["task_req0"][gi, ti]).astype(np.int64))
        dev = devices[gi, ti]
        dra = host["task_dra"][gi, ti]
        claims = self.index.claims_by_pod
        frac_t = apis.ReceivedResourceType.FRACTION
        reg_t = apis.ReceivedResourceType.REGULAR
        return [
            apis.BindRequest(
                pod_name=nm,
                selected_node=nn,
                received_resource_type=frac_t if fr else reg_t,
                received_accel_portion=po,
                received_accel_memory_gib=me,
                received_accel_count=ct,
                selected_accel_groups=[dv] if dv >= 0 else [],
                resource_claim_allocations=(
                    claims.get(nm) or list(range(dr))),
                backoff_limit=DEFAULT_BIND_BACKOFF_LIMIT,
            )
            for nm, nn, fr, po, me, ct, dv, dr in zip(
                names.tolist(), node_names.tolist(), is_frac.tolist(),
                portion.tolist(), mem.tolist(), count.tolist(),
                dev.tolist(), dra.tolist())
        ]

    def unschedulable_explanations(self, host: dict) -> dict[str, str]:
        """Per-gang fit-failure messages for gangs that ended the cycle
        unplaced — the UnschedulableExplanation surface."""
        reasons, allocated = host["fit_reason"], host["allocated"]
        out: dict[str, str] = {}
        ng = len(self.index.gang_names)
        for gi in np.nonzero((reasons[:ng] != 0) & ~allocated[:ng])[0]:
            out[self.index.gang_names[gi]] = FIT_REASONS.get(
                int(reasons[gi]), f"code {int(reasons[gi])}")
        return out
