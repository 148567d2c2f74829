"""Session — the per-cycle unit of work.

Port of ``kai_scheduler_tpu/framework/session.py`` (the classic allocate
cycle's part).  The Session is a value: the tensorized snapshot plus the
solver outputs, and "commit" is a translation from placement tensors back
to BindRequest objects via the SnapshotIndex.

The commit path moves ONE compact array device→host: results pack into
an i16 vector (indices < 32k; bools 8 per lane; the f32 queue tables as
i16 pairs) — the parity surface the port and the reference compare byte
for byte.  The victim actions' part of the commit — evictions and the
pipelined rebinds of consolidation-moved pods — decodes from the same
transfer, and so do an analytics cycle's cluster-health bundle
(``ops/analytics.py``) and a repack firing's migration plan
(``ops/repack.py``), whose moves commit through the same pipelined rebind
as consolidation moves.  A resident cycle (``framework/scheduler.py``
``resident_cycle``) packs the commit itself; its Session
(:meth:`Session.resident`) reads shapes and the gang table from the
snapshotter's host mirror and syncs that one packed array.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..apis import types as apis
from ..device import resolve_device
from ..ops import analytics as pulse
from ..ops import drf
from ..ops.allocate import AllocateConfig, AllocationResult
from ..ops.victims import VictimConfig
from ..runtime import compile_watch
from ..runtime import wire_ledger as _wire
from ..state.cluster_state import (ClusterState, SnapshotIndex, _pow2_ceil,
                                   build_snapshot)

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
                 track_devices: bool,
                 analytics: "pulse.AnalyticsBundle | None" = None,
                 repack_plan=None) -> torch.Tensor:
    """The cycle's results as one i16 vector on the result's device; an
    analytics bundle and a repack plan, when given, ride at its end (their
    f32/i32 fields as i16 pairs: pod indices can exceed i16)."""
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
    if analytics is not None:
        a32, ai = pulse.flatten(analytics)
        parts += [_as_i16_pairs(a32), _as_i16_pairs(ai)]
    if repack_plan is not None:
        p = repack_plan
        ints = torch.stack([p.num_moves, p.target_gang, p.target_rack,
                            p.feasible.to(torch.int32)])
        fls = torch.stack([p.needed, p.rack_units_before,
                           p.rack_units_after, p.total_units])
        parts += [_as_i16_pairs(p.move_pod), _as_i16_pairs(p.move_node),
                  _as_i16_pairs(ints), _as_i16_pairs(fls)]
    return torch.cat(parts)


#: the watched entries of the classic cycle (``runtime/compile_watch.py``);
#: the resident cycle calls the unwatched bodies
_pack_commit_watched = compile_watch.watch("pack_commit", _pack_commit)
_set_fair_share = compile_watch.watch(
    "set_fair_share",
    lambda state, **kw: drf.set_fair_share(state, **kw))


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
    victims: VictimConfig = dataclasses.field(default_factory=VictimConfig)
    #: stalegangeviction grace period (ref options.go:34, default 60s)
    stale_grace_s: float = 60.0
    #: cluster-health pass knobs (ops/analytics.py); the cadence is the
    #: Scheduler's ``analytics_every``
    analytics: pulse.AnalyticsConfig = dataclasses.field(
        default_factory=pulse.AnalyticsConfig)


def _pow4_ceil(x: int) -> int:
    b = 1
    while b < int(x):
        b <<= 2
    return b


def _preempt_lane_width(batch_size: int, num_pending: int,
                        num_leaf_queues: int, padded_nodes: int) -> int:
    """Victim-wavefront lane width for preempt (the reference's auto-tuning
    v2, verbatim): one lane per live preemptor up to a B*N memory bound,
    bucketed to powers of four."""
    cap = 512
    while cap > 64 and cap * max(padded_nodes, 1) > (1 << 22):
        cap //= 2
    if num_pending < 0:
        spread = num_leaf_queues if num_leaf_queues > 64 else batch_size
    else:
        spread = max(num_pending, 1)
    return max(1, min(cap, _pow4_ceil(spread)))


def _sparse_unit_width(padded_pods: int, num_leaf_queues: int) -> int:
    """Compact victim-table width when ``VictimConfig.sparse_unit_k`` is
    None (the reference's rule, verbatim)."""
    per_leaf = padded_pods // max(num_leaf_queues, 1)
    return max(256, min(1024, _pow2_ceil(4 * max(per_leaf, 1))))


def _auto_tune(config: SessionConfig, index: SnapshotIndex,
               padded_nodes: int, padded_running: int) -> SessionConfig:
    """Derive the kernel fast-path flags and wavefront widths from the
    snapshot's index hints and padded shapes (the reference's
    ``_auto_tune``, verbatim), so the port runs the reference's static
    config."""
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
    flags = dict(track_devices=devices, uniform_tasks=uniform,
                 subgroup_topology=sub_topo,
                 extended=index.has_extended_resources,
                 dense_feasibility=index.dense_feasibility,
                 preferred_topology=index.has_preferred_topology,
                 anti_groups=index.has_anti_groups,
                 attract_groups=index.has_attract_groups)
    v = config.victims
    return dataclasses.replace(
        config,
        allocate=dataclasses.replace(config.allocate, **flags),
        victims=dataclasses.replace(
            v, chunk_reclaim=not index.has_reclaim_minruntime,
            batch_size_preempt=(
                _preempt_lane_width(v.batch_size, index.num_pending_gangs,
                                    index.num_leaf_queues, padded_nodes)
                if v.batch_size_preempt is None else v.batch_size_preempt),
            sparse_unit_k=(
                _sparse_unit_width(padded_running, index.num_leaf_queues)
                if v.sparse_unit_k is None else v.sparse_unit_k),
            placement=dataclasses.replace(v.placement, **flags)))


@dataclasses.dataclass
class Session:
    """One cycle's snapshot + derived tensors."""

    state: ClusterState | None
    index: SnapshotIndex
    config: SessionConfig
    #: the incremental snapshotter's host mirror (numpy leaves keyed by
    #: dotted path) when the cycle has one; resident cycles read shapes
    #: and host tables from it, never from the device state
    host_state: dict | None = None

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
            config = _auto_tune(config, index, state.nodes.n,
                                state.running.m)
        fair_share = _set_fair_share(state, num_levels=config.num_levels,
                                     k_value=config.k_value)
        state = dataclasses.replace(
            state, queues=dataclasses.replace(state.queues,
                                              fair_share=fair_share))
        return cls(state=state, index=index, config=config)

    @classmethod
    def resident(cls, index: SnapshotIndex,
                 config: SessionConfig | None = None,
                 host_state: dict | None = None) -> "Session":
        """Open a session for a resident cycle: the snapshot is already on
        the device and the whole chain — fair-share division included —
        runs inside ``resident_cycle``, so this constructor launches
        nothing.  Auto-tuning reads the host mirror's padded shapes
        (identical to the device state's); ``state`` is assigned by the
        scheduler after the resident cycle returns the post-delta
        state."""
        config = config or SessionConfig()
        if config.auto_tune and host_state is not None:
            config = _auto_tune(config, index,
                                host_state["nodes.valid"].shape[0],
                                host_state["running.valid"].shape[0])
        return cls(state=None, index=index, config=config,
                   host_state=host_state)

    # -- commit path ------------------------------------------------------

    def _gangs_queue_host(self) -> "np.ndarray":
        """The gang→queue column as host numpy — from the host mirror when
        there is one, else one small device read after the commit
        synced."""
        if self.host_state is not None:
            return self.host_state["gangs.queue"]
        return self.state.gangs.queue.cpu().numpy()

    def gather_host(self, result: AllocationResult,
                    analytics: "pulse.AnalyticsBundle | None" = None, *,
                    packed: torch.Tensor | None = None,
                    packed_analytics: bool = False,
                    repack_plan=None) -> dict:
        """ONE compact device→host transfer of the cycle's results, merged
        with the snapshot-side numpy tables the host kept.  The packed i16
        array itself rides along as ``host["packed"]``; an analytics bundle
        decodes into ``host["analytics"]`` and a repack plan into
        ``host["repack_plan"]``.

        A resident cycle passes ``packed=``, the i16 commit its
        ``resident_cycle`` already produced (``packed_analytics`` says
        whether the analytics bundle rides it), and this method only syncs
        that array.  A repack plan on a resident cycle was solved after
        the pack, so it is read back as one accounted ledger readback."""
        g, q, r = self.state.gangs, self.state.queues, self.state.running
        G, T, M, Q = g.g, g.t, r.m, q.q
        R_ = self.state.nodes.free.shape[1]
        if self.state.nodes.n + 1 >= 2**15:
            # silently wrapped i16 node indices would bind pods to the
            # wrong nodes
            raise ValueError("i16 commit packing needs < 32k nodes")
        devices = self.index.needs_device_table
        plan_from_pack = repack_plan is not None and packed is None
        if packed is None:
            has_analytics = analytics is not None
            flat = _pack_commit_watched(
                result, self.state, track_devices=devices,
                analytics=analytics,
                repack_plan=repack_plan).cpu().numpy()
        else:
            has_analytics = packed_analytics
            flat = packed.cpu().numpy()

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
        if has_analytics:
            acfg = self.config.analytics
            nf = pulse.f32_len(acfg, q=Q, r=R_, g=G)
            ni = pulse.i32_len(acfg, q=Q, r=R_, g=G)
            a32 = np.frombuffer(take(nf * 2).tobytes(), np.float32)
            ai = np.frombuffer(take(ni * 2).tobytes(), np.int32)
            out["analytics"] = pulse.host_unpack(
                a32, ai, config=acfg, q=Q, r=R_, g=G)
        if plan_from_pack:
            P = repack_plan.move_pod.shape[0]
            mp = np.frombuffer(take(2 * P).tobytes(), np.int32)
            mn = np.frombuffer(take(2 * P).tobytes(), np.int32)
            ints = np.frombuffer(take(8).tobytes(), np.int32)
            fls = np.frombuffer(take(8).tobytes(), np.float32)
            out["repack_plan"] = {
                "move_pod": mp, "move_node": mn,
                "num_moves": ints[0], "target_gang": ints[1],
                "target_rack": ints[2], "feasible": bool(ints[3]),
                "needed": fls[0], "rack_units_before": fls[1],
                "rack_units_after": fls[2], "total_units": fls[3]}
        elif repack_plan is not None:
            # resident cycle with a fired trigger: the plan is small and
            # rare — one accounted readback through the ledger
            p = _wire.LEDGER.device_get(
                {f: getattr(repack_plan, f)
                 for f in ("move_pod", "move_node", "num_moves",
                           "target_gang", "target_rack", "feasible",
                           "needed", "rack_units_before",
                           "rack_units_after", "total_units")},
                reason="repack-plan")
            out["repack_plan"] = dict(p, feasible=bool(p["feasible"]))
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

    def evictions_from(self, host: dict) -> list[apis.Eviction]:
        """The victim mask and move targets of the gathered commit →
        Eviction objects (``cache.Evict`` analogue); a consolidation move
        carries its target node."""
        mask = host["victim"].copy()
        mask[len(self.index.running_pod_names):] = False
        mi = np.nonzero(mask)[0]
        names = self.index.running_pod_names_arr[mi]
        keep = names != ""
        if not keep.all():
            mi, names = mi[keep], names[keep]
        gangs = host["running_gang"][mi]
        ng = len(self.index.gang_names)
        ok_g = (gangs >= 0) & (gangs < ng)
        if ng:
            groups = np.where(ok_g, self.index.gang_names_arr[
                np.clip(gangs, 0, ng - 1)], "")
        else:
            groups = np.full(len(mi), "", object)
        targets = [self.index.node_names[m] if m >= 0 else None
                   for m in host["victim_move"][mi].tolist()]
        return [apis.Eviction(pod_name=nm, group=gr, move_to=mv)
                for nm, gr, mv in zip(names.tolist(), groups.tolist(),
                                      targets)]

    def pipelined_rebind(self, cluster, ev: apis.Eviction
                         ) -> apis.BindRequest | None:
        """The pipelined rebind of a consolidation-moved victim on its
        verified target node; None when the pod vanished between solve
        and commit."""
        pod = cluster.pods.get(ev.pod_name)
        if pod is None or ev.move_to is None:
            return None
        is_frac = pod.accel_portion > 0 or pod.accel_memory_gib > 0
        return apis.BindRequest(
            pod_name=pod.name,
            selected_node=ev.move_to,
            received_resource_type=(
                apis.ReceivedResourceType.FRACTION if is_frac
                else apis.ReceivedResourceType.REGULAR),
            received_accel_portion=pod.accel_portion,
            received_accel_memory_gib=pod.accel_memory_gib,
            received_accel_count=(
                0 if is_frac else int(round(pod.resources.accel))),
            backoff_limit=DEFAULT_BIND_BACKOFF_LIMIT,
        )

    #: Eviction.reason of a repack migration (the bind and commit path is
    #: the consolidation move's)
    REPACK_REASON = "repack"

    def repack_evictions(self, plan: dict, host: dict,
                         target_gang: str) -> list[apis.Eviction]:
        """A feasible repack plan (host copies of ``RepackPlan`` fields) →
        evictions with move targets.  Pods the cycle's own victim actions
        already evicted are dropped, and a plan whose target gang placed
        this cycle is discarded whole."""
        gi = int(plan["target_gang"])
        if (not bool(plan["feasible"]) or int(plan["num_moves"]) <= 0
                or not 0 <= gi < len(self.index.gang_names)
                or self.index.gang_names[gi] != target_gang):
            return []
        if host["allocated"][gi]:
            return []
        victim = host["victim"]
        out: list[apis.Eviction] = []
        names = self.index.running_pod_names_arr
        gang_all = host["running_gang"]
        ng = len(self.index.gang_names)
        for pi, ni in zip(plan["move_pod"].tolist(),
                          plan["move_node"].tolist()):
            if pi < 0 or ni < 0 or pi >= len(names) or victim[pi]:
                continue
            name = names[pi]
            if not name:
                continue
            gidx = int(gang_all[pi])
            out.append(apis.Eviction(
                pod_name=name,
                group=(self.index.gang_names[gidx]
                       if 0 <= gidx < ng else ""),
                reason=self.REPACK_REASON,
                move_to=self.index.node_names[ni]))
        return out

    def analytics_doc(self, host: dict, *, alarm_cycles: int = 0) -> dict:
        """The analytics bundle of this cycle's packed commit as a JSON-able
        cluster-health document (``CycleResult.analytics``)."""
        a = host.get("analytics")
        if a is None:
            return {}
        acfg = self.config.analytics
        qnames = self.index.queue_names
        gnames = self.index.gang_names
        reasons = host["fit_reason"]
        queues_of = self._gangs_queue_host()
        drift = a["queue_drift"][:len(qnames)]
        top_q = np.argsort(-drift)[:5]
        oldest = []
        for age, gi in zip(a["starv_age"].tolist(),
                           a["starv_gang"].tolist()):
            if age <= 0 or not 0 <= gi < len(gnames):
                continue
            qi = int(queues_of[gi])
            code = int(reasons[gi])
            oldest.append({
                "gang": gnames[gi],
                "queue": qnames[qi] if 0 <= qi < len(qnames) else "",
                "age_cycles": int(age),
                "blocker": FIT_REASONS.get(code, f"code {code}")
                if code else "",
            })
        names = apis.RESOURCE_NAMES
        return {
            "fragmentation": {
                "score": round(float(a["frag_score"]), 4),
                "total_unit_pods": float(a["total_units"]),
                "largest_rack_unit_pods": float(a["max_rack_units"]),
                "unit_req": list(acfg.unit_req),
                "stranded_free_frac": {
                    names[r]: round(float(v), 4)
                    for r, v in enumerate(a["stranded_frac"].tolist())},
                "free_hist": {
                    names[r]: [int(c) for c in row]
                    for r, row in enumerate(a["free_hist"].tolist())},
                "gang_ladder": [
                    {"pods": int(p), "cluster_feasible": bool(c > 0),
                     "rack_placeable": bool(k > 0)}
                    for p, c, k in zip(acfg.gang_ladder,
                                       a["ladder_cluster_ok"].tolist(),
                                       a["ladder_rack_ok"].tolist())],
            },
            "utilization": {
                names[r]: round(float(v), 4)
                for r, v in enumerate(a["util"].tolist())},
            "goodput": round(float(a["goodput"]), 4),
            "fairness": {
                "drift_max": round(float(a["drift_max"]), 4),
                "drift_mean": round(float(a["drift_mean"]), 4),
                "drift_gini": round(float(a["drift_gini"]), 4),
                "top_drift": [
                    {"queue": qnames[int(qi)],
                     "drift": round(float(drift[int(qi)]), 4)}
                    for qi in top_q if drift[int(qi)] > 0],
            },
            "starvation": {
                "pending_gangs": int(a["pending_gangs"]),
                "alarm_cycles": int(alarm_cycles),
                "oldest": oldest,
            },
        }

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
