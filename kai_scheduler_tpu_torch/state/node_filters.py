"""Node-filter classes: the wide predicate surface, host-evaluated.

The reference filters each (pod, node) pair through the upstream
kube-scheduler plugins — TaintToleration, NodeAffinity, InterPodAffinity
(``k8s_internal/predicates/predicates.go:70-140``) — an irregular,
string-matching computation that has no good dense-tensor form.  The
TPU-native design exploits the same redundancy the reference's
scheduling-signature skip list does (``actions/common/
minimal_job_comparison.go``): pods overwhelmingly share identical filter
specs (one pod template per gang), so the *distinct* specs form a small
vocabulary.  At snapshot build each distinct spec is evaluated against
every node ONCE on the host, yielding

- ``filter_masks``  bool [X, N] — hard feasibility per (spec, node)
- ``soft_scores``   f32  [X, N] — the soft bands (PreferNoSchedule taint
  penalty + preferred pod-affinity), pre-weighted into the K8sPlugins
  score band (``plugins/scores/scores.go`` K8sPlugins = 1e5)

and every task carries its spec's class id.  The device kernels then pay
ONE gather per task instead of re-running string matches per node —
irregular logic runs once per distinct spec, regular lookup runs on the
accelerator.

Class 0 is always the empty spec (no tolerations, no affinity): its mask
still excludes nodes with untolerated hard taints, which is what keeps
plain pods off control-plane/maintenance nodes.

IN-CYCLE AFFINITY SEMANTICS: required (anti-)affinity vs RUNNING pods
is evaluated here at snapshot build — BOTH directions: the incoming
pod's own terms against running pods, and running pods' required anti
terms against the incoming pod's labels (upstream InterPodAffinity's
existing-pod check), the latter via the ``reverse_labels`` component
of the spec key.  Required anti-affinity BETWEEN gangs placed in the
SAME cycle — mutual ("one db per node/rack"), asymmetric (only one
side carries the term; forward and reverse), and NodePorts conflicts
between two pending pods — is enforced in-cycle through the
exclusion-term rows the snapshot emits (``GangState.anti_marks`` /
``anti_avoids``) and the cycle's claimed-domain table
(``AllocationResult.anti_used``), which ALL placement actions honour:
the allocate wavefront and the victim actions' placements alike (see
``AllocateConfig.anti_groups``).  The slot dimension is sized from the
snapshot (every distinct term row gets a slot — see ``ANTI_SLOTS``),
so no exclusion term is ever dropped.  Required POSITIVE affinity
toward a gang placed in the same cycle is enforced through ATTRACTION
rows in the same table (``GangState.attract_needs``): the depender's
static fold is lifted and it may only place into domains a running
match or an in-cycle anchor claimed (``AllocateConfig.attract_groups``),
so anchor + depender arriving in one cycle co-land.

A verbatim copy of the reference module of the same name in
``kai_scheduler_tpu.state``, kept in the PyTorch port so that the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..apis import types as apis

#: score-band ceiling and weight (ref plugins/scores/scores.go)
_MAX_BAND = 9.0
_W_K8S = 100_000.0

_HARD_EFFECTS = ("NoSchedule", "NoExecute")


def pod_filter_spec(pod: apis.Pod, dra: tuple = (),
                    volume: tuple = (),
                    reverse_labels: tuple = ()) -> tuple:
    """Canonical hashable key of a pod's node-filter spec.

    ``dra`` carries the pod's resolved DeviceClass constraints —
    ``(min_memory_gib, ((label, value), ...))`` — and ``volume`` its
    resolved VolumeBinding label constraints (bound-PVC node affinity ∪
    unbound classes' allowedTopologies), so DRA and storage node
    selection (ref ``plugins/dynamicresources`` and the VolumeBinding
    predicate) ride the same vocabulary.  ``host_ports`` feed the
    NodePorts predicate.  ``reverse_labels`` is the pod's label subset
    that any RUNNING pod's required anti-affinity selector could match
    (upstream InterPodAffinity also enforces EXISTING pods' anti terms
    against the incoming pod — the "reverse" direction); restricting to
    the keys those selectors mention keeps the vocabulary small.
    """
    aff = tuple(sorted(
        (e.key, e.operator, tuple(e.values)) for e in pod.node_affinity))
    tol = tuple(sorted(
        (t.key or "", t.operator, t.value, t.effect or "")
        for t in pod.tolerations))
    pa = tuple(sorted(
        (term.match_labels, term.topology_key, term.anti, term.required)
        for term in pod.pod_affinity))
    return (aff, tol, pa, dra, volume, tuple(sorted(pod.host_ports)),
            reverse_labels)


EMPTY_SPEC = ((), (), (), (), (), (), ())


@dataclasses.dataclass
class _RunningPodView:
    """What pod-affinity / NodePorts terms need to know about existing
    pods."""

    labels: dict[str, str]
    node: int  # snapshot node index, -1 unknown
    host_ports: tuple = ()
    #: the pod's REQUIRED ANTI terms as (match_labels, topology_key) —
    #: enforced in reverse against incoming pods (upstream
    #: InterPodAffinity's existing-pod anti-affinity check)
    anti_terms: tuple = ()


def reverse_anti_keys(running_pods) -> frozenset:
    """Label KEYS mentioned by any running pod's required anti-affinity
    selector — the subset of an incoming pod's labels that can decide
    the reverse InterPodAffinity check (everything else is irrelevant,
    which keeps the filter-class vocabulary from growing per pod)."""
    keys: set[str] = set()
    for pod in running_pods:
        for term in pod.pod_affinity:
            if term.required and term.anti:
                keys.update(k for k, _ in term.match_labels)
    return frozenset(keys)


def _domain_ids(node_topo: np.ndarray, topo_levels: list[str],
                topology_key: str, num_nodes: int) -> np.ndarray:
    """i32 [N]: the domain each node belongs to at ``topology_key``'s
    level; unknown keys mean per-node (hostname) granularity."""
    if topology_key in topo_levels:
        return node_topo[:num_nodes, topo_levels.index(topology_key)]
    return np.arange(num_nodes, dtype=np.int32)


def evaluate_filter_classes(
    specs: list[tuple],
    pods_by_spec: dict[tuple, apis.Pod],
    live_nodes: list[apis.Node],
    node_topo: np.ndarray,          # i32 [N_padded, L]
    topo_levels: list[str],
    running: list[_RunningPodView],
    num_nodes_padded: int,
    incycle_pos_terms: frozenset = frozenset(),
) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate every distinct spec against every node.

    Returns (filter_masks bool [X, N_padded], soft_scores f32
    [X, N_padded]); padded node slots are masked False.
    """
    X = len(specs)
    N = len(live_nodes)
    masks = np.zeros((X, num_nodes_padded), bool)
    soft = np.zeros((X, num_nodes_padded), np.float32)
    # host-port occupancy per node (NodePorts input), built once
    used_ports: dict[int, set] = {}
    for rp in running:
        if rp.node >= 0 and rp.host_ports:
            used_ports.setdefault(rp.node, set()).update(rp.host_ports)
    # reverse-anti exclusion masks, hoisted: per distinct running-side
    # required anti term, the nodes whose domain hosts a carrier — an
    # incoming pod matching the selector is excluded from them (one [N]
    # mask per term instead of a domain rebuild per spec × running pod)
    rev_excl: dict[tuple, np.ndarray] = {}
    for rv in running:
        if rv.node < 0:
            continue
        for ml, tkey in rv.anti_terms:
            doms = _domain_ids(node_topo, topo_levels, tkey, N)
            d = doms[rv.node]
            if d < 0:
                continue
            cur = rev_excl.setdefault((ml, tkey), np.zeros((N,), bool))
            cur |= doms == d

    for xi, spec in enumerate(specs):
        pod = pods_by_spec[spec]
        mask = np.ones((N,), bool)
        prefer_penalty = np.zeros((N,), np.float32)
        # --- taints vs tolerations (upstream TaintToleration) ------------
        for ni, node in enumerate(live_nodes):
            for taint in node.taints:
                tolerated = any(t.tolerates(taint) for t in pod.tolerations)
                if tolerated:
                    continue
                if taint.effect in _HARD_EFFECTS:
                    mask[ni] = False
                elif taint.effect == "PreferNoSchedule":
                    prefer_penalty[ni] += 1.0
        # --- node affinity expressions (upstream NodeAffinity) -----------
        if pod.node_affinity:
            for ni, node in enumerate(live_nodes):
                if mask[ni] and not all(
                        e.matches(node.labels) for e in pod.node_affinity):
                    mask[ni] = False
        # --- DRA DeviceClass constraints (plugins/dynamicresources) ------
        if len(spec) > 3 and spec[3]:
            min_mem, sel_items = spec[3]
            for ni, node in enumerate(live_nodes):
                if not mask[ni]:
                    continue
                if min_mem > 0 and node.accel_memory_gib < min_mem:
                    mask[ni] = False
                elif any(node.labels.get(k) != v for k, v in sel_items):
                    mask[ni] = False
        # --- VolumeBinding: bound-PVC affinity / class topology ----------
        # the hostname key falls back to the node NAME, so volumes the
        # binder pinned per-node stay reachable on unlabeled nodes
        if len(spec) > 4 and spec[4]:
            for ni, node in enumerate(live_nodes):
                if mask[ni] and any(
                        node.labels.get(k, node.name
                                        if k == "kubernetes.io/hostname"
                                        else None) != v
                        for k, v in spec[4]):
                    mask[ni] = False
        # --- NodePorts: requested host ports must be free on the node ---
        if len(spec) > 5 and spec[5]:
            want = set(spec[5])
            for ni in range(N):
                if mask[ni] and want & used_ports.get(ni, set()):
                    mask[ni] = False
        # --- REVERSE required anti-affinity: a running pod's own anti
        # term excludes incoming pods matching its selector from its
        # domain (upstream InterPodAffinity's existingAntiAffinity check)
        if len(spec) > 6 and spec[6]:
            own_labels = dict(spec[6])
            for (ml, _tkey), excl in rev_excl.items():
                if all(own_labels.get(k) == v for k, v in ml):
                    mask &= ~excl
        # --- inter-pod (anti-)affinity (upstream InterPodAffinity) -------
        pref_aff = np.zeros((N,), np.float32)
        for term_key in spec[2]:
            match_labels, topology_key, anti, required = term_key
            term = apis.PodAffinityTerm(
                match_labels=match_labels, topology_key=topology_key,
                anti=anti, required=required)
            doms = _domain_ids(node_topo, topo_levels, topology_key, N)
            dmax = int(doms.max(initial=-1)) + 1
            counts = np.zeros((max(dmax, 1),), np.int64)
            for rp in running:
                if rp.node >= 0 and rp.node < N and term.selects(rp.labels):
                    d = doms[rp.node]
                    if d >= 0:
                        counts[d] += 1
            node_counts = np.where(doms >= 0, counts[np.maximum(doms, 0)], 0)
            if required:
                if anti:
                    mask &= node_counts == 0
                elif (match_labels, topology_key) not in incycle_pos_terms:
                    mask &= node_counts > 0
                # else: a PENDING anchor exists — enforced through the
                # cycle's claimed-domain table (GangState.attract_needs;
                # running matches pre-marked in attract_static)
            else:
                pref_aff += (-node_counts if anti
                             else node_counts).astype(np.float32)
        # --- soft bands, normalized into [0, MAX_BAND] --------------------
        band = np.zeros((N,), np.float32)
        pmax = prefer_penalty.max(initial=0.0)
        if pmax > 0:  # fewer untolerated PreferNoSchedule taints = better
            band += _MAX_BAND * (pmax - prefer_penalty) / pmax
        lo, hi = pref_aff.min(initial=0.0), pref_aff.max(initial=0.0)
        if hi > lo:  # more preferred-affinity matches = better
            band += _MAX_BAND * (pref_aff - lo) / (hi - lo)
        masks[xi, :N] = mask
        soft[xi, :N] = np.clip(band, 0.0, _MAX_BAND) * _W_K8S
    return masks, soft


def anti_self_term(pod: apis.Pod, topo_levels: list[str],
                   num_levels: int) -> tuple[int, tuple]:
    """(level, term key) of the WINNING self-selecting required anti
    term: the gang-internal spread constraint (two pods of the gang may
    not share a domain at this level; ``num_levels`` = per-node, -1 =
    none), and the key that identifies the CROSS-GANG anti group — two
    gangs carrying the SAME winning (selector, level) term and matching
    it mutually must not share a domain within a cycle (ref
    InterPodAffinity over virtually-allocated session state).

    One group slot per gang: when a pod carries SEVERAL self-selecting
    terms, only the coarsest one defines the group, so a peer sharing
    only a finer term is not in-cycle-excluded against it (that pair
    converges next cycle through the filter masks, like asymmetric
    terms).  Coarsest-first is the conservative pick — it is the widest
    exclusion the gang itself demands."""
    best, key = -1, ()
    for term in pod.pod_affinity:
        if not (term.required and term.anti and term.selects(pod.labels)):
            continue
        if term.topology_key in topo_levels:
            lvl = topo_levels.index(term.topology_key)
        else:
            lvl = num_levels  # per-node
        cand = (term.match_labels, lvl)
        # deterministic: coarsest level wins, smallest key on ties
        if best < 0 or lvl < best or (lvl == best and cand < key):
            best, key = lvl, cand
    return best, key
