"""The port's predicate, scoring and ordering functions (and the allocate
helpers they feed) against the JAX reference's, one function at a time,
on numpy-random node tables and tasks: every output bit-equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kai_scheduler_tpu.state.cluster_state as ref_cs
from kai_scheduler_tpu.ops import allocate as ref_alloc
from kai_scheduler_tpu.ops import ordering as ref_ord
from kai_scheduler_tpu.ops import predicates as ref_pred
from kai_scheduler_tpu.ops import scoring as ref_score
from kai_scheduler_tpu.state.synthetic import make_cluster as ref_make
from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.ops import ordering, predicates, scoring
from kai_scheduler_tpu_torch.state import cluster_state as port_cs
from kai_scheduler_tpu_torch.state import state_from_numpy
from jax_executables import release_jax_executables  # noqa: F401

SECTIONS = ("nodes", "queues", "gangs", "running")


def random_nodes(seed: int, N: int = 37, K: int = 3, D: int = 4, X: int = 3):
    """NodeState leaves: mixed accel/cpu-only nodes, partial and
    fractional free pools, releasing capacity, invalid padding, labels,
    per-device shares, filter classes and soft bands."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    accel = rng.choice([0.0, 4.0, 8.0], N).astype(f32)
    alloc = np.stack([accel, rng.choice([16.0, 64.0], N),
                      rng.choice([64.0, 256.0], N)], 1).astype(f32)
    free = (alloc * rng.choice([0.0, 0.25, 0.5, 1.0], (N, 3))).astype(f32)
    free[:, 1] -= rng.random(N).astype(f32).round(2)
    rel = (alloc * rng.choice([0.0, 0.0, 0.25], (N, 3))).astype(f32)
    dev_free = rng.choice([0.0, 0.25, 0.5, 1.0], (N, D)).astype(f32)
    return dict(
        allocatable=alloc, free=free, releasing=rel,
        valid=rng.random(N) < 0.9,
        labels=rng.integers(-1, 3, (N, K)).astype(np.int32),
        topology=rng.integers(-1, 4, (N, 2)).astype(np.int32),
        device_free=dev_free,
        device_releasing=(rng.random((N, D)) < 0.2).astype(f32) * 0.5,
        device_memory_gib=rng.choice([16.0, 40.0, 80.0], N).astype(f32),
        filter_masks=rng.random((X, N)) < 0.8,
        soft_scores=(rng.integers(0, 3, (X, N)) * 1e5).astype(f32),
        extended_free=np.zeros((N, 1), f32),
        extended_releasing=np.zeros((N, 1), f32),
    )


def random_tasks(seed: int, n: int = 9, K: int = 3, X: int = 3):
    rng = np.random.default_rng(seed + 100)
    req = np.stack([rng.choice([0.0, 1.0, 2.0, 4.0], n),
                    rng.choice([0.5, 1.0, 8.0], n),
                    rng.choice([1.0, 4.0, 32.0], n)], 1).astype(np.float32)
    portion = np.where(rng.random(n) < 0.3, 0.5, 0.0).astype(np.float32)
    mem = np.where((portion == 0) & (rng.random(n) < 0.3), 20.0,
                   0.0).astype(np.float32)
    return dict(req=req,
                selector=rng.integers(-1, 3, (n, K)).astype(np.int32),
                portion=portion, mem=mem,
                cls=rng.integers(0, X, n).astype(np.int32))


def both(seed):
    leaves = random_nodes(seed)
    ref = ref_cs.NodeState(**{k: jnp.asarray(v) for k, v in leaves.items()})
    port = port_cs.NodeState(**{k: torch.from_numpy(v)
                                for k, v in leaves.items()})
    tasks = random_tasks(seed)
    return ref, port, tasks, {k: torch.from_numpy(v) for k, v in
                              tasks.items()}


def same(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", range(4))
def test_predicate_masks(seed):
    rn, pn, t, tt = both(seed)
    same(ref_pred.selector_mask(rn.labels, t["selector"]),
         predicates.selector_mask(pn.labels, tt["selector"]))
    same(ref_pred.resource_fit_mask(rn.free, t["req"]),
         predicates.resource_fit_mask(pn.free, tt["req"]))
    same(ref_pred.node_portion(rn, t["portion"], t["mem"]),
         predicates.node_portion(pn, tt["portion"], tt["mem"]))
    for rel in (False, True):
        same(ref_pred.accel_fit_mask(rn, t["req"], t["portion"], t["mem"],
                                     rn.device_free, rel),
             predicates.accel_fit_mask(pn, tt["req"], tt["portion"],
                                       tt["mem"], pn.device_free, rel))
        same(ref_pred.feasible_nodes(rn, t["req"], t["selector"],
                                     t["portion"], t["mem"],
                                     task_class=t["cls"],
                                     include_releasing=rel),
             predicates.feasible_nodes(pn, tt["req"], tt["selector"],
                                       tt["portion"], tt["mem"],
                                       task_class=tt["cls"],
                                       include_releasing=rel))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("devices", [False, True])
def test_feasible_nodes_dual(seed, devices):
    rn, pn, t, tt = both(seed)
    extra = np.random.default_rng(seed).choice(
        [0.0, 1.0], rn.free.shape).astype(np.float32)
    extra_d = np.zeros(rn.device_free.shape, np.float32)
    for i in range(t["req"].shape[0]):
        want = ref_pred.feasible_nodes_dual(
            rn, t["req"][i], t["selector"][i], t["portion"][i], t["mem"][i],
            free=rn.free, device_free=rn.device_free, extra_releasing=extra,
            extra_device_releasing=extra_d, devices=devices,
            task_class=t["cls"][i])
        got = predicates.feasible_nodes_dual(
            pn, tt["req"][i], tt["selector"][i], tt["portion"][i],
            tt["mem"][i], free=pn.free, device_free=pn.device_free,
            extra_releasing=torch.from_numpy(extra),
            extra_device_releasing=torch.from_numpy(extra_d),
            devices=devices, task_class=tt["cls"][i])
        for w, g in zip(want, got):
            same(w, g)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("binpack", [True, False])
def test_score_bands(seed, binpack):
    rn, pn, t, tt = both(seed)
    fit_i = ref_pred.feasible_nodes(rn, t["req"], t["selector"],
                                    task_class=t["cls"])
    fit_p = ref_pred.feasible_nodes(rn, t["req"], t["selector"],
                                    task_class=t["cls"],
                                    include_releasing=True)
    fi, fp = (torch.from_numpy(np.array(fit_i)),
              torch.from_numpy(np.array(fit_p)))
    na = np.array(rn.free + rn.releasing)
    for r in (0, 1):
        same(ref_score.density_score(na[:, r], rn.allocatable[:, r], fit_p,
                                     binpack=binpack),
             scoring.density_score(torch.from_numpy(na[:, r]),
                                   pn.allocatable[:, r], fp,
                                   binpack=binpack))
    rcfg = ref_score.PlacementConfig(binpack_accel=binpack,
                                     binpack_cpu=not binpack)
    pcfg = scoring.PlacementConfig(binpack_accel=binpack,
                                   binpack_cpu=not binpack)
    same(ref_score.placement_score(rn, rn.free, t["req"], fit_p, rcfg),
         scoring.placement_score(pn, pn.free, tt["req"], fp, pcfg))
    same(ref_score.resource_type_score(rn, t["req"]),
         scoring.resource_type_score(pn, tt["req"]))
    same(ref_score.availability_score(fit_i),
         scoring.availability_score(fi))
    extra = np.random.default_rng(seed).random(fp.shape).astype(np.float32)
    same(ref_score.score_nodes_for_task(rn, rn.free, t["req"], fit_i, fit_p,
                                        rcfg, extra=extra),
         scoring.score_nodes_for_task(pn, pn.free, tt["req"], fi, fp, pcfg,
                                      extra=torch.from_numpy(extra)))
    same(ref_score.compose_scores(fit_p, extra, extra),
         scoring.compose_scores(fp, torch.from_numpy(extra),
                                torch.from_numpy(extra)))


@pytest.mark.parametrize("seed", range(3))
def test_replica_count(seed):
    rn, pn, t, tt = both(seed)
    avail = rn.free + rn.releasing
    mask = np.random.default_rng(seed).random((t["req"].shape[0],
                                               rn.free.shape[0])) < 0.7
    got = A._replica_count(pn.free + pn.releasing, tt["req"],
                           torch.from_numpy(mask))
    for i in range(t["req"].shape[0]):
        same(ref_alloc._replica_count(avail, t["req"][i], mask[i]), got[i])


@pytest.mark.parametrize("B,T", [(8, 4), (64, 8), (256, 32)])
def test_sparse_accept_plain_matches_reference(B, T):
    """K4's plain version vs the reference's ``sparse_accept_first_bad``
    (with its entry tables), on claims that overrun some nodes."""
    rng = np.random.default_rng(B * T)
    N = 97
    nodes_b = np.where(rng.random((B, T)) < 0.8,
                       rng.integers(0, N, (B, T)), -1).astype(np.int32)
    ent_ok = (rng.random((B, T)) < 0.9) & (nodes_b >= 0)
    pipe_b = rng.random((B, T)) < 0.3
    req_b = rng.choice([1.0, 2.0, 4.0], (B, 3)).astype(np.float32)
    free = rng.integers(0, 12 * T, (N, 3)).astype(np.float32)
    pool = free + rng.integers(0, 8, (N, 3)).astype(np.float32)
    want = ref_alloc.sparse_accept_first_bad(
        jnp.asarray(nodes_b), jnp.asarray(ent_ok), jnp.asarray(pipe_b),
        jnp.asarray(req_b), jnp.asarray(free), jnp.asarray(pool), N)
    got = A.sparse_accept_plain(*(torch.from_numpy(a) for a in (
        nodes_b, ent_ok, pipe_b, req_b, free, pool)), N)
    for w, g in zip(want, got):
        same(w, g)


def test_chain_membership():
    parent = np.array([-1, -1, 0, 0, 1, 2, 5, -1, 3], np.int32)
    for levels in (1, 2, 3, 4):
        same(ref_alloc._chain_membership(jnp.asarray(parent), levels),
             A._chain_membership(torch.from_numpy(parent), levels))


@pytest.mark.parametrize("seed", range(5))
def test_lexsort_matches_jnp_lexsort(seed):
    rng = np.random.default_rng(seed)
    n = 64
    keys = (rng.integers(0, 3, n).astype(np.float32),
            -rng.integers(0, 2, n).astype(np.float32),   # -0.0 and -1.0
            rng.choice([0.0, 0.5, 1.0], n).astype(np.float32),
            rng.integers(0, 2, n).astype(np.float32))
    same(np.asarray(jnp.lexsort(keys)).astype(np.int64),
         ordering.lexsort(tuple(torch.from_numpy(k) for k in keys)))


def _snapshot_pair():
    shape = dict(num_nodes=24, num_gangs=30, tasks_per_gang=4,
                 num_departments=4, queues_per_department=4,
                 priority_spread=3, running_fraction=0.2, seed=5)
    ref_state, _ = ref_cs.build_snapshot(*ref_make(**shape), pad=32)
    leaves = {f"{sec}.{f.name}": np.asarray(getattr(getattr(ref_state, sec),
                                                     f.name))
              for sec in SECTIONS
              for f in dataclasses.fields(getattr(ref_state, sec))}
    return ref_state, state_from_numpy(leaves, "cpu")


@pytest.mark.parametrize("seed", range(3))
def test_queue_and_job_order(seed):
    ref_state, port = _snapshot_pair()
    rng = np.random.default_rng(seed)
    Q, G = port.queues.q, port.gangs.g
    qa = (rng.integers(0, 20, (Q, 3))).astype(np.float32)
    fs = (rng.integers(0, 20, (Q, 3))).astype(np.float32)
    total = np.asarray(ref_state.total_capacity)
    remaining = rng.random(G) < 0.6
    for w, g in zip(
            ref_ord.queue_order_keys(ref_state.queues, qa, fs, total),
            ordering.queue_order_keys(port.queues, torch.from_numpy(qa),
                                      torch.from_numpy(fs),
                                      torch.from_numpy(total.copy()))):
        same(w, g)
    args_r = (ref_state.gangs, ref_state.queues, qa, fs, total, remaining)
    args_p = (port.gangs, port.queues, torch.from_numpy(qa),
              torch.from_numpy(fs), torch.from_numpy(total),
              torch.from_numpy(remaining))
    same(np.asarray(ref_ord.job_order_perm(*args_r)).astype(np.int64),
         ordering.job_order_perm(*args_p))
    assert int(ref_ord.select_next_gang(*args_r)) == int(
        ordering.select_next_gang(*args_p))


def test_jit_reference_is_cpu():
    """The reference side of these comparisons runs on JAX's CPU backend."""
    assert jax.default_backend() == "cpu"
