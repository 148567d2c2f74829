"""K9's per-chunk node summary (``pertask_summary_plain``, the plain version
of the kernel's prologue) read the way the kernel reads it: for every task
kind, the idle-fit, pipelined-fit and shared-fit bits it gives are
bit-equal to the per-device predicates ``pertask_fill_plain`` evaluates
(``_device_rows``: ``_accel_pool_ok`` on the idle and the pipelined device
rows, ``gpu_sharing_score``; ``resource_fit_mask`` on the node pools).

Seeded pools, and pools at the edges: a device exactly at ``p - EPS`` and
one f32 step below it, at ``1 - EPS`` and one step below, ``-0.0``, a fully
free device beside a partly used one, memory-based portions on nodes of
different device memory; at 1, 8 and 32 devices a node."""
import types

import numpy as np
import pytest
import torch

from kai_scheduler_tpu_torch.ops import allocate as A
from kai_scheduler_tpu_torch.ops.predicates import resource_fit_mask

EPS = A.EPS
F32 = torch.float32

#: task kinds: (portion, accel memory GiB, accel request)
TASKS = [(0.5, 0.0, 0.5), (0.25, 0.0, 0.25), (0.3, 0.0, 0.3),
         (0.0, 24.0, 0.0), (0.0, 10.0, 0.0), (0.0, 0.0, 1.0),
         (0.0, 0.0, 2.0), (0.0, 0.0, 3.0), (0.0, 0.0, 8.0),
         (0.0, 0.0, 0.0)]
MEMORY_GIB = (80.0, 40.0, 24.0, 10.0)


def _below(x: torch.Tensor) -> torch.Tensor:
    return torch.nextafter(x, torch.full_like(x, -np.inf))


def _edge_rows(N: int, D: int, rng) -> torch.Tensor:
    """Device rows at the predicates' edges for every task kind."""
    mem = torch.tensor(MEMORY_GIB, dtype=F32)[torch.arange(N) % 4]
    edges = []
    for por, gib, _ in TASKS:
        if gib > 0:   # the node's own share: memory / device memory
            p = torch.tensor(gib, dtype=F32) / torch.clamp(mem, min=EPS)
        else:
            p = torch.full((N,), por, dtype=F32)
        edges += [p - EPS, _below(p - EPS)]
    one = torch.full((N,), 1.0 - EPS, dtype=F32)
    edges += [one, _below(one), torch.full((N,), -0.0, dtype=F32),
              torch.zeros(N, dtype=F32), torch.ones(N, dtype=F32),
              torch.full((N,), EPS, dtype=F32),
              _below(torch.full((N,), EPS, dtype=F32))]
    pick = torch.from_numpy(rng.integers(0, len(edges), (N, D)))
    table = torch.stack(edges, -1)                          # [N, E]
    # most devices used up (+0.0 or -0.0), one or two at an edge: the
    # row's max is the edge
    used = torch.where(torch.from_numpy(rng.random((N, D)) < 0.5), -0.0,
                       0.0)
    rows = torch.where(torch.from_numpy(rng.random((N, D)) < 1.5 / D),
                       table.gather(1, pick), used)
    # a fully free device beside a partly used one on every fourth node
    if D > 1:
        rows[::4, 0] = 1.0
        rows[::4, 1] = 0.5
    return rows


def _pools(N: int, D: int, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "edges":
        dev = _edge_rows(N, D, rng)
        dev_rel = _edge_rows(N, D, rng)
        extra_dev = torch.where(torch.from_numpy(rng.random((N, D)) < 0.2),
                                torch.full((N, D), 0.5), 0.0)
    else:
        vals = np.array([0.0, 0.25, 0.5, 0.7, 1.0], np.float32)
        dev = torch.from_numpy(rng.choice(vals, (N, D)))
        dev_rel = torch.from_numpy(rng.choice(vals, (N, D), p=[
            0.6, 0.1, 0.1, 0.1, 0.1]))
        extra_dev = torch.from_numpy(rng.choice(vals, (N, D), p=[
            0.8, 0.05, 0.05, 0.05, 0.05]))
    free = torch.from_numpy(rng.choice(
        np.array([0.0, 0.5, 1.0, 2.0, 3.0, 8.0], np.float32), (N, 3)))
    # a node-level pool exactly at a request minus EPS
    free[::5] = torch.tensor([1.0, 2.0, 3.0], dtype=F32) - EPS
    rel = torch.from_numpy(rng.choice(
        np.array([0.0, 0.0, 0.5, 1.0], np.float32), (N, 3)))
    extra = torch.from_numpy(rng.choice(
        np.array([0.0, 0.0, 0.0, 2.0], np.float32), (N, 3)))
    alloc = torch.from_numpy(rng.choice(
        np.array([0.0, 8.0], np.float32), (N, 3), p=[0.2, 0.8]))
    nodes = types.SimpleNamespace(
        releasing=rel, device_releasing=dev_rel, allocatable=alloc,
        valid=torch.from_numpy(rng.random(N) < 0.9),
        device_memory_gib=torch.tensor(MEMORY_GIB, dtype=F32)[
            torch.arange(N) % 4])
    return nodes, free, dev, extra, extra_dev


def _read(summ: torch.Tensor, por: float, mem: float, req0: float):
    """The kernel's reading of the summary for one task (``pf_eval``):
    (idle pool ok, pipelined pool ok, shared fit), bool [N] each."""
    N = summ.shape[1]
    is_frac = por > 0 or mem > 0
    if is_frac:
        dmem = summ[13]
        p = (torch.tensor(mem, dtype=F32) / dmem if mem > 0
             else torch.tensor(por, dtype=F32) * torch.ones(N, dtype=F32))
        pm = p - EPS
        return summ[8] >= pm, summ[10] >= pm, summ[12] >= pm
    r = torch.tensor(req0, dtype=F32)
    return summ[9] >= r, summ[11] >= r, torch.zeros(N, dtype=torch.bool)


@pytest.mark.parametrize("kind", ["seeded", "edges"])
@pytest.mark.parametrize("D", [1, 8, 32])
def test_summary_fit_bits_equal_the_per_device_predicates(D, kind):
    N = 96
    nodes, free, dev, extra, extra_dev = _pools(N, D, kind, seed=D)
    summ = A.pertask_summary_plain(nodes, free, dev, extra, extra_dev)
    assert summ.shape == (A.PERTASK_SUMMARY_FIELDS, N)
    por = torch.tensor([t[0] for t in TASKS], dtype=F32)
    mem = torch.tensor([t[1] for t in TASKS], dtype=F32)
    req0 = torch.tensor([t[2] for t in TASKS], dtype=F32)
    k = len(TASKS)
    dev_l = dev.expand(k, N, D).clone()
    ok_idle, ok_pipe, gsh, _ = A._device_rows(
        nodes, dev, extra_dev, dev_l, torch.arange(k),
        torch.full((k, 1), -1, dtype=torch.int32), 0, req0, por, mem)
    for i, (p_, m_, r_) in enumerate(TASKS):
        idle, pipe, shared = _read(summ, p_, m_, r_)
        assert torch.equal(idle, ok_idle[i]), TASKS[i]
        assert torch.equal(pipe, ok_pipe[i]), TASKS[i]
        is_frac = p_ > 0 or m_ > 0
        assert torch.equal(shared & is_frac, gsh[i] > 0), TASKS[i]
        # the node-level fit on the idle and the pipelined pools
        req = torch.tensor([0.0 if is_frac else r_, 1.0, 2.0], dtype=F32)
        fi = (summ[0:3] >= req[:, None]).all(0)
        fp = (summ[3:6] >= req[:, None]).all(0)
        assert torch.equal(fi, resource_fit_mask(free, req))
        assert torch.equal(
            fp, resource_fit_mask((free + nodes.releasing) + extra, req))
    # the density inputs and the node bits
    assert torch.equal(summ[6:8], (free + nodes.releasing)[:, :2].t())
    bits = summ[14].view(torch.int32)
    alloc = nodes.allocatable
    assert torch.equal((bits & A.SUMMARY_VALID) > 0, nodes.valid)
    assert torch.equal((bits & A.SUMMARY_RES0) > 0, alloc[:, 0] > 0)
    assert torch.equal((bits & A.SUMMARY_RES1) > 0, alloc[:, 1] > 0)
    assert torch.equal((bits & A.SUMMARY_CPUONLY) > 0, alloc[:, 0] <= 0)


def test_summary_edges_reach_both_sides_of_each_compare():
    """The edge pools are not vacuous: at 8 devices every fraction and the
    one-device task find nodes on both sides of their idle and pipelined
    pool tests, and the fractions shared-fit nodes and nodes without one."""
    nodes, free, dev, extra, extra_dev = _pools(96, 8, "edges", seed=8)
    summ = A.pertask_summary_plain(nodes, free, dev, extra, extra_dev)
    for p_, m_, r_ in TASKS:
        if p_ == 0 and m_ == 0 and r_ != 1.0:
            continue
        idle, pipe, shared = _read(summ, p_, m_, r_)
        assert idle.any() and not idle.all(), (p_, m_, r_)
        assert pipe.any() and not pipe.all(), (p_, m_, r_)
        if p_ > 0 or m_ > 0:
            assert shared.any() and not shared.all(), (p_, m_, r_)
