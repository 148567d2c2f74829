"""The PyTorch port stands alone: it loads no JAX, no flax and nothing of
the JAX package, and its entry points never fall back to the CPU on their
own."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import kai_scheduler_tpu_torch
from kai_scheduler_tpu_torch.framework.scheduler import Scheduler
from kai_scheduler_tpu_torch.framework.session import Session
from kai_scheduler_tpu_torch.state import make_cluster

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = pathlib.Path(kai_scheduler_tpu_torch.__file__).resolve().parent

_CHILD = r"""
import importlib, pkgutil, sys
import kai_scheduler_tpu_torch as pkg
import kai_scheduler_tpu_torch.framework.scheduler
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax")
             or m == "kai_scheduler_tpu" or m.startswith("kai_scheduler_tpu."))
print(repr(bad))
"""


def test_import_loads_no_jax_flax_or_reference_package():
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax\b|jaxlib\b|flax\b|kai_scheduler_tpu\b(?!_torch))",
    re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_nothing_of_jax_or_the_reference(path):
    src = (ROOT / path).read_text()
    assert not _IMPORT.findall(src), path


def test_entry_points_raise_without_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    nodes, queues, groups, pods, topo = make_cluster(num_nodes=4,
                                                     num_gangs=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session.open(nodes, queues, groups, pods, topo)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler()
    # the CPU only when asked for
    ses = Session.open(nodes, queues, groups, pods, topo, device="cpu")
    assert ses.state.device.type == "cpu"
    assert Scheduler(device="cpu").device.type == "cpu"
