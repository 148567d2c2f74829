"""Release the JAX reference's compiled programs around each parity module.

Every XLA:CPU executable a process holds keeps its code mapped, and JAX's
jit caches hold every program a process has run.  The reference's fused
scheduling pipelines take about a thousand memory mappings each, so a
pytest-xdist worker that runs enough of them reaches the kernel's limit
per process (``vm.max_map_count``, 65530 by default) and segfaults in the
next compile or cache load.  The port's parity tests call the reference
at many shapes and configs; importing ``release_jax_executables`` into
such a module drops the jit caches before its first test and after its
last, so the module neither adds to what the worker's earlier tests left
mapped nor leaves its own programs behind.  Results do not change: a
dropped program is compiled again, or read back from the persistent
compilation cache, when it is next called.
"""
import gc

import jax
import pytest


def _release():
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    _release()
    yield
    _release()
