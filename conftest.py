"""Keep a long-lived test process within the kernel's memory-map limit.

Every XLA:CPU executable a process holds keeps its code mapped, and JAX's
jit caches hold every program the process has run.  A fresh fused
scheduling pipeline of the reference adds about 2,500 mappings, so a
pytest-xdist worker handed a long run of scenario tests passes Linux's
``vm.max_map_count`` (65,530 by default) after some forty of them and
segfaults in its next compile or persistent-cache load.  After each test,
once the process holds more than half of that limit, the jit caches are
dropped, which unmaps their programs.  Results do not change: a dropped
program is compiled again, or read back from the persistent compilation
cache, when it is next called.  ``tests/jax_executables.py`` does the same
around the port's parity modules, unconditionally.
"""
import gc
import sys

_DEFAULT_MAX_MAP_COUNT = 65530


def _max_map_count() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return _DEFAULT_MAX_MAP_COUNT


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


_RELEASE_AT = _max_map_count() // 2


def pytest_runtest_teardown(item, nextitem):
    jax = sys.modules.get("jax")
    if jax is not None and _map_count() > _RELEASE_AT:
        jax.clear_caches()
        gc.collect()
