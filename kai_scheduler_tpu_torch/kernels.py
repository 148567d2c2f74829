"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ for Hopper (``csrc/*.cu``) with a plain C
interface.  :func:`library` compiles every source with its own ``nvcc``
process, all started together, links the objects into ONE shared library
under ``build/kai_scheduler_tpu_torch/`` at the root of the checkout, and
loads it with ``ctypes``.  The library's name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  Nothing is built or imported at module import: the CPU tests
import every module on machines without ``nvcc``.

Flags: ``--fmad=false`` and no ``--use_fast_math`` — nearly every product
in these kernels feeds a ``floor`` or a compare, and the results must
match the plain PyTorch versions (and through them the JAX reference)
bit for bit, so no multiply-add may be contracted.

Each kernel's wrapper (in the module of the function it replaces) adds
one to its entry in :data:`KERNELS` where it launches, and nowhere else,
so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parent.parent
BUILD_DIR = REPO_ROOT / "build" / "kai_scheduler_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass
class KernelInfo:
    """One hand-written kernel: where it lives, what it replaces, and how
    often its wrapper launched it since the last reset."""

    name: str
    #: repo-relative CUDA source
    source: str
    #: the JAX function it replaces (file:line in the reference package)
    replaces: str
    #: the kernel's modes: optional inputs that change its work, each
    #: counted under ``name:mode`` beside ``launches``
    modes: tuple[str, ...] = ()
    launches: int = 0
    mode_launches: dict[str, int] = dataclasses.field(default_factory=dict)


KERNELS: dict[str, KernelInfo] = {
    k.name: k for k in (
        KernelInfo("drf_water_fill",
                   "kai_scheduler_tpu_torch/csrc/drf_water_fill.cu",
                   "kai_scheduler_tpu/ops/drf.py:41"),
        KernelInfo("type_tables",
                   "kai_scheduler_tpu_torch/csrc/type_tables.cu",
                   "kai_scheduler_tpu/ops/allocate.py:1552",
                   modes=("lanes",)),
        KernelInfo("uniform_fill",
                   "kai_scheduler_tpu_torch/csrc/uniform_fill.cu",
                   "kai_scheduler_tpu/ops/allocate.py:915",
                   modes=("lanes", "topology", "preferred", "mask")),
        KernelInfo("sparse_accept",
                   "kai_scheduler_tpu_torch/csrc/sparse_accept.cu",
                   "kai_scheduler_tpu/ops/allocate.py:283",
                   modes=("credit",)),
        KernelInfo("cumsum_ds",
                   "kai_scheduler_tpu_torch/csrc/cumsum_ds.cu",
                   "kai_scheduler_tpu/utils/numerics.py:30"),
        KernelInfo("freed_by_mask",
                   "kai_scheduler_tpu_torch/csrc/freed_by_mask.cu",
                   "kai_scheduler_tpu/ops/victims.py:143"),
        KernelInfo("replace_victims",
                   "kai_scheduler_tpu_torch/csrc/replace_victims.cu",
                   "kai_scheduler_tpu/ops/victims.py:644"),
        KernelInfo("freed_by_lane",
                   "kai_scheduler_tpu_torch/csrc/freed_by_lane.cu",
                   "kai_scheduler_tpu/ops/victims.py:738"),
        KernelInfo("pertask_fill",
                   "kai_scheduler_tpu_torch/csrc/pertask_fill.cu",
                   "kai_scheduler_tpu/ops/allocate.py:517",
                   modes=("topology", "banned", "mask")),
        KernelInfo("dense_accept",
                   "kai_scheduler_tpu_torch/csrc/dense_accept.cu",
                   "kai_scheduler_tpu/ops/allocate.py:1730",
                   modes=("no_devices",)),
        KernelInfo("topo_tables_build",
                   "kai_scheduler_tpu_torch/csrc/topo_tables.cu",
                   "kai_scheduler_tpu/ops/allocate.py:1461"),
        KernelInfo("topo_tables_update",
                   "kai_scheduler_tpu_torch/csrc/topo_tables.cu",
                   "kai_scheduler_tpu/ops/allocate.py:1490"),
        KernelInfo("affinity_mask",
                   "kai_scheduler_tpu_torch/csrc/affinity.cu",
                   "kai_scheduler_tpu/ops/allocate.py:171"),
        KernelInfo("anti_mark",
                   "kai_scheduler_tpu_torch/csrc/affinity.cu",
                   "kai_scheduler_tpu/ops/allocate.py:189"),
    )
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.mode_launches = dict.fromkeys(k.modes, 0)


def launch_counts() -> dict[str, int]:
    """Launches per kernel, and per ``kernel:mode`` for its modes."""
    out = {}
    for k in KERNELS.values():
        out[k.name] = k.launches
        out.update({f"{k.name}:{m}": k.mode_launches.get(m, 0)
                    for m in k.modes})
    return out


def count_launch(name: str, **modes: bool) -> None:
    """One launch of ``name``; its wrapper flags the modes it runs in
    (``count_launch("dense_accept", no_devices=True)``)."""
    k = KERNELS[name]
    k.launches += 1
    for m, on in modes.items():
        if m not in k.modes:
            raise KeyError(f"{name} has no mode {m!r}")
        if on:
            k.mode_launches[m] = k.mode_launches.get(m, 0) + 1


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C signature of every exported function: (name, argtypes); all return
#: an int (0 = launched, else a cudaError_t or a negative argument code)
_SIGNATURES = {
    "kai_drf_level": [_P] * 10 + [_F, _I, _I, _P, _P, _P],
    "kai_type_tables": [_P] * 10 + [_I] * 8 + [_P] * 5 + [_P],
    "kai_uniform_fill": [_P] * 31 + [_I] * 13 + [_F] + [_P] * 7 + [_P],
    "kai_sparse_accept": [_P] * 7 + [_I] * 4 + [_P] * 4 + [_P],
    "kai_cumsum_ds": [_P, _I, _I, _P, _P, _P],
    "kai_freed_by_mask": [_P] * 12 + [_I] * 5 + [_P] * 6 + [_P],
    "kai_replace_victims": [_P, _P, _I] + [_P] * 12 + [_I] * 4 + [_P] * 5
    + [_P],
    "kai_freed_by_lane": [_P] * 7 + [_I] * 5 + [_P] * 4 + [_P],
    "kai_pertask_fill": [_P] * 41 + [_I] * 15 + [_F] + [_P] * 11 + [_P],
    "kai_dense_accept": [_P] * 15 + [_I] * 6 + [_P] * 6 + [_P],
    "kai_topo_tables_build": [_P] * 5 + [_I] * 3 + [_P] * 3 + [_P],
    "kai_topo_tables_update": [_P] * 7 + [_I] * 5 + [_P] * 3 + [_P],
    "kai_affinity_mask": [_P] * 8 + [_I] * 8 + [_P] + [_P],
    "kai_anti_mark": [_P] * 6 + [_I] * 7 + [_P] + [_P],
}

_LIB = None
_LIB_LOCK = threading.Lock()
#: compiler output of the last build (``-Xptxas -v``: registers, shared
#: memory and spills per kernel)
BUILD_LOG: list[str] = []


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libkai_kernels-{_digest()}.so"


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` (one ``nvcc`` per source, in parallel) and
    link them into one shared library; returns its path."""
    out = library_path()
    if out.exists() and not force:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}-{out.stem.split('-')[-1]}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    BUILD_LOG.clear()
    failed = []
    for src, p in procs:
        log, _ = p.communicate()
        BUILD_LOG.append(f"== {src.name}\n{log}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(BUILD_LOG))
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kai_error_string.argtypes = [ctypes.c_int]
            lib.kai_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point reported an error."""
    if rc != 0:
        msg = library().kai_error_string(rc).decode()
        raise RuntimeError(f"{name}: launch failed ({rc}: {msg})")


def on_card(t) -> bool:
    """True when ``t`` lies on a CUDA device: the wrappers launch their
    kernel for such tensors (or raise) and run the plain version only for
    tensors on the CPU."""
    return t.device.type == "cuda"


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_cuda(name: str, tensors: dict, dtypes: dict | None = None):
    """Wrapper-side argument checks: every tensor on one CUDA device,
    contiguous, with the expected dtype."""
    dev = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, not CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if dtypes and key in dtypes and t.dtype != dtypes[key]:
            raise ValueError(
                f"{name}: {key} has dtype {t.dtype}, want {dtypes[key]}")
    return dev
