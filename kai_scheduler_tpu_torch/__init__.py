"""kai_scheduler_tpu_torch — the PyTorch/CUDA port of ``kai_scheduler_tpu``.

The JAX package beside this one is the reference; this package runs the
same scheduling cycle with PyTorch on an NVIDIA GPU (Hopper, ``sm_90a``),
with the reference's jitted device programs replaced by CUDA C++ kernels
written by hand (``csrc/``, built and loaded by :mod:`.kernels`).  Every
kernel has a plain PyTorch version beside its wrapper: the wrapper runs it
only for tensors on the CPU, which is how the tests hold the port against
the reference on machines without a GPU.

The sub-packages mirror the reference's names — ``apis``, ``state``,
``ops``, ``plugins``, ``framework``, ``runtime`` — so each module's
counterpart is found under the same path.  The port imports ``torch`` and
numpy, never ``jax`` and nothing of ``kai_scheduler_tpu``.

Entry points take ``device=`` with the default ``"cuda"``; without a CUDA
device they raise unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
