"""PyTorch + CUDA port of the K-FAC reproduction (Martens & Grosse, 2015).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``data``, ``core``, ``models``, ``optimizers``, ``training``,
``kernels``) and runs on an NVIDIA Hopper card.  Its hot operations go
through CUDA kernels written by hand (``csrc/``), built with ``nvcc`` at
first use (``kernels/_build.py``).  On CPU tensors every kernel wrapper takes
its plain PyTorch version instead, which is what the CPU tests exercise.

It imports torch, numpy and the standard library only — never ``jax`` and
nothing of ``repro``.
"""
from repro_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
