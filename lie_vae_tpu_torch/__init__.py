"""PyTorch and CUDA port of ``lie_vae_tpu`` for one NVIDIA H100.

Module for module it follows the JAX package (``ops``, ``distributions``,
``models``, ``compat``, ``serve``, ``data``, ``train``, ``cli``,
``analysis``, ``utils``), so each file has a counterpart of the same name
there. It imports ``torch`` and ``numpy`` only. Its CUDA kernels
(``csrc/*.cu``) are built with ``nvcc`` at their first launch, and the data
path's host library (``csrc/render_native.cpp``) with ``g++`` at its first
use, never at import, so the package imports on a machine without a GPU;
there every entry point is called with ``device="cpu"`` and takes the
plain PyTorch path.
"""
