"""repro_torch: Multi-Processor AMP with lossy compression, in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper.

The counterpart of the JAX package ``repro`` (same sub-package names); it
imports ``torch``, ``numpy`` and ``scipy`` only.
"""
__version__ = "0.1.0"
