"""PyTorch / CUDA port of the multimodal music transcription framework.

Mirrors the layout of the JAX package ``omr_a2s_multimodal_transformer_tpu``
(``ops/``, ``models/``, ``training/``, ``inference.py``) so that each module
sits at the same relative path as the JAX module it is held against. The
port imports nothing from the JAX package: what it needs is copied here.

The TPU kernels of the JAX package become CUDA C++ kernels for Hopper
(``csrc/``), built on first use and bound with ``ctypes``. Each kernel has
a plain PyTorch version beside it, which runs for tensors on the CPU.
"""

__version__ = "0.1.0"
