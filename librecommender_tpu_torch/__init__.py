"""PyTorch/CUDA port of librecommender_tpu for one NVIDIA H100.

Imports torch, numpy and the standard library only: never jax and nothing of
``librecommender_tpu``. Entry points take ``device=None``, which means
``"cuda"``; pass ``device="cpu"`` to run on the CPU, where every kernel is
replaced by its plain PyTorch version.
"""
from .device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
