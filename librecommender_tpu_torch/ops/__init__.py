"""Tensor ops and the CUDA kernels' wrappers (``streaming_topk``, ``topk``)."""
