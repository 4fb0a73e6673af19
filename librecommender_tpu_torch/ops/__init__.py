"""Tensor ops, losses and the CUDA kernels' wrappers (``streaming_topk``,
``topk``, ``table_gather``)."""
