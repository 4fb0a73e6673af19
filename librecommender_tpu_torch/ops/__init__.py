"""Tensor ops, losses, layers, feature tables and the CUDA kernels' wrappers
(``streaming_topk``, ``topk``, ``table_gather``, ``row_scatter``, ``swing``)."""
