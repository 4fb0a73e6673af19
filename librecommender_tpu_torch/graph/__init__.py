from .adjacency import (
    build_dense_adjacency,
    build_edges,
    build_neighbor_table,
    pinsage_neighbor_table,
)
from .walks import i2i_negatives, walk_pairs

__all__ = ["build_dense_adjacency", "build_edges", "build_neighbor_table",
           "i2i_negatives", "pinsage_neighbor_table", "walk_pairs"]
