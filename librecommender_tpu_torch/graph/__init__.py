from .adjacency import build_dense_adjacency, build_edges, build_neighbor_table

__all__ = ["build_dense_adjacency", "build_edges", "build_neighbor_table"]
