from .adjacency import build_neighbor_table

__all__ = ["build_neighbor_table"]
