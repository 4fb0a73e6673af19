from .ivf import IVFIndex

__all__ = ["IVFIndex"]
