from .bpr import BPR
from .din import DIN

__all__ = ["BPR", "DIN"]
