from .base import Base
from .embed_base import EmbedBase
from .feat_base import FeatBase
from .seq_base import SeqFeatBase

__all__ = ["Base", "EmbedBase", "FeatBase", "SeqFeatBase"]
