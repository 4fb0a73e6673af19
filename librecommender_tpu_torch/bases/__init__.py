from .base import Base
from .dyn_embed_base import DynEmbedBase
from .embed_base import EmbedBase
from .feat_base import FeatBase
from .seq_base import SeqFeatBase

__all__ = ["Base", "DynEmbedBase", "EmbedBase", "FeatBase", "SeqFeatBase"]
