from .base import Base
from .dyn_embed_base import DynEmbedBase
from .embed_base import EmbedBase
from .feat_base import FeatBase
from .graph_base import GraphEmbedBase
from .seq_base import SeqFeatBase
from .w2v_base import W2VBase

__all__ = ["Base", "DynEmbedBase", "EmbedBase", "FeatBase", "GraphEmbedBase",
           "SeqFeatBase", "W2VBase"]
