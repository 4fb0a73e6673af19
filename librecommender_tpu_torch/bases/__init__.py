from .base import Base
from .embed_base import EmbedBase

__all__ = ["Base", "EmbedBase"]
