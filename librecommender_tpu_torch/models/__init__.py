from .bpr import BPR
from .din import DIN
from .sim import SIM
from .transformer import Transformer
from .youtube_ranking import YouTubeRanking

__all__ = ["BPR", "DIN", "SIM", "Transformer", "YouTubeRanking"]
