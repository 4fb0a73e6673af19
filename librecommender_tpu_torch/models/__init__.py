from .autoint import AutoInt
from .bpr import BPR
from .deepfm import DeepFM
from .din import DIN
from .fm import FM
from .ncf import NCF
from .sim import SIM
from .transformer import Transformer
from .wide_deep import WideDeep
from .youtube_ranking import YouTubeRanking

__all__ = ["AutoInt", "BPR", "DeepFM", "DIN", "FM", "NCF", "SIM", "Transformer",
           "WideDeep", "YouTubeRanking"]
