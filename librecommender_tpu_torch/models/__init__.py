from .aliases import GraphSageDGL, PinSageDGL, RsItemCF, RsUserCF
from .als import ALS
from .autoint import AutoInt
from .bpr import BPR
from .caser import Caser
from .deepfm import DeepFM
from .deepwalk import DeepWalk
from .din import DIN
from .fm import FM
from .graphsage import GraphSage
from .item2vec import Item2Vec
from .item_cf import ItemCF
from .lightgcn import LightGCN
from .ncf import NCF
from .ngcf import NGCF
from .pinsage import PinSage
from .rnn4rec import RNN4Rec
from .sim import SIM
from .svd import SVD
from .svdpp import SVDpp
from .swing import Swing
from .transformer import Transformer
from .two_tower import TwoTower
from .user_cf import UserCF
from .wave_net import WaveNet
from .wide_deep import WideDeep
from .youtube_ranking import YouTubeRanking
from .youtube_retrieval import YouTubeRetrieval

__all__ = ["ALS", "AutoInt", "BPR", "Caser", "DeepFM", "DeepWalk", "DIN", "FM",
           "GraphSage", "GraphSageDGL", "Item2Vec", "ItemCF", "LightGCN",
           "NCF", "NGCF", "PinSage", "PinSageDGL", "RNN4Rec", "RsItemCF",
           "RsUserCF", "SIM", "SVD", "SVDpp", "Swing", "Transformer",
           "TwoTower", "UserCF", "WaveNet", "WideDeep", "YouTubeRanking",
           "YouTubeRetrieval"]
