"""Model-family registries.

Counterpart of ``librecommender_tpu/utils/constants.py``, copied: which
models consume features or sequences, which reduce to embeddings, and which
train listwise. Families control which inputs a model consumes, how it
trains and how it is served.
"""
from enum import Enum, unique


class StrEnum(str, Enum):
    @classmethod
    def contains(cls, x):
        return x in cls.__members__.values()


@unique
class FeatModels(StrEnum):
    """Models that consume sparse/dense features."""

    WIDEDEEP = "WideDeep"
    FM = "FM"
    DEEPFM = "DeepFM"
    YOUTUBERETRIEVAL = "YouTubeRetrieval"
    YOUTUBERANKING = "YouTubeRanking"
    AUTOINT = "AutoInt"
    DIN = "DIN"
    GRAPHSAGE = "GraphSage"
    GRAPHSAGEDGL = "GraphSageDGL"
    PINSAGE = "PinSage"
    PINSAGEDGL = "PinSageDGL"
    TWOTOWER = "TwoTower"
    TRANSFORMER = "Transformer"
    SIM = "SIM"


@unique
class SequenceModels(StrEnum):
    """Models that consume user behavior sequences."""

    YOUTUBERETRIEVAL = "YouTubeRetrieval"
    YOUTUBERANKING = "YouTubeRanking"
    DIN = "DIN"
    RNN4REC = "RNN4Rec"
    CASER = "Caser"
    WAVENET = "WaveNet"
    TRANSFORMER = "Transformer"
    SIM = "SIM"


@unique
class EmbeddingModels(StrEnum):
    """Models reducible to (user_embeds, item_embeds) dot products."""

    SVD = "SVD"
    SVDPP = "SVDpp"
    ALS = "ALS"
    BPR = "BPR"
    YOUTUBERETRIEVAL = "YouTubeRetrieval"
    ITEM2VEC = "Item2Vec"
    RNN4REC = "RNN4Rec"
    CASER = "Caser"
    WAVENET = "WaveNet"
    DEEPWALK = "DeepWalk"
    NGCF = "NGCF"
    LIGHTGCN = "LightGCN"
    GRAPHSAGE = "GraphSage"
    GRAPHSAGEDGL = "GraphSageDGL"
    PINSAGE = "PinSage"
    PINSAGEDGL = "PinSageDGL"
    TWOTOWER = "TwoTower"


@unique
class SageModels(StrEnum):
    GRAPHSAGE = "GraphSage"
    GRAPHSAGEDGL = "GraphSageDGL"
    PINSAGE = "PinSage"
    PINSAGEDGL = "PinSageDGL"


@unique
class UserEmbedModels(StrEnum):
    """Models that can only generate user embeddings dynamically."""

    YOUTUBERETRIEVAL = "YouTubeRetrieval"
    RNN4REC = "RNN4Rec"
    CASER = "Caser"
    WAVENET = "WaveNet"


@unique
class ListwiseModels(StrEnum):
    """Models trained with listwise (softmax-family) objectives."""

    YOUTUBERETRIEVAL = "YouTubeRetrieval"
    TWOTOWER = "TwoTower"
