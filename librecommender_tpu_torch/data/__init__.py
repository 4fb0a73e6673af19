from .data_info import DataInfo, InteractionData
from .dataset import DatasetFeat, DatasetPure
from .split import random_split, split_by_ratio, split_by_ratio_chrono
from .transformed import TransformedEvalSet, TransformedSet

__all__ = [
    "DataInfo",
    "DatasetFeat",
    "DatasetPure",
    "InteractionData",
    "TransformedEvalSet",
    "TransformedSet",
    "random_split",
    "split_by_ratio",
    "split_by_ratio_chrono",
]
