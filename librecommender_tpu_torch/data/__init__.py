from .data_info import DataInfo, InteractionData
from .dataset import DatasetFeat, DatasetPure
from .processing import process_data, split_multi_value
from .split import (
    random_split,
    split_by_num,
    split_by_num_chrono,
    split_by_ratio,
    split_by_ratio_chrono,
)
from .transformed import TransformedEvalSet, TransformedSet

__all__ = [
    "DataInfo",
    "DatasetFeat",
    "DatasetPure",
    "InteractionData",
    "TransformedEvalSet",
    "TransformedSet",
    "process_data",
    "random_split",
    "split_by_num",
    "split_by_num_chrono",
    "split_by_ratio",
    "split_by_ratio_chrono",
    "split_multi_value",
]
