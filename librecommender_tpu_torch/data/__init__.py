from .data_info import DataInfo, InteractionData

__all__ = ["DataInfo", "InteractionData"]
