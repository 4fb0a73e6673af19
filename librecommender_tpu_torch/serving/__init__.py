from .app import create_server
from .store import DictStore

__all__ = ["DictStore", "create_server"]
