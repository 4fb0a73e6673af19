"""In-process feature store for serving (counterpart of the JAX package's
``serving/store.py`` ``DictStore``; the Redis client comes later)."""


class DictStore:
    """In-process store with the subset of Redis ops the servers use."""

    def __init__(self):
        self._data = {}

    def set(self, key, value):
        self._data[key] = value

    def get(self, key):
        return self._data.get(key)

    def hset(self, key, field, value):
        self._data.setdefault(key, {})[field] = value

    def hget(self, key, field):
        h = self._data.get(key)
        return None if h is None else h.get(field)

    def exists(self, key):
        return key in self._data

    def flushdb(self):
        self._data.clear()
