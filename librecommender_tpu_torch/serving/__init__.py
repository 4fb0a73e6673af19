from .app import create_server
from .serialization import save_embed, save_ivf_index, save_knn, save_online
from .store import DictStore, RedisStore, embed2store, knn2store, online2store

# the reference's names (libserving.serialization), as the JAX package keeps
# them: *2redis hydrate any store; the faiss index is the IVF index here; the
# SavedModel export is the whole-model online artifact
knn2redis = knn2store
embed2redis = embed2store
online2redis = online2store
tf2redis = online2store
save_faiss_index = save_ivf_index
save_tf = save_online

__all__ = [
    "save_knn", "save_embed", "save_online", "save_ivf_index",
    "DictStore", "RedisStore", "knn2store", "embed2store", "online2store",
    "knn2redis", "embed2redis", "online2redis", "tf2redis",
    "save_faiss_index", "save_tf", "create_server",
]
