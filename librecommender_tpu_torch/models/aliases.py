"""The JAX package's alias classes (``librecommender_tpu/models/
aliases.py``): its DGL-named graph models and Rust-named CF models are the
same implementations under the reference's names."""
from .graphsage import GraphSage
from .item_cf import ItemCF
from .pinsage import PinSage
from .user_cf import UserCF


class GraphSageDGL(GraphSage):
    pass


class PinSageDGL(PinSage):
    pass


class RsUserCF(UserCF):
    pass


class RsItemCF(ItemCF):
    pass
