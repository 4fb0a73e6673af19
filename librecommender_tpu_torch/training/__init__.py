from .trainer import Trainer, make_optimizer

__all__ = ["Trainer", "make_optimizer"]
