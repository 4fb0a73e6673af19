from .generator import BatchGenerator, adjust_batch_size

__all__ = ["BatchGenerator", "adjust_batch_size"]
