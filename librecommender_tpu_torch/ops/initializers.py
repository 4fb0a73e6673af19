"""Parameter initializers (counterpart of ``librecommender_tpu/ops/initializers.py``).

Same distributions as the JAX package's; the random bits differ, since a
``torch.Generator`` is not a ``jax.random`` key.
"""
import torch


def truncated_normal(generator, shape, mean=0.0, scale=0.05,
                     dtype=torch.float32, device=None):
    """Normal(mean, scale) truncated to +/- 2 scale, drawn from ``generator``
    on its device (or ``device``)."""
    device = generator.device if device is None else device
    x = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return x * scale + mean
