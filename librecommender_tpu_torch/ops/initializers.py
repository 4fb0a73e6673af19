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


def he_init(generator, shape, fan_in, dtype=torch.float32, device=None):
    """Truncated normal of scale sqrt(2 / fan_in)."""
    return truncated_normal(generator, shape, 0.0, (2.0 / fan_in) ** 0.5,
                            dtype, device)


def xavier_init(generator, shape, fan_in, fan_out, dtype=torch.float32,
                device=None):
    """Truncated normal of scale sqrt(2 / (fan_in + fan_out))."""
    return truncated_normal(generator, shape, 0.0,
                            (2.0 / (fan_in + fan_out)) ** 0.5, dtype, device)


def glorot_uniform(generator, shape, fan_in, fan_out, dtype=torch.float32,
                   device=None):
    """Uniform on +/- sqrt(6 / (fan_in + fan_out))."""
    device = generator.device if device is None else device
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    x = torch.empty(shape, dtype=dtype, device=device)
    return x.uniform_(-limit, limit, generator=generator)


def zeros(shape, dtype=torch.float32, device=None):
    return torch.zeros(shape, dtype=dtype, device=device)
