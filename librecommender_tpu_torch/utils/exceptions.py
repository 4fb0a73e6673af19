"""The port's exceptions. Counterpart of
``librecommender_tpu/utils/exceptions.py``."""


class NotSamplingError(Exception):
    """Raised when computing evaluation metrics that require negative sampling."""
