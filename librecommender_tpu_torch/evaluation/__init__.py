from .evaluate import evaluate, print_metrics

__all__ = ["evaluate", "print_metrics"]
