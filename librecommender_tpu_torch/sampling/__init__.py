from .negatives import (
    neg_probs_from_frequency,
    negatives_from_out_batch,
    negatives_from_popular,
    negatives_from_random,
    negatives_from_unconsumed,
    pos_probs_from_frequency,
)
from .skipgram import skipgram_pairs

__all__ = ["neg_probs_from_frequency", "negatives_from_out_batch",
           "negatives_from_popular", "negatives_from_random",
           "negatives_from_unconsumed", "pos_probs_from_frequency",
           "skipgram_pairs"]
