"""Skip-gram (center, context) pair generation on the host.

Counterpart of ``librecommender_tpu/sampling/skipgram.py``, copied as it is:
the same numpy generator gives the same pairs in both packages.
"""
import numpy as np


def skipgram_pairs(corpus, window, rng, max_pairs=None):
    """Sequences -> (centers, contexts) int32 arrays with word2vec's
    per-position dynamic window reduction; at most ``max_pairs`` pairs, a
    uniform subset drawn without replacement beyond it."""
    centers, contexts = [], []
    for sent in corpus:
        sent = np.asarray(sent, dtype=np.int32)
        n = len(sent)
        if n < 2:
            continue
        # dynamic window like word2vec: per-position reduced window
        reduced = rng.integers(1, window + 1, n)
        for pos in range(n):
            lo = max(0, pos - reduced[pos])
            hi = min(n, pos + reduced[pos] + 1)
            for ctx in range(lo, hi):
                if ctx != pos:
                    centers.append(sent[pos])
                    contexts.append(sent[ctx])
    centers = np.asarray(centers, np.int32)
    contexts = np.asarray(contexts, np.int32)
    if max_pairs is not None and len(centers) > max_pairs:
        # whole-list windows (Item2Vec) are O(len^2) per user; cap the
        # epoch size for power users
        take = rng.choice(len(centers), max_pairs, replace=False)
        centers, contexts = centers[take], contexts[take]
    return centers, contexts
