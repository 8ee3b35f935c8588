"""Synthetic federated datasets.

Language-model data: Zipf-distributed token streams with client-specific
topic mixtures (so non-IID-ness is real, not just label skew). Also provides
embedding-style data for the audio/VLM stubbed frontends.
"""

from __future__ import annotations

import numpy as np

__all__ = ["zipf_lm_corpus", "client_corpora", "embedding_frames"]


def zipf_lm_corpus(
    rng: np.random.Generator,
    num_tokens: int,
    vocab_size: int,
    alpha: float = 1.1,
    topic_shift: int = 0,
) -> np.ndarray:
    """A Zipf token stream; ``topic_shift`` rotates the rank->id map so
    different clients favour different token subsets."""
    ranks = rng.zipf(alpha, size=num_tokens)
    ids = (np.minimum(ranks, vocab_size) - 1 + topic_shift) % vocab_size
    return ids.astype(np.int32)


def client_corpora(
    rng: np.random.Generator,
    n_clients: int,
    tokens_per_client: int,
    vocab_size: int,
    heterogeneity: float = 0.3,
) -> list:
    """Per-client corpora with rotated topic supports (non-IID)."""
    out = []
    for c in range(n_clients):
        shift = int(heterogeneity * vocab_size * c / max(n_clients, 1))
        out.append(zipf_lm_corpus(rng, tokens_per_client, vocab_size, topic_shift=shift))
    return out


def embedding_frames(
    rng: np.random.Generator, num_frames: int, dim: int, n_classes: int
) -> tuple:
    """Frame/patch embeddings + frame labels for encoder (audio) smoke data."""
    centers = rng.normal(size=(n_classes, dim)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=num_frames).astype(np.int32)
    x = centers[labels] + 0.5 * rng.normal(size=(num_frames, dim)).astype(np.float32)
    return x.astype(np.float32), labels
