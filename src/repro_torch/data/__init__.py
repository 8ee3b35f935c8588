"""Synthetic federated data of the port: numpy copies of the JAX package's
``data/`` (same names, same draws from the same generators)."""

from .partition import dirichlet_sizes, partition_stream
from .pipeline import lm_round_batches, make_lm_examples
from .synthetic import client_corpora, embedding_frames, zipf_lm_corpus

__all__ = [
    "dirichlet_sizes", "partition_stream", "lm_round_batches", "make_lm_examples",
    "client_corpora", "embedding_frames", "zipf_lm_corpus",
]
