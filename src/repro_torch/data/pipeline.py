"""Batching pipeline: fixed-shape per-round batch tensors for FL rounds.

Every client contributes a fixed-shape ``(max_steps, batch, seq + 1)``
tensor each round, as in the JAX package (a numpy copy of its
``data/pipeline.py``). The port's server trains client ``i`` on exactly the
first ``x_i`` of its batches (``fl/client.py``), so the rest are never read.
Batches cycle through the client's local corpus with a per-round offset
(epoch-style traversal without reshuffling cost). Token ids are int32; the
server moves a round's tensor to the device as int64 once.
"""

from __future__ import annotations

import numpy as np

__all__ = ["lm_round_batches", "make_lm_examples"]


def make_lm_examples(corpus: np.ndarray, seq_len: int) -> np.ndarray:
    """Chops a token stream into (num_examples, seq_len + 1) windows
    (inputs + next-token labels)."""
    n = (len(corpus) - 1) // seq_len
    if n <= 0:
        reps = int(np.ceil((seq_len + 1) / max(len(corpus), 1)))
        corpus = np.tile(corpus, reps + 1)
        n = (len(corpus) - 1) // seq_len
    ex = np.stack(
        [corpus[i * seq_len : i * seq_len + seq_len + 1] for i in range(n)], axis=0
    )
    return ex.astype(np.int32)


def lm_round_batches(
    examples_per_client: list,
    max_steps: int,
    batch_size: int,
    round_index: int,
) -> np.ndarray:
    """(n_clients, max_steps, batch_size, seq_len+1) round tensor; each
    client's batches advance cyclically across rounds."""
    out = []
    for ex in examples_per_client:
        n = len(ex)
        need = max_steps * batch_size
        start = (round_index * need) % n
        idx = (start + np.arange(need)) % n
        out.append(ex[idx].reshape(max_steps, batch_size, -1))
    return np.stack(out, axis=0)
