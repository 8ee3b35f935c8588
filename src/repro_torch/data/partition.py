"""Non-IID partitioning of a corpus across FL clients."""

from __future__ import annotations

import numpy as np

__all__ = ["dirichlet_sizes", "partition_stream"]


def dirichlet_sizes(
    rng: np.random.Generator, n_clients: int, total: int, alpha: float = 0.5, minimum: int = 1
) -> np.ndarray:
    """Client dataset sizes ~ Dirichlet(alpha) (smaller alpha = more skew)."""
    props = rng.dirichlet(np.full(n_clients, alpha))
    sizes = np.maximum((props * total).astype(np.int64), minimum)
    # fix rounding drift
    diff = total - int(sizes.sum())
    sizes[np.argmax(sizes)] += diff
    return sizes


def partition_stream(stream: np.ndarray, sizes: np.ndarray) -> list:
    """Contiguous split of a token stream by per-client sizes."""
    out, ofs = [], 0
    for s in sizes:
        out.append(stream[ofs : ofs + int(s)])
        ofs += int(s)
    return out
