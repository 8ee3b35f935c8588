"""Toy embedding LM shared by the FL tests and ``chip_smoke.py``, after the
JAX package's ``fl/toy.py``.

A two-matrix next-token model (embed -> tanh -> unembed) with a real loss
surface, enough for the FL runtime's concerns (local training, FedAvg
aggregation, energy-vs-loss accounting) without modeling machinery.
"""

from __future__ import annotations

import torch

from ..core.torch_dp import resolve_device

__all__ = ["make_tiny_lm"]


def make_tiny_lm(vocab: int, dim: int):
    """Returns ``(init_fn, loss_fn)`` for a toy next-token LM.

    ``init_fn(gen=0, device="cuda")`` -> ``{"emb": (vocab, dim), "out":
    (dim, vocab)}`` float32, standard normal times 0.1; ``gen`` is a
    ``torch.Generator`` (its device is used) or an int seed for a new
    generator on ``device``. ``loss_fn(params, batch)`` -> the scalar mean
    NLL of a ``(B, seq + 1)`` integer token batch (the first ``seq``
    positions are inputs, shifted by one are targets).
    """

    def init(gen=0, device="cuda"):
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=resolve_device(device)).manual_seed(int(gen))
        kw = dict(generator=gen, device=gen.device)
        return {
            "emb": torch.randn((vocab, dim), **kw) * 0.1,
            "out": torch.randn((dim, vocab), **kw) * 0.1,
        }

    def loss(params, batch):
        batch = batch.long()
        x, y = batch[:, :-1], batch[:, 1:]
        h = torch.tanh(params["emb"][x])
        logp = torch.log_softmax(h @ params["out"], dim=-1)
        return -torch.gather(logp, -1, y[..., None]).mean()

    return init, loss
