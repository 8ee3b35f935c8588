"""Faults planted in the program's training step, which the correctness
check of a training cell has to catch (``test_perfbench_faults.py`` on the
CPU, ``control.py`` on the card). Each wraps a ``build_train_step(cfg) ->
(train_step, opt)`` and returns one of the same form."""

from __future__ import annotations

__all__ = ["FAULTS", "half_batch", "state_unchanged"]


def state_unchanged(build):
    """A step that computes the loss and returns its parameters and
    optimizer state unchanged."""

    def wrapped(cfg):
        from repro_torch.launch.steps import value_and_grad

        _, opt = build(cfg)

        def step(params, opt_state, batch):
            loss, _ = value_and_grad(params, cfg, batch)
            return params, opt_state, loss

        return step, opt

    return wrapped


def half_batch(build):
    """A step that leaves half of the batch out and takes the mean over the
    rest: half of the rows, or of a single row's positions."""

    def wrapped(cfg):
        step, opt = build(cfg)

        def half(params, opt_state, batch):
            t = batch["tokens"]
            t = t[: t.shape[0] // 2] if t.shape[0] > 1 else t[:, : (t.shape[1] - 1) // 2 + 1]
            return step(params, opt_state, {**batch, "tokens": t})

        return half, opt

    return wrapped


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
