"""Launchers of the port: step builders (``steps.py``)."""

from .steps import build_prefill_step, build_train_step, value_and_grad

__all__ = ["build_prefill_step", "build_train_step", "value_and_grad"]
