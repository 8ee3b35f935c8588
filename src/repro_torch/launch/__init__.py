"""Launchers of the port: step builders (``steps.py``) and the FL training
launcher (``train.py``, ``python -m repro_torch.launch.train``)."""

from .steps import build_prefill_step, build_train_step, value_and_grad

__all__ = ["build_prefill_step", "build_train_step", "value_and_grad"]
