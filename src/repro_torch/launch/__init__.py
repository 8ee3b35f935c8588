"""Launchers of the port: step builders (``steps.py``), the FL training
launcher (``train.py``, ``python -m repro_torch.launch.train``) and the
serving launcher (``serve.py``, ``python -m repro_torch.launch.serve``)."""

from .steps import build_prefill_step, build_serve_step, build_train_step, value_and_grad

__all__ = ["build_prefill_step", "build_serve_step", "build_train_step", "value_and_grad"]
