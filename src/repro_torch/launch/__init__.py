"""Launchers of the port: step builders (``steps.py``)."""

from .steps import build_prefill_step

__all__ = ["build_prefill_step"]
