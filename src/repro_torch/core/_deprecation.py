"""Warn-once deprecation plumbing for the legacy solver entrypoints.

The six legacy solve entrypoints — ``schedule`` / ``schedule_batch`` /
``schedule_with_deadline`` / ``deadline_sweep`` / ``solve_dp_batch_cached``
/ ``solve_schedule_batch_cached`` — sit behind one facade,
:class:`repro_torch.core.solver.Solver`. The old names keep working
bit-identically (they are thin shims over the same private implementations
the facade calls), but each fires ONE :class:`DeprecationWarning` per
process so migrations are visible without drowning sweep loops in warning
spam.

Kept in its own leaf module because both ``core/scheduler.py`` and
``core/sweep.py`` need it and ``core/solver.py`` imports both. A copy of
``repro.core._deprecation`` (the port imports nothing of that package); its
warnings name ``repro_torch.core``.
"""

from __future__ import annotations

import threading
import warnings

__all__ = ["reset_deprecation_warnings", "warn_deprecated"]

_WARNED: set = set()
_LOCK = threading.Lock()


def warn_deprecated(name: str, replacement: str, module: str = "repro_torch.core") -> None:
    """Fires ``DeprecationWarning`` for entrypoint ``name`` exactly once per
    process (repeat calls are silent — deterministic, unlike the interpreter's
    per-call-site ``__warningregistry__`` dedup). ``module`` labels where the
    deprecated spelling lives."""
    with _LOCK:
        if name in _WARNED:
            return
        _WARNED.add(name)
    warnings.warn(
        f"{module}.{name} is deprecated; use {replacement} "
        f"(the Solver facade) — behavior is bit-identical",
        DeprecationWarning,
        stacklevel=3,
    )


def reset_deprecation_warnings() -> None:
    """Forgets which entrypoints already warned (test isolation)."""
    with _LOCK:
        _WARNED.clear()
