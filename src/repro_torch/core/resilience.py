"""Resilience primitives shared by the solver facade and the serve layer.

Three small, dependency-free pieces (a copy of ``repro.core.resilience``:
the port imports nothing of that package):

  * :class:`TransientEngineError` / :func:`is_transient` — the taxonomy.
    Transient failures (a flaky device runtime, an injected chaos fault)
    are worth retrying; anything else is a bug-shaped error and must
    propagate unchanged to the caller.
  * :class:`RetryPolicy` / :func:`retry_call` — bounded retries with
    exponential backoff and DETERMINISTIC jitter (seeded ``default_rng``):
    a chaos run replays the exact same delay sequence, so fault-injection
    tests stay reproducible from one integer seed.
  * :class:`CircuitBreaker` — classic closed → open → half-open gate.
    After ``failure_threshold`` consecutive failures the breaker opens and
    :meth:`CircuitBreaker.allow` answers False (callers route to their
    degraded path) until ``cooldown_s`` elapses; then exactly ONE probe is
    admitted at a time, and its outcome closes or re-opens the breaker.

Everything here is thread-safe: the serve layer calls it from the
coalescer and completer threads concurrently.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

__all__ = [
    "CircuitBreaker",
    "RetryPolicy",
    "TransientEngineError",
    "is_transient",
    "retry_call",
]


class TransientEngineError(RuntimeError):
    """An engine failure expected to clear on retry (flaky runtime, injected
    chaos fault). Retry/backoff layers act ONLY on this taxonomy — any other
    exception propagates unchanged, so real bugs are never retried away."""


def is_transient(exc: BaseException) -> bool:
    """True when ``exc`` is retry-worthy: a :class:`TransientEngineError`, or
    any exception carrying a truthy ``transient`` attribute (lets foreign
    error types opt in without inheriting)."""
    return isinstance(exc, TransientEngineError) or bool(getattr(exc, "transient", False))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``max_attempts`` counts the FIRST try: ``max_attempts=3`` means one try
    plus at most two retries. Delay before retry ``k`` (1-based) is
    ``min(base_delay_s * backoff**(k-1), max_delay_s)`` stretched by up to
    ``jitter`` (a fraction, drawn from a ``seed``-ed generator — replayable).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.001
    max_delay_s: float = 0.05
    backoff: float = 2.0
    jitter: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def make_rng(self) -> np.random.Generator:
        """A fresh jitter stream (each consumer owns one — sharing a stream
        across threads would make delays order-dependent)."""
        return np.random.default_rng(self.seed)

    def delay(self, attempt: int, rng: Optional[np.random.Generator] = None) -> float:
        d = min(self.base_delay_s * self.backoff ** (attempt - 1), self.max_delay_s)
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * float(rng.random())
        return d


def retry_call(
    fn: Callable,
    policy: RetryPolicy,
    rng: Optional[np.random.Generator] = None,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Calls ``fn()`` under ``policy``: transient failures back off and retry
    up to ``policy.max_attempts`` total tries; non-transient failures (and
    the last transient one) re-raise unchanged."""
    attempt = 1
    while True:
        try:
            return fn()
        except BaseException as e:
            if not is_transient(e) or attempt >= policy.max_attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(policy.delay(attempt, rng))
            attempt += 1


class CircuitBreaker:
    """Consecutive-failure circuit breaker: closed → open → half-open.

    * **closed** — calls flow; ``failure_threshold`` CONSECUTIVE failures
      (any success resets the count) trip it open.
    * **open** — :meth:`allow` is False: callers take their degraded path
      instead of hammering a failing engine.
    * **half-open** — after ``cooldown_s``, exactly one probe call is
      admitted at a time; success closes the breaker, failure re-opens it
      (and restarts the cooldown).

    ``clock`` is injectable for deterministic tests.
    """

    def __init__(
        self,
        failure_threshold: int = 3,
        cooldown_s: float = 0.25,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._probing = False
        self._opens = 0
        self._probes = 0

    @property
    def state(self) -> str:
        """"closed", "open", or "half-open" (open + cooldown elapsed)."""
        with self._lock:
            if self._state == "open" and self._cooled():
                return "half-open"
            return self._state

    def _cooled(self) -> bool:
        return (
            self._opened_at is not None
            and self._clock() - self._opened_at >= self.cooldown_s
        )

    def allow(self) -> bool:
        """May the protected call run? True while closed; while open, True
        only for the single half-open probe after the cooldown."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._cooled() and not self._probing:
                self._probing = True
                self._probes += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            failed_probe = self._probing
            self._probing = False
            if self._state == "open":
                if failed_probe:  # re-open: restart the cooldown
                    self._opened_at = self._clock()
                    self._opens += 1
                return
            if self._consecutive >= self.failure_threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self._opens += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "opens": self._opens,
                "probes": self._probes,
            }
