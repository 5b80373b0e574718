"""Host-side watchdog: retry / timeout / backoff for control-plane calls.

The serving control loop (``serve/admission.py``) makes host-blocking
device calls — ensemble scores, per-job plans — that can fail in ways the
device-side ladder (``robust.degrade``) cannot absorb: a wedged runtime,
a transient out-of-memory error, a solve that returns garbage.  ``Watchdog`` wraps any
host callable with

  * bounded retries on exceptions,
  * result validation (a predicate over the returned value — retry on
    a finite-but-wrong answer, e.g. NaN scores),
  * a cooperative deadline: the call is timed and a result that took
    longer than ``timeout_s`` is *treated as* a failure and retried
    (a host thread cannot safely preempt a running device call, so
    this is a post-hoc timeout — the standard tradeoff),
  * exponential backoff with seeded jitter between attempts (all sleep
    and clock functions injectable, so tests run in virtual time).

Exhausting the retries raises ``WatchdogGiveUp`` — callers decide the
degraded behavior (``AdmissionController`` returns a deny-all decision
with ``status="degraded"`` rather than crashing the loop).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

__all__ = ["Watchdog", "WatchdogGiveUp"]


class WatchdogGiveUp(RuntimeError):
    """Raised when every attempt failed; carries the last error as
    ``__cause__``."""


@dataclasses.dataclass
class Watchdog:
    """Retry/timeout/backoff wrapper for host control-plane calls.

    retries: additional attempts after the first (total = retries + 1).
    timeout_s: post-hoc deadline per attempt (None = no deadline).
    backoff_s / backoff_mult: initial sleep between attempts and its
      growth factor.
    jitter: relative ± jitter on each sleep (seeded — runs replay).
    sleep / clock: injectable for tests (virtual time).
    """

    retries: int = 3
    timeout_s: float | None = None
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    jitter: float = 0.1
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    # attempt/outcome counters (diagnostics; reset with reset_stats)
    attempts: int = 0
    failures: int = 0
    timeouts: int = 0
    rejections: int = 0
    giveups: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def reset_stats(self) -> None:
        self.attempts = self.failures = self.timeouts = 0
        self.rejections = self.giveups = 0

    @property
    def stats(self) -> dict:
        return {"attempts": self.attempts, "failures": self.failures,
                "timeouts": self.timeouts, "rejections": self.rejections,
                "giveups": self.giveups}

    def call(self, fn, *args, validate=None, label: str | None = None,
             **kwargs):
        """Run ``fn(*args, **kwargs)`` under the watchdog.

        ``validate`` (optional) maps the result to bool; False counts as
        a failed attempt.  Returns the first good result; raises
        ``WatchdogGiveUp`` after retries are exhausted.
        """
        what = label or getattr(fn, "__name__", repr(fn))
        delay = self.backoff_s
        last_err = None
        for attempt in range(self.retries + 1):
            self.attempts += 1
            t0 = self.clock()
            try:
                out = fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — the point is to retry
                self.failures += 1
                last_err = e
            else:
                elapsed = self.clock() - t0
                if self.timeout_s is not None and elapsed > self.timeout_s:
                    self.timeouts += 1
                    last_err = TimeoutError(
                        f"{what} took {elapsed:.3f}s > "
                        f"deadline {self.timeout_s:.3f}s")
                elif validate is not None and not validate(out):
                    self.rejections += 1
                    last_err = ValueError(f"{what} result failed validation")
                else:
                    return out
            if attempt < self.retries:
                d = delay
                if self.jitter:
                    d *= 1.0 + self.jitter * float(self._rng.uniform(-1, 1))
                self.sleep(max(d, 0.0))
                delay *= self.backoff_mult
        self.giveups += 1
        raise WatchdogGiveUp(
            f"{what} failed after {self.retries + 1} attempts") from last_err

    def wrap(self, fn, validate=None, label: str | None = None):
        """Bind ``fn`` into a callable that always goes through
        ``call`` (drop-in replacement for the raw function)."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, validate=validate, label=label,
                             **kwargs)
        return wrapped
