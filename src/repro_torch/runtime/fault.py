"""Fault tolerance: restart-on-failure, straggler detection, failure
injection for tests, elastic re-mesh hooks.

At 1000+ nodes the dominant events are (a) preemption / hardware fault →
process dies → restart from latest checkpoint; (b) stragglers → step-time
skew; (c) re-scale → device count changes between restarts.  The trainer
loop (trainer.py) is written as a pure function of (checkpoint state, data
stream), so all three reduce to: detect, checkpoint (if alive), restart,
reshard-on-restore.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional

import numpy as np

log = logging.getLogger("repro_torch.runtime")


class FailureInjector:
    """Deterministic fault injection for tests: raises at given steps."""

    class Injected(RuntimeError):
        pass

    def __init__(self, fail_at_steps: Optional[List[int]] = None):
        self.fail_at = set(fail_at_steps or [])
        self.fired = set()

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise FailureInjector.Injected(f"injected failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor; flags steps slower than ``threshold``× mean.

    On a real fleet this feeds the health controller that excludes the slow
    host from the next re-mesh (elastic path); here it records flags that
    tests assert on.
    """

    alpha: float = 0.1
    threshold: float = 2.5
    ewma: Optional[float] = None
    flagged: List[int] = dataclasses.field(default_factory=list)
    _last: Optional[float] = None

    def start(self):
        self._last = time.perf_counter()

    def stop(self, step: int) -> bool:
        assert self._last is not None
        dt = time.perf_counter() - self._last
        slow = False
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.flagged.append(step)
            slow = True
            log.warning("straggler: step %d took %.3fs (ewma %.3fs)",
                        step, dt, self.ewma)
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt)
        return slow


def backoff_delay(attempt: int, *, base_s: float, cap_s: float = 30.0,
                  jitter: float = 0.1,
                  rng: Optional[np.random.Generator] = None) -> float:
    """Capped exponential backoff for restart ``attempt`` (1-based).

    ``min(cap_s, base_s × 2^(attempt-1))``, spread by ``± jitter`` fraction
    drawn from ``rng`` (seeded — the schedule is reproducible; ``jitter=0``
    or ``rng=None`` keeps it exact).  A fleet restarting in lockstep after
    a shared fault re-herds onto the checkpoint store; the jitter is what
    de-synchronizes the thundering herd.
    """
    if attempt < 1:
        raise ValueError("attempt is 1-based")
    delay = min(cap_s, base_s * (2.0 ** min(attempt - 1, 62)))
    if jitter and rng is not None:
        delay *= 1.0 + jitter * float(rng.uniform(-1.0, 1.0))
    return max(0.0, delay)


def run_with_restarts(make_and_run: Callable[[int], int], *,
                      max_restarts: int = 5,
                      backoff_s: float = 0.0,
                      backoff_cap_s: float = 30.0,
                      jitter: float = 0.1,
                      seed: int = 0,
                      sleep: Callable[[float], None] = time.sleep,
                      rng: Optional[np.random.Generator] = None) -> int:
    """Supervisor: call ``make_and_run(attempt)`` (which restores from the
    latest checkpoint internally) until it completes or restarts exhaust.

    Returns the final step reached.  This is the single-process stand-in for
    the fleet-level supervisor (GKE/Borg restart policy); the contract —
    restore-from-latest on every entry — is identical.

    Restart pacing is capped exponential backoff with seeded jitter:
    attempt ``n`` waits :func:`backoff_delay` seconds (``backoff_s`` base,
    doubling, capped at ``backoff_cap_s``, ``± jitter`` from
    ``np.random.default_rng(seed)``).  ``backoff_s=0`` (the default)
    disables waiting entirely — no ``sleep`` call is made, preserving the
    legacy hot-restart behaviour.  ``sleep`` and ``rng`` are injectable so
    tests assert the schedule without real wall time.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    attempt = 0
    while True:
        try:
            return make_and_run(attempt)
        except FailureInjector.Injected as e:
            attempt += 1
            if attempt > max_restarts:
                raise RuntimeError(
                    f"exhausted {max_restarts} restarts") from e
            log.warning("restart %d after: %s", attempt, e)
            if backoff_s:
                sleep(backoff_delay(attempt, base_s=backoff_s,
                                    cap_s=backoff_cap_s, jitter=jitter,
                                    rng=rng))
