"""Open-loop traffic generation — seeded, wall-clock-free.

A serving benchmark is only as honest as its load: closed-loop generators
(send the next request when the last returns) hide queueing collapse,
because the generator politely slows down exactly when the system
saturates.  The generator here is **open loop**: arrival times are drawn
up front from a (possibly time-varying) Poisson process and never look at
the system — offered load is what the config says, whether or not the
substrate keeps up.  Three knobs shape the stream:

* **Poisson arrivals** at ``rate_rps``, time-varying via thinning when a
  profile modulates the rate (the classic non-homogeneous-Poisson trick:
  draw candidates at the peak rate, keep each with probability
  ``rate(t) / rate_max`` — exact, and deterministic given the generator);
* **heavy-tail request sizes**: shifted-Pareto (Lomax + 1) with shape
  ``tail_shape`` scaled so the mean is ``mean_size`` — a few huge requests
  dominate the byte count, like real serving corpora;
* **profiles**: ``flat``, ``diurnal`` (sinusoid around the mean, depth
  ``swing``), ``ramp`` (linear climb from ``1-swing`` to ``1+swing`` of
  the mean — the load-sweep workhorse).

Everything is driven by an explicit :class:`numpy.random.Generator` — no
global seed, no wall clock — so a (seed, config) pair names one exact
request stream forever.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np

PROFILES = ("flat", "diurnal", "ramp")


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """One tenant's offered-load description."""

    rate_rps: float                # mean arrival rate (requests / s)
    mean_size: float               # mean request size (bytes of work)
    duration_s: float              # generation horizon
    tail_shape: float = 2.2        # Pareto shape (> 1 for a finite mean)
    profile: str = "flat"          # flat | diurnal | ramp
    swing: float = 0.5             # modulation depth for diurnal / ramp
    period_s: Optional[float] = None   # diurnal period (default: horizon)

    def __post_init__(self):
        if self.rate_rps <= 0 or self.mean_size <= 0 or self.duration_s <= 0:
            raise ValueError("rate, size and duration must be positive")
        if self.tail_shape <= 1.0:
            raise ValueError("tail_shape must exceed 1 (finite mean)")
        if self.profile not in PROFILES:
            raise ValueError(f"profile {self.profile!r} not in {PROFILES}")
        if not (0.0 <= self.swing < 1.0):
            raise ValueError("swing must be in [0, 1)")

    def rate_at(self, t: float) -> float:
        """Instantaneous arrival rate at time ``t`` (requests / s)."""
        if self.profile == "flat":
            return self.rate_rps
        if self.profile == "diurnal":
            period = self.period_s or self.duration_s
            return self.rate_rps * (
                1.0 + self.swing * math.sin(2.0 * math.pi * t / period))
        # ramp: linear climb across the horizon.
        frac = min(1.0, max(0.0, t / self.duration_s))
        return self.rate_rps * (1.0 - self.swing + 2.0 * self.swing * frac)

    @property
    def rate_max(self) -> float:
        if self.profile == "flat":
            return self.rate_rps
        return self.rate_rps * (1.0 + self.swing)

    def scaled(self, factor: float) -> "TrafficConfig":
        """The same stream shape at ``factor`` × the rate (load sweeps)."""
        return dataclasses.replace(self, rate_rps=self.rate_rps * factor)


@dataclasses.dataclass(frozen=True)
class Request:
    """One offered request: arrival instant + service demand."""

    rid: int
    tenant: int                    # tenant flow id
    t_arrival: float               # seconds from stream start
    size: float                    # service demand, bytes of work


def generate(cfg: TrafficConfig, tenant: int,
             rng: np.random.Generator) -> List[Request]:
    """Draw one tenant's full request stream from ``rng``.

    Thinned Poisson arrivals + shifted-Pareto sizes; strictly increasing
    arrival times; every draw comes from the caller's generator, so the
    stream is a pure function of (cfg, tenant, generator state).
    """
    out: List[Request] = []
    t = 0.0
    lam_max = cfg.rate_max
    # Mean of (1 + Lomax(a)) is a / (a - 1); rescale so E[size] = mean.
    size_scale = cfg.mean_size * (cfg.tail_shape - 1.0) / cfg.tail_shape
    while True:
        t += float(rng.exponential(1.0 / lam_max))
        if t >= cfg.duration_s:
            break
        if cfg.profile != "flat":
            # Thinning: keep the candidate with prob rate(t) / rate_max.
            if float(rng.random()) * lam_max > cfg.rate_at(t):
                continue
        size = size_scale * (1.0 + float(rng.pareto(cfg.tail_shape)))
        out.append(Request(rid=len(out), tenant=tenant, t_arrival=t,
                           size=size))
    return out


def merge(streams: List[List[Request]]) -> List[Request]:
    """Interleave per-tenant streams into one arrival-ordered stream.

    Ties break by (tenant, rid) so the merged order is deterministic.
    """
    return sorted((r for s in streams for r in s),
                  key=lambda r: (r.t_arrival, r.tenant, r.rid))


def offered_load(stream: List[Request], duration_s: float) -> float:
    """Offered bytes of work per second over the horizon."""
    if duration_s <= 0:
        return 0.0
    return sum(r.size for r in stream) / duration_s
