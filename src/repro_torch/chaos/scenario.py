"""Chaos scenario DSL: one frozen record per fault configuration.

A :class:`ChaosScenario` is declarative — probabilities, outage windows,
a death threshold, an optional mid-run kill — and compiles to the
substrate's own :class:`~repro_torch.net.faults.FaultModel` via
:meth:`ChaosScenario.fault_model`.  Scenarios carry their seed, so a
matrix cell is replayable by construction: same scenario, same app, same
bits.

:func:`default_matrix` is the acceptance matrix — three drop-rate
tiers, two link-down shapes (finite outage window; permanent death that
must trigger route repair), and a kill/restore cell — run over the four
paper apps by :func:`repro_torch.chaos.runner.run_matrix`.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

from ..net.faults import FaultModel, LinkFaults

#: ``{link index: ((start_sweep, end_sweep | None), ...)}``
DownMap = Mapping[int, Tuple[Tuple[int, Optional[int]], ...]]


@dataclasses.dataclass(frozen=True)
class ChaosScenario:
    """One cell of the fault matrix (see module doc)."""

    name: str
    #: i.i.d. per-transmission probabilities applied to *every* link.
    drop: float = 0.0
    corrupt: float = 0.0
    reorder: float = 0.0
    #: Scripted outage windows per link index (see :data:`DownMap`).
    down: DownMap = dataclasses.field(default_factory=dict)
    #: Consecutive failures before a link is declared dead (route repair);
    #: ``None`` keeps links alive — pure lossy.
    fail_threshold: Optional[int] = None
    #: Inject a process kill at this sweep (checkpoint/restore cell).
    kill_sweep: Optional[int] = None
    #: Sweep-barrier interval for the kill/restore cells.
    barrier: int = 4
    seed: int = 0

    @property
    def lossy(self) -> bool:
        return bool(self.drop or self.corrupt or self.reorder or self.down)

    def fault_model(self) -> Optional[FaultModel]:
        """The scenario's :class:`FaultModel` (``None`` when fault-free —
        the transport then takes its byte-identical legacy path)."""
        if not self.lossy:
            return None
        default = LinkFaults(drop=self.drop, corrupt=self.corrupt,
                             reorder=self.reorder)
        links = {
            li: LinkFaults(drop=self.drop, corrupt=self.corrupt,
                           reorder=self.reorder, down=tuple(windows))
            for li, windows in self.down.items()}
        return FaultModel(seed=self.seed, default=default, links=links,
                          fail_threshold=self.fail_threshold)


def default_matrix() -> Tuple[ChaosScenario, ...]:
    """The acceptance matrix: 3 drop tiers × 2 link-down shapes × a
    kill/restore cell (7 scenarios per app with the clean baseline)."""
    return (
        # -- drop-rate tiers (pure lossy: links never die) -------------------
        ChaosScenario("drop-low", drop=0.02, corrupt=0.01, reorder=0.02,
                      seed=3),
        ChaosScenario("drop-mid", drop=0.05, corrupt=0.02, reorder=0.03,
                      seed=5),
        ChaosScenario("drop-high", drop=0.15, corrupt=0.05, reorder=0.05,
                      seed=7),
        # -- link-down shapes ------------------------------------------------
        # Link 5 (ring 2->1) carries traffic in all four paper apps — the
        # outage is guaranteed to hit live flits, not dark fibre.
        # Finite outage: dark for sweeps [0, 6) — ARQ rides it out, no
        # death (no threshold set).
        ChaosScenario("down-window", down={5: ((0, 6),)}, seed=11),
        # Permanent death: link 5 never comes back; the threshold trips and
        # route repair must recall + reroute the in-flight traffic.
        ChaosScenario("link-death", down={5: ((0, None),)},
                      fail_threshold=4, seed=13),
        # -- kill/restore ------------------------------------------------
        # Clean links, process killed mid-run; resumes from the barrier.
        ChaosScenario("kill-restore", kill_sweep=6, barrier=4, seed=17),
        # Lossy links AND a kill: restore must replay through faults too.
        ChaosScenario("kill-lossy", drop=0.05, corrupt=0.02, kill_sweep=6,
                      barrier=4, seed=19),
    )
