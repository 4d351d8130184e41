"""Deterministic link-fault models for the fabric transport (the chaos layer).

Real packet-switched multi-FPGA networks drop, corrupt, and reorder frames
and lose whole links; the transport's reliable-delivery layer
(:mod:`repro_torch.net.transport`) must survive all of it with **bit-identical**
results and exact byte accounting.  This module owns the *model* side:

* :class:`LinkFaults` — one link's loss behaviour: i.i.d. per-transmission
  drop / corrupt / reorder probabilities plus scripted down windows
  (``(start_sweep, end_sweep)``, ``end_sweep=None`` meaning "never comes
  back").
* :class:`FaultModel` — the per-fabric fault configuration handed to
  :class:`~repro_torch.net.transport.FabricTransport`: a default
  :class:`LinkFaults`, per-link overrides, the ARQ knobs (retransmit
  backoff base/cap, bounded un-acked window), and the link-death threshold
  (``fail_threshold`` consecutive failed transmissions mark a link dead
  and trigger route repair; ``None`` disables death — pure lossy links).

Determinism contract: every random outcome on link ``l`` comes from
``np.random.default_rng([seed, l])`` — no wall clock anywhere — so a
scenario replays *exactly*, which is what lets the chaos harness assert
bit-identity instead of hoping for it.

CRC framing: flit payloads ride outside the transport (tokens are held by
the FIFO channels; the network only schedules *when* visibility opens), so
the wire CRC runs over a deterministic pseudo-payload synthesized from the
flit's identity ``(message id, flit index, payload bytes)``.  A corruption
flips one byte of the wire frame; the receiver recomputes the CRC32 and
rejects the frame — the chaos tests assert that **every** injected
corruption was caught and retransmitted, never silently accepted.
"""
from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np


class PartitionedFabricError(RuntimeError):
    """No route survives the dead links — the fabric is partitioned.

    Raised by the transport's route repair instead of hanging: it names
    the unroutable pair and the dead link set (the cut) so the caller —
    executor, tenant server, or chaos runner — can surface or recover.
    """

    def __init__(self, src: int, dst: int, dead_links: Tuple[int, ...]):
        self.src = src
        self.dst = dst
        self.dead_links = tuple(sorted(dead_links))
        super().__init__(
            f"fabric partitioned: no route {src}->{dst} with links "
            f"{list(self.dead_links)} dead")


@dataclasses.dataclass(frozen=True)
class LinkFaults:
    """One link's loss model (probabilities are per transmission attempt)."""

    drop: float = 0.0              # frame vanishes on the wire
    corrupt: float = 0.0           # frame arrives, CRC check rejects it
    reorder: float = 0.0           # frame arrives late (reliable layer
    #                                turns reordering into extra delay)
    #: Scripted outage windows ``(start_sweep, end_sweep)`` — the link is
    #: down for ``start <= sweep < end``; ``end=None`` means forever.
    down: Tuple[Tuple[int, Optional[int]], ...] = ()

    def __post_init__(self):
        total = self.drop + self.corrupt + self.reorder
        if not (0.0 <= self.drop <= 1.0 and 0.0 <= self.corrupt <= 1.0
                and 0.0 <= self.reorder <= 1.0 and total <= 1.0):
            raise ValueError(
                f"fault probabilities must be in [0, 1] and sum <= 1: "
                f"drop={self.drop} corrupt={self.corrupt} "
                f"reorder={self.reorder}")

    @property
    def lossy(self) -> bool:
        return bool(self.drop or self.corrupt or self.reorder or self.down)

    def up(self, sweep: int) -> bool:
        """Is the link up at ``sweep`` (outside every down window)?"""
        for start, end in self.down:
            if sweep >= start and (end is None or sweep < end):
                return False
        return True


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """The fabric-wide fault configuration (see module doc).

    ``backoff_base`` / ``backoff_cap`` shape the retransmission schedule:
    after the ``n``-th consecutive failure of one flit the sender waits
    ``min(cap, base << (n-1))`` sweeps before retrying — capped
    exponential backoff, in sweeps, deterministic.  ``arq_window`` bounds
    the per-(link, flow) un-acked sequence numbers: a *new* transmission
    is refused while the window is full (the bounded retransmit buffer
    backpressuring the sender); retries of an already-sequenced flit are
    always admitted, or the window could never drain.
    """

    seed: int = 0
    default: LinkFaults = dataclasses.field(default_factory=LinkFaults)
    links: Mapping[int, LinkFaults] = dataclasses.field(default_factory=dict)
    #: Consecutive failed transmissions on one link before it is declared
    #: dead (route repair kicks in); ``None`` = links never die.
    fail_threshold: Optional[int] = 6
    backoff_base: int = 1
    backoff_cap: int = 16
    arq_window: int = 64

    def __post_init__(self):
        if self.backoff_base < 1 or self.backoff_cap < self.backoff_base:
            raise ValueError("need 1 <= backoff_base <= backoff_cap")
        if self.arq_window < 1:
            raise ValueError("arq_window must be >= 1")
        if self.fail_threshold is not None and self.fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1 (or None)")

    def for_link(self, link_index: int) -> LinkFaults:
        return self.links.get(link_index, self.default)

    def link_up(self, link_index: int, sweep: int) -> bool:
        return self.for_link(link_index).up(sweep)

    def rng(self, link_index: int) -> np.random.Generator:
        """The per-link fault stream — seeded, never wall-clocked."""
        return np.random.default_rng([self.seed, link_index])

    def sweep_allowance(self, flit_hops: int, iterations: int) -> int:
        """Extra executor-sweep budget faults may cost (safety bound only).

        Losses inflate transmissions by ~``1/(1-p)``; down windows stall
        their queues outright; backoff spaces retries.  The executor adds
        this to ``max_sweeps`` so a lossy run hits the throughput-collapse
        diagnostic only when genuinely stuck, not merely slowed.
        """
        worst = self.default
        p = worst.drop + worst.corrupt
        for lf in self.links.values():
            p = max(p, lf.drop + lf.corrupt)
        factor = 1.0 / (1.0 - min(p, 0.9))
        base = 256 + 64 * (iterations + 1) * max(1, flit_hops)
        down = sum((end - start)
                   for lf in [self.default, *self.links.values()]
                   for start, end in lf.down if end is not None)
        return int(base * (factor - 1.0)) + down + 64 * self.backoff_cap \
            + 1024


def flit_payload(mid: int, flit_index: int, nbytes: int) -> bytes:
    """Deterministic pseudo-payload of one wire frame (see module doc)."""
    return struct.pack("<qqq", mid, flit_index, nbytes)


def flit_crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


def corrupt_frame(payload: bytes, rng: np.random.Generator) -> bytes:
    """Flip one rng-chosen byte — the injected wire corruption."""
    pos = int(rng.integers(0, len(payload)))
    flipped = bytes([payload[pos] ^ 0xFF])
    return payload[:pos] + flipped + payload[pos + 1:]
