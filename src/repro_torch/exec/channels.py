"""Bounded FIFO channels for the dataflow executor — paper §4.2/§4.6 (C3/C5).

A :class:`FifoChannel` is the executable counterpart of a graph
:class:`~repro_torch.core.graph.Channel`: a latency-insensitive bounded
queue whose

* **capacity** is the §4.6 ``depth`` the ``pipeline_interconnect`` pass wrote
  onto the graph channel (the cut-set-balanced FIFO depth), and whose
* **latency** is ``1 + added_latency`` sweeps — the implicit output register
  plus the pipeline registers the pass inserted on the crossing, so a token
  pushed in sweep *t* becomes visible to the consumer in sweep
  ``t + 1 + added``.

Intra-device channels hand the array straight through.  Inter-device
channels have two transports:

* **ideal** (``transport=None`` — the fast path): the token moves to the
  destination's torch device with ``Tensor.to(non_blocking=True)``; when
  ``depth >= 2`` the transfer is issued eagerly at push time so it overlaps
  the producer's next firing (double buffering), while a depth-1 FIFO can
  only transfer at pop time — the §4.6 claim that shallow FIFOs serialize
  communication behind compute.
* **fabric** (``transport`` = a :class:`~repro.net.transport.FabricTransport`):
  the push is packetized into MTU flits and routed hop by hop over the
  physical links of the :class:`~repro.net.fabric.Fabric`, contending with
  every other channel whose route shares a link.  The token becomes visible
  only after its *own* message's final flit is delivered (FIFO order is
  preserved by the queue: a later token that happens to finish its network
  transit earlier still waits behind the head).  The device copy
  happens at delivery — the network *is* the transfer.

The channel records measured traffic (actual leaf bytes crossing the device
boundary, plus the subset submitted to the network), token counts, and
occupancy high-water marks; the
:class:`~repro_torch.exec.report.ExecutionReport` aggregates these against
the partition's Eq. 2 ``comm_cost`` accounting and (with a fabric) the
per-link conservation identities.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.graph import Channel
from ..obs.trace import coerce_tracer


def token_bytes(token: Any) -> int:
    """Payload size of a token: summed nbytes over its array leaves."""
    total = 0
    for leaf in pytree.tree_leaves(token):
        if isinstance(leaf, torch.Tensor):
            total += int(leaf.nbytes)
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        else:
            total += int(np.asarray(leaf).nbytes)
    return total


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bit_identical(a: Any, b: Any) -> bool:
    """Exact equality of two token trees, leaf by leaf, as bit patterns.

    Tensors must agree in dtype and shape and in every bit (compared as
    same-width integers on ``a``'s device), so -0.0 differs from +0.0 and
    a NaN equals the same NaN — stricter than ``torch.equal`` or
    ``np.array_equal``, which call ±0 equal and NaN unequal to itself.
    Non-tensor leaves compare as numpy arrays, dtype and bytes.  Dicts
    (:class:`~repro_torch.exec.programs.RoutedOutput` included), lists and
    tuples are descended; their keys and lengths must match.
    """
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            return False
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        bits = _BITS[a.element_size()]
        return torch.equal(a.contiguous().view(bits),
                           b.to(a.device).contiguous().view(bits))
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and list(a) == list(b)
                and all(bit_identical(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b)
                and all(bit_identical(x, y) for x, y in zip(a, b)))
    x, y = np.asarray(a), np.asarray(b)
    return (x.dtype == y.dtype and x.shape == y.shape
            and x.tobytes() == y.tobytes())


def _put(token: Any, device) -> Any:
    """Move every tensor leaf of ``token`` to ``device``.

    The copy is issued asynchronously (``non_blocking``) on the current
    stream, so an eager push overlaps the producer's next firing; a tensor
    already on ``device`` is returned as is.
    """
    if device is None:
        return token
    return pytree.tree_map(
        lambda leaf: (leaf.to(device, non_blocking=True)
                      if isinstance(leaf, torch.Tensor) else leaf), token)


@dataclasses.dataclass
class ChannelStats:
    """Measured per-channel counters, filled in while the executor runs."""

    tokens: int = 0                 # tokens pushed over the lifetime
    measured_bytes: int = 0         # actual payload bytes (inter-device only)
    net_bytes: int = 0              # bytes submitted to the fabric transport
    net_delivered_bytes: int = 0    # bytes whose message fully delivered
    max_occupancy: int = 0          # high-water mark of queued tokens
    blocked_pushes: int = 0         # producer stalls on a full FIFO
    empty_pops: int = 0             # consumer polls on an empty/unripe FIFO


class _Entry:
    """One queued token: visibility sweep (None while in the network)."""

    __slots__ = ("vis", "token", "mid", "nbytes")

    def __init__(self, vis: Optional[int], token: Any,
                 mid: Optional[int] = None, nbytes: int = 0):
        self.vis = vis
        self.token = token
        self.mid = mid
        self.nbytes = nbytes


class FifoChannel:
    """One executable bounded FIFO joining two task instances.

    ``capacity`` counts every in-flight token, visible or not; ``latency``
    is the sweep delay between push and visibility.  ``dst_device`` is the
    *physical* torch device of the consumer (None → no placement, logical
    accounting only); ``src_dev``/``dst_dev`` are the partition's logical
    device ids, which drive the traffic accounting even when fewer physical
    devices exist than the partition assumed.  ``transport`` routes
    inter-device pushes over the network fabric (None → ideal transfer).
    ``net_src_dev``/``net_dst_dev`` are the *fabric* device ids the
    crossing is routed between — they differ from the logical ids when a
    tenant's design is placed onto a shared fabric through a device map
    (:mod:`repro.tenants`); they default to the logical ids, and when the
    map collapses a crossing onto one fabric device the network is skipped
    (there is no route — the transfer is ideal, the Eq. 2 accounting stays
    logical).
    """

    def __init__(self, index: int, channel: Channel, src_dev: int,
                 dst_dev: int, *, capacity: Optional[int] = None,
                 latency: int = 1, dst_device=None, transport=None,
                 net_src_dev: Optional[int] = None,
                 net_dst_dev: Optional[int] = None,
                 tracer=None, trace_flow: int = 0):
        if capacity is None:
            capacity = channel.depth
        if capacity < 1:
            raise ValueError(f"channel {channel.src}->{channel.dst}: "
                             f"capacity must be >= 1, got {capacity}")
        if latency < 1:
            raise ValueError("latency must be >= 1 sweep")
        self.index = index
        self.graph_channel = channel
        self.src, self.dst = channel.src, channel.dst
        self.src_dev, self.dst_dev = src_dev, dst_dev
        self.capacity = int(capacity)
        self.latency = int(latency)
        self.is_back = bool(channel.meta.get("back"))
        self.inter_device = src_dev != dst_dev
        self.dst_device = dst_device
        self.net_src_dev = src_dev if net_src_dev is None else net_src_dev
        self.net_dst_dev = dst_dev if net_dst_dev is None else net_dst_dev
        self.transport = (transport if self.inter_device
                          and self.net_src_dev != self.net_dst_dev else None)
        # Double buffering (§4.6): depth >= 2 lets the transfer overlap the
        # producer; a depth-1 FIFO must move the data when the consumer asks.
        self.eager_transfer = self.inter_device and self.capacity >= 2
        self._q: Deque[_Entry] = collections.deque()
        self._pending: Dict[int, _Entry] = {}     # message id -> entry
        self.stats = ChannelStats()
        self.tracer = coerce_tracer(tracer)
        self.trace_flow = trace_flow

    # -- state queries ------------------------------------------------------
    @property
    def occupancy(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.capacity

    @property
    def in_flight(self) -> int:
        """Tokens still transiting the network fabric."""
        return len(self._pending)

    def head_visible(self, sweep: int) -> bool:
        """A token is ready for the consumer this sweep."""
        if not self._q:
            return False
        head = self._q[0]
        return head.vis is not None and head.vis <= sweep

    # -- dataflow -----------------------------------------------------------
    def prime(self, token: Any) -> None:
        """Deposit an initial token (back-edge seeding, visible at once).

        Primed tokens are pre-loaded state, staged before the clock starts —
        they never transit the network fabric.
        """
        if self.full:
            raise ValueError(f"channel {self.src}->{self.dst}: "
                             "cannot prime a full FIFO")
        if self.inter_device:
            self.stats.measured_bytes += token_bytes(token)
            if self.eager_transfer or self.transport is not None:
                token = _put(token, self.dst_device)
        self._q.append(_Entry(0, token))
        self.stats.tokens += 1
        self.stats.max_occupancy = max(self.stats.max_occupancy, len(self._q))

    def push(self, token: Any, sweep: int) -> None:
        if self.full:
            self.stats.blocked_pushes += 1
            raise RuntimeError(f"push on full channel {self.src}->{self.dst}")
        if self.inter_device:
            nbytes = token_bytes(token)
            self.stats.measured_bytes += nbytes
            if self.tracer.enabled:
                self.tracer.channel_push(sweep, self.index, self.src,
                                         self.dst, nbytes, self.trace_flow)
            if self.transport is not None:
                mid = self.transport.submit(self.index, self.net_src_dev,
                                            self.net_dst_dev, nbytes, sweep)
                self.stats.net_bytes += nbytes
                entry = _Entry(None, token, mid, nbytes)
                self._pending[mid] = entry
                self._q.append(entry)
                self.stats.tokens += 1
                self.stats.max_occupancy = max(self.stats.max_occupancy,
                                               len(self._q))
                return
            if self.eager_transfer:
                token = _put(token, self.dst_device)
        self._q.append(_Entry(sweep + self.latency, token))
        self.stats.tokens += 1
        self.stats.max_occupancy = max(self.stats.max_occupancy, len(self._q))

    def on_delivered(self, mid: int, sweep: int) -> None:
        """The fabric delivered this token's final flit: place the payload
        on the destination device and open its visibility next sweep."""
        entry = self._pending.pop(mid)
        entry.token = _put(entry.token, self.dst_device)
        entry.vis = sweep + 1
        self.stats.net_delivered_bytes += entry.nbytes

    def pop(self, sweep: int) -> Any:
        if not self.head_visible(sweep):
            self.stats.empty_pops += 1
            raise RuntimeError(
                f"pop on empty/unripe channel {self.src}->{self.dst}")
        entry = self._q.popleft()
        token = entry.token
        if self.inter_device and self.tracer.enabled:
            self.tracer.channel_pop(sweep, self.index, self.src, self.dst,
                                    self.trace_flow)
        if (self.inter_device and self.transport is None
                and not self.eager_transfer):
            token = _put(token, self.dst_device)
        return token

    def pending_visibility(self) -> List[int]:
        """Sweeps at which queued tokens become visible (deadlock probe);
        tokens still in the network report no sweep — the transport's
        ``active`` flag covers them."""
        return [e.vis for e in self._q if e.vis is not None]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FifoChannel({self.src}->{self.dst}, dev {self.src_dev}->"
                f"{self.dst_dev}, {self.occupancy}/{self.capacity}, "
                f"lat {self.latency})")
