"""The disabled tracer shared by the executor's instrumented hot paths.

A copy of the null half of the JAX package's ``obs/trace.py``: every emit
is a no-op and ``enabled`` is False, so the untraced path allocates
nothing.  A caller may still pass any object with the same methods as
``tracer=``; :func:`coerce_tracer` hands it through unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class NullTracer:
    """The disabled tracer: every emit is a no-op, ``enabled`` is False.

    Hot paths guard event-argument construction with ``if tracer.enabled:``
    so the ``trace=None`` path performs zero allocations; cold call sites
    may call the no-op methods directly.
    """

    enabled = False
    events: Tuple[()] = ()
    link_devs: Dict[int, Tuple[int, int]] = {}

    def _noop(self, *args, **kw) -> None:
        return None

    note_link = task_fire = task_wait = channel_push = channel_pop = _noop
    flit_hop = flit_reclassify = retransmit = arq_backoff = _noop
    link_death = reroute = bank_burst = mem_issue = _noop
    tenant_admit = tenant_cancel = barrier = slo_alert = _noop

    def __len__(self) -> int:
        return 0

    def iter_kind(self, kind: str):
        return iter(())

    def count(self, kind: str) -> int:
        return 0

    def as_dicts(self) -> List[Dict[str, Any]]:
        return []


#: The shared disabled tracer — the default everywhere ``tracer=`` threads.
NULL_TRACER = NullTracer()


def coerce_tracer(tracer: Optional[Any]) -> Any:
    """``None`` → :data:`NULL_TRACER`; anything else passes through."""
    return NULL_TRACER if tracer is None else tracer
