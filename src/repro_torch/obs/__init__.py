"""repro_torch.obs — the part of the observability layer the executor needs.

Only the disabled tracer is ported so far: the executor and its channels
guard every emit with ``if tracer.enabled:``, and ``tracer=None`` resolves
to :data:`~repro_torch.obs.trace.NULL_TRACER`.  The recording tracer, the
metrics registry and the critical-path analysis are not yet ported.
"""
from .trace import NULL_TRACER, NullTracer, coerce_tracer

__all__ = ["NULL_TRACER", "NullTracer", "coerce_tracer"]
