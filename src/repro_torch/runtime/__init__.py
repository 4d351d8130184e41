"""repro_torch.runtime — fault injection and restart supervision.

A copy of the JAX package's ``runtime/fault.py`` (numpy only): the
executor's kill switch (:class:`FailureInjector`, probed once a sweep by
``execute(injector=...)``), the EWMA straggler monitor and the
restart-with-backoff supervisor.  The trainer waits for the training
slice.
"""
from .fault import FailureInjector, StragglerMonitor, run_with_restarts

__all__ = ["FailureInjector", "StragglerMonitor", "run_with_restarts"]
