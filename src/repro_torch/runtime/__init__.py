"""repro_torch.runtime — fault injection, restart supervision and the
training loop.

``fault.py`` is a copy of the JAX package's (numpy only): the executor's
kill switch (:class:`FailureInjector`, probed once a sweep by
``execute(injector=...)`` and once a step by the trainer), the EWMA
straggler monitor and the restart-with-backoff supervisor.
``trainer.py`` is the JAX package's fault-tolerant training loop on torch
tensors.
"""
from .fault import FailureInjector, StragglerMonitor, run_with_restarts
from .trainer import Trainer, TrainerConfig

__all__ = ["FailureInjector", "StragglerMonitor", "run_with_restarts",
           "Trainer", "TrainerConfig"]
