"""Fault-tolerant training loop: data pipeline + optimizer + checkpoints +
failure injection + straggler monitoring, independent of model specifics.

The loop is a pure function of (restored state, data stream): every entry
restores from the latest published checkpoint, so process death at any point
resumes correctly (at-most-one-interval loss); a loop that dies waits for
its pending save first, so the restart sees it published.  The JAX
package's trainer on torch tensors; it restores onto the devices (and,
for a mesh's DTensors, the placements) of the fresh state that
``init_state_fn`` builds.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np

from ..ckpt import CheckpointManager
from .fault import FailureInjector, StragglerMonitor

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: str
    save_interval: int = 50
    keep: int = 3
    log_interval: int = 10


class Trainer:
    """step_fn: (state, batch) -> (state, metrics).  ``state`` is any tree
    containing params + optimizer state + step counter under key 'step'."""

    def __init__(self, cfg: TrainerConfig,
                 step_fn: Callable[[Any, Dict], Any],
                 init_state_fn: Callable[[], Any],
                 data: Iterator[Dict[str, np.ndarray]],
                 injector: Optional[FailureInjector] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.data = data
        self.injector = injector or FailureInjector()
        self.monitor = StragglerMonitor()
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                      save_interval=cfg.save_interval)
        self.metrics_history = []

    def _restore_or_init(self):
        latest = self.ckpt.latest_step()
        if latest is not None:
            state, step = self.ckpt.restore(self.init_state_fn())
            log.info("restored checkpoint step %d", step)
            return state, int(step)
        return self.init_state_fn(), 0

    def run(self) -> Any:
        state, start = self._restore_or_init()
        step = start
        try:
            while step < self.cfg.total_steps:
                batch = next(self.data)
                self.monitor.start()
                state, metrics = self.step_fn(state, batch)
                # Wait for the loss so step time is real, then fault-check.
                loss = float(metrics["loss"])
                self.monitor.stop(step)
                step += 1
                self.injector.check(step)
                if step % self.cfg.log_interval == 0:
                    log.info("step %d loss %.4f", step, loss)
                self.metrics_history.append({"step": step, "loss": loss})
                if self.ckpt.should_save(step):
                    self.ckpt.save(step, state)
        except BaseException:
            # A save still being written publishes before the restart
            # reads the directory (or writes the same step again, which
            # raced this writer for its ``.tmp`` directory).
            self.ckpt.wait()
            raise
        self.ckpt.save(step, state)
        self.ckpt.wait()
        return state
