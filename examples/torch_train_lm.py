"""End-to-end LM training on the PyTorch port with the production
substrate: data pipeline, AdamW, checkpoint/restart with an injected
failure, straggler monitor.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--device cpu]
(trains the gemma2 smoke config for 60 steps on the CUDA card unless
``--device cpu`` is given, killing the run at step 25 and resuming from the
step-20 checkpoint; without a card and without ``--device cpu`` it raises.)
"""
import argparse
import logging
import tempfile

from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.exec import resolve_device
from repro_torch.launch.steps import build_train_step, init_train_state
from repro_torch.runtime import (FailureInjector, Trainer, TrainerConfig,
                                 run_with_restarts)


def main(arch="gemma2-27b", steps=60, fail_at=25, save_interval=20,
         log_interval=10, batch=4, seq=32, data_seed=3, device=None):
    """Trains ``arch``'s smoke config for ``steps`` steps under
    ``run_with_restarts``, killed once after step ``fail_at``; returns
    (the final step, each attempt's metrics history)."""
    device = resolve_device(device)
    cfg = get_arch(arch).smoke()
    dcfg = DataConfig(global_batch=batch, seq_len=seq, vocab=cfg.vocab,
                      seed=data_seed)
    step_fn = build_train_step(cfg, "adamw", device=device)

    def init_state():
        return init_train_state(cfg, "adamw", device=device)

    injector = FailureInjector(fail_at_steps=[fail_at])
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = TrainerConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                             save_interval=save_interval,
                             log_interval=log_interval)
        attempts = []

        def attempt(n):
            pipe = make_pipeline(dcfg)
            try:
                tr = Trainer(tcfg, step_fn, init_state, iter(pipe),
                             injector=injector)
                attempts.append(tr.metrics_history)
                state = tr.run()
            finally:
                pipe.close()
            return int(state["step"])

        final = run_with_restarts(attempt, max_restarts=2)
        history = [m for h in attempts for m in h]
        print(f"\nfinished at step {final} after {len(attempts) - 1} "
              f"injected failure "
              f"(restart resumed from the step-{attempts[-1][0]['step'] - 1}"
              f" checkpoint)")
        print(f"loss: first={history[0]['loss']:.3f} "
              f"last={history[-1]['loss']:.3f}")
        if final != steps:
            raise RuntimeError(f"training ended at step {final}, not {steps}")
    return final, attempts


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(device=ap.parse_args().device)
