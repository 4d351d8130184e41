"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt --device cpu

Runs the fault-tolerant Trainer (checkpoint/restart, straggler monitor)
over the data pipeline with the train step, on the CUDA card unless
``--device cpu`` is given.  ``--smoke`` uses the reduced config
(CPU-runnable); a full config needs the card (qwen3-4b's AdamW state is
48 GB; recurrentgemma-9b's fits with ``--optimizer adafactor`` only) and
``--seq`` a multiple of the cross-entropy's 512-position chunk (and of
the mLSTM chunk for xlstm-1.3b).  Every arch trains.

Started with a world size above 1 (``torch.distributed.run``), it takes
the mesh path, as JAX's does with more than one device: it creates the
process group (nccl on ``cuda``, gloo on the CPU) and a ``(world, 1)``
('data', 'model') mesh, shards the state by the sharding rules and runs
the mesh train step.  Every rank reads the global stream (host 0's) and
keeps its slice.  Checkpoints are written whole by rank 0 and restored
onto each rank's shards.

    PYTHONPATH=src python -m torch.distributed.run --nproc_per_node 2 \
        -m repro_torch.launch.train --arch qwen3-4b --smoke --device cpu

``--inject-failure-at N`` kills the run after step N; the supervisor
(``runtime.run_with_restarts``) restarts it, the trainer restores the
latest checkpoint, and the data stream resumes at the batch of the
restored step (the synthetic stream is a function of the seed, so the
resumed run sees the batches an uninterrupted one would).
"""
from __future__ import annotations

import argparse
import itertools
import logging
import os
import tempfile
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..ckpt import latest_step
from ..configs import get_arch
from ..data import DataConfig, make_pipeline
from ..exec.programs import resolve_device
from ..models import ModelConfig
from ..runtime import (FailureInjector, Trainer, TrainerConfig,
                       run_with_restarts)
from .mesh import make_mesh
from .steps import (OPTIMIZERS, build_train_step, init_train_state,
                    shard_state)


def data_config(cfg: ModelConfig, batch: int, seq: int,
                seed: int = 0) -> DataConfig:
    """The JAX driver's data config: vision patches prepended, an enc-dec
    encoder over ``seq // 4`` frames."""
    return DataConfig(
        global_batch=batch, seq_len=seq, vocab=cfg.vocab, seed=seed,
        frontend_tokens=cfg.frontend_tokens if cfg.frontend == "vision"
        else 0,
        d_model=cfg.d_model,
        enc_len=seq // 4 if cfg.arch == "encdec" else 0)


def train_with_restarts(step_fn: Callable, init_state: Callable,
                        dcfg: DataConfig, cfg: TrainerConfig,
                        injector: Optional[FailureInjector] = None
                        ) -> Tuple[List[Trainer], Any]:
    """A :class:`Trainer` under ``run_with_restarts``: each attempt
    restores the latest checkpoint in ``cfg.ckpt_dir`` (or starts fresh)
    and reads the pipeline from that step's batch on, so a resumed run
    sees the batches an uninterrupted one would (the synthetic stream is
    a function of the seed).  Returns (the trainer of each attempt, the
    final state)."""
    trainers, final = [], []

    def attempt(n: int) -> int:
        pipe = make_pipeline(dcfg)
        data = itertools.islice(pipe, latest_step(cfg.ckpt_dir) or 0, None)
        trainers.append(Trainer(cfg, step_fn, init_state, data,
                                injector=injector))
        try:
            final.append(trainers[-1].run())
        finally:
            pipe.close()
        return int(final[-1]["step"])

    run_with_restarts(attempt)
    return trainers, final[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--save-interval", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    mod = get_arch(args.arch)
    cfg = mod.smoke() if args.smoke else mod.full()
    dev = resolve_device(args.device)
    mesh = _mesh(dev)

    def init_state():
        state = init_train_state(cfg, args.optimizer, device=dev)
        if mesh is None:
            return state
        return shard_state(state, cfg, mesh, args.optimizer)

    step_fn = build_train_step(cfg, args.optimizer,
                               microbatches=args.microbatches, device=dev,
                               mesh=mesh)
    writer = mesh is None or dist.get_rank() == 0
    try:
        trainers, state = train_with_restarts(
            step_fn, init_state, data_config(cfg, args.batch, args.seq),
            TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                          save_interval=args.save_interval),
            FailureInjector([args.inject_failure_at]
                            if args.inject_failure_at else None))
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    history = trainers[-1].metrics_history
    final_loss = history[-1]["loss"] if history else float("nan")
    if writer:
        print(f"done: step={int(state['step'])} loss={final_loss:.6f}")
    return 0


def _mesh(dev):
    """The (world, 1) ('data', 'model') mesh when the process was started
    with a world size above 1 (``torch.distributed.run`` sets
    ``WORLD_SIZE``, ``RANK`` and the rendezvous), else None."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return None
    # DTensor warns of every reduction over the two mesh dims in turn.
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return make_mesh((world, 1), ("data", "model"))


if __name__ == "__main__":
    raise SystemExit(main())
