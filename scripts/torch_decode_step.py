"""Time the PyTorch port's decode step: the serving engine's greedy
``generate`` over fixed prompts, per step, and the ATen operators each step
dispatches.

    PYTHONPATH=src python scripts/torch_decode_step.py --arch qwen3-4b \
        [--superblocks N] [--rounds 5] [--label NAME] [--smoke --device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; bf16 weights of
``full()`` (or ``smoke()``) drawn from ``--seed``, cut to ``--superblocks``
super-blocks where given (deepseek-v2-236b's 60 layers do not fit one
card).  One warm-up generate,
then ``--rounds`` timed ones: ``step_wall_ms`` is a round's wall time over
its prompt + new tokens (every one is one ``serve_step``).  Prints the
card's name and power limit and one JSON line.  It uses only the engine's
public API, so it runs on any tree of the port: to compare two trees, run
it in one session on the same card with each tree's ``src`` on
``PYTHONPATH`` in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch
from repro_torch.exec.programs import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import ServeConfig, ServingEngine


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--superblocks", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mod = get_arch(args.arch)
    cfg = mod.smoke() if args.smoke else mod.full()
    if args.superblocks is not None:
        cfg = dataclasses.replace(cfg, num_superblocks=args.superblocks)
    params = init_params(torch.Generator(dev).manual_seed(args.seed), cfg)
    prompts = np.random.default_rng(args.seed).integers(
        1, cfg.vocab, (args.requests, args.prompt_len))
    engine = ServingEngine(params, cfg, ServeConfig(
        batch_slots=args.requests,
        max_len=args.prompt_len + args.max_new), device=dev)
    steps = args.prompt_len + args.max_new

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    engine.generate(prompts, max_new=args.max_new)          # warm-up
    sync()
    wall_ms = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        engine.generate(prompts, max_new=args.max_new)
        sync()
        wall_ms.append((time.perf_counter() - t0) * 1e3 / steps)
    count = _CountOps()
    with count:
        engine.generate(prompts, max_new=args.max_new)
    sync()

    print(_card() if dev.type == "cuda" else "cpu")
    print(json.dumps({
        "label": args.label, "arch": cfg.name, "device": str(dev),
        "layers": cfg.num_layers,
        "requests": args.requests, "prompt_len": args.prompt_len,
        "max_new": args.max_new, "rounds": args.rounds,
        "step_wall_ms": wall_ms,
        "step_wall_ms_median": statistics.median(wall_ms),
        "step_wall_ms_min": min(wall_ms),
        "decode_tok_per_s": args.requests * 1e3
        / statistics.median(wall_ms),
        "step_aten_ops": count.n / steps}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
