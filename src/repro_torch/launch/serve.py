"""Serving CLI: one full-sequence prefill step, then batched generation
over the ServingEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --smoke --device cpu --requests 4 --prompt-len 8 --max-new 16

``--arch`` is any of ``repro_torch.configs.ALL_ARCHS`` (the GQA decoders,
chatglm3-6b, the MLA + MoE archs deepseek-v2-236b and deepseek-v3-671b,
the recurrent archs recurrentgemma-9b and xlstm-1.3b, whose prompt
lengths past one mLSTM chunk must be multiples of it, the enc-dec
seamless-m4t-large-v2 and the vision llava-next-34b).

Runs on the CUDA card unless ``--device cpu`` is given.  Weights are drawn
from ``--seed``; the prompts too (numpy).  The prefill step runs once over
``--requests`` sequences of ``--prefill-len`` positions (default:
``--prompt-len``), which puts the flash attention kernel on this path.
Its stub frontends' inputs are drawn from ``--seed`` with numpy as well:
an enc-dec config's encoder takes ``src`` [requests, prefill-len // 4,
d_model] frame embeddings; a vision config's sequence is
``frontend_tokens`` patch embeddings ``frontend`` [requests,
frontend_tokens, d_model] followed by ``prefill-len - frontend_tokens``
tokens.  Like the JAX engine, the ServingEngine then decodes text tokens
with no encoder output and no patches (ROADMAP reference caveat 7).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..configs.base import prefill_input_shapes
from ..exec.programs import resolve_device
from ..kernels import launch_counts, reset_launch_counts
from ..models import init_params
from ..serving import ServeConfig, ServingEngine
from .steps import build_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--prefill-len", type=int, default=None)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mod = get_arch(args.arch)
    cfg = mod.smoke() if args.smoke else mod.full()
    params = init_params(torch.Generator(dev).manual_seed(args.seed), cfg)
    rng = np.random.default_rng(args.seed)
    prefill_len = args.prefill_len or args.prompt_len
    try:
        shapes = prefill_input_shapes(cfg, args.requests, prefill_len)
    except ValueError as e:
        ap.error(f"--prefill-len: {e}, so give more positions")
    batch = {"tokens": rng.integers(1, cfg.vocab, shapes.pop("tokens"))}
    prompts = rng.integers(1, cfg.vocab, (args.requests, args.prompt_len))
    batch.update({k: rng.standard_normal(shape, dtype=np.float32)
                  for k, shape in shapes.items()})
    print("prefill inputs: " + ", ".join(
        f"{k} {tuple(v.shape)}" for k, v in batch.items()))

    prefill = build_prefill_step(cfg, dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    _sync(dev)
    dt = time.perf_counter() - t0
    counts = launch_counts()
    assert bool(torch.isfinite(logits).all()), "prefill logits not finite"
    positions = args.requests * prefill_len
    print(f"prefill {(args.requests, prefill_len)} on {dev} in {dt:.3f}s "
          f"({positions / dt:.1f} positions/s), flash_attention "
          f"launches {counts['flash_attention']} (tensor cores "
          f"{counts['flash_attention_tc']})")

    engine = ServingEngine(params, cfg, ServeConfig(
        batch_slots=args.requests, max_len=args.max_len,
        temperature=args.temperature), device=dev)
    gen = (torch.Generator(dev).manual_seed(args.seed + 1)
           if args.temperature > 0 else None)
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=args.max_new, gen=gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    toks = args.requests * args.max_new
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s batch throughput)")
    print(out[:, :12])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
