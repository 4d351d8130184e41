"""Batched serving on the PyTorch port: prefill + decode over the
ServingEngine.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
(on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises)
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.exec import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import ServeConfig, ServingEngine


def main(arch="mistral-nemo-12b", requests=4, prompt_len=12, max_new=24,
         max_len=96, temperature=0.8, sample_seed=7, device=None):
    """``requests`` prompts of ``prompt_len`` tokens from
    ``default_rng(0)``, each answered with ``max_new`` tokens sampled from
    a ``torch.Generator`` seeded ``sample_seed``; returns the tokens
    [requests, max_new]."""
    device = resolve_device(device)
    cfg = get_arch(arch).smoke()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    engine = ServingEngine(params, cfg, ServeConfig(
        batch_slots=requests, max_len=max_len, temperature=temperature),
        device=device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (requests, prompt_len),
                           dtype=np.int32)
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new=max_new,
                          gen=torch.Generator(device=device)
                          .manual_seed(sample_seed))
    dt = time.perf_counter() - t0
    print(f"{requests} requests x {max_new} new tokens in {dt:.2f}s "
          f"({requests * max_new / dt:.1f} tok/s)")
    for i, row in enumerate(out):
        print(f"  req{i}: {row[:12].tolist()} ...")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(device=ap.parse_args().device)
