"""Time the PyTorch port's flash attention wrapper at the serving path's
prefill shapes, for comparing two trees of the port on one card.

    PYTHONPATH=src python scripts/torch_flash_ab.py [--label NAME] [--reps 10]
        [--shapes NAME,NAME]

Shapes (bf16, ``[B, S, H, d]`` tensors seen as ``[B, H, S, d]``, as the
models give them, drawn from ``--seed``): qwen3-4b's prefill (q [4, 32,
2048, 128], k and v [4, 8, 2048, 128]), chatglm3-6b's (32 query heads on 2
kv heads), MLA's (q, k [4, 128, 2048, 192], v [4, 128, 2048, 128]),
recurrentgemma-9b's (q [4, 16, 2048, 256], k and v [4, 1, 2048, 256]; its
window of 2048 does not bite at this length) and llava-next-34b's (q
[4, 56, 2048, 128], k and v [4, 8, 2048, 128], G = 7), each causal and
not; and seamless-m4t-large-v2's three at head dim 64: the decoder's
[4, 16, 2048, 64] causal and not, the encoder's [4, 16, 512, 64] and
cross attention's 2048 queries on 512 keys, both with no mask (their
``ms`` is the non-causal call); and gemma2-27b's local layers (q [4, 32,
2048, 128] on 16 kv heads, softcap 50, window 4096), causal and not.
Each time is the device time of one call: ``--reps`` calls captured in
one CUDA graph and replayed three times between CUDA events.  Prints the
card's name and power limit and one JSON line with each shape's ms and
the route ``route()`` names for it (``--shapes``: only the shapes named,
in this order).  It uses only the wrapper's public
functions, so it runs on any tree of the port: run it on one card, with
each tree's ``src`` on ``PYTHONPATH`` in turn, in the order A, B, B, A.
Needs the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.kernel import flash_attention, route

#: (name, batch, query length, key length, query heads, kv heads, q/k
#: head dim, v head dim, causal: timed causal and not, or only without a
#: mask; keyword arguments of both calls).
SHAPES = (("qwen3-4b", 4, 2048, 2048, 32, 8, 128, 128, True, {}),
          ("chatglm3-6b", 4, 2048, 2048, 32, 2, 128, 128, True, {}),
          ("mla", 4, 2048, 2048, 128, 128, 192, 128, True, {}),
          ("recurrentgemma-9b", 4, 2048, 2048, 16, 1, 256, 256, True, {}),
          ("llava-next-34b", 4, 2048, 2048, 56, 8, 128, 128, True, {}),
          ("seamless-decoder", 4, 2048, 2048, 16, 16, 64, 64, True, {}),
          ("seamless-encoder", 4, 512, 512, 16, 16, 64, 64, False, {}),
          ("seamless-cross", 4, 2048, 512, 16, 16, 64, 64, False, {}),
          # gemma2-27b's local layers: softcap 50, a window of 4096 that
          # does not bite at 2048.
          ("gemma2-27b", 4, 2048, 2048, 32, 16, 128, 128, True,
           {"softcap": 50.0, "window": 4096}))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device time of one call of ``fn`` (see the module docstring)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", default="",
                    help="comma-separated shape names (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab: needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    build.library()
    out = {"label": args.label, "device": torch.cuda.get_device_name(0)}
    only = [n for n in args.shapes.split(",") if n]
    unknown = set(only) - {shape[0] for shape in SHAPES}
    if unknown:
        raise SystemExit(f"torch_flash_ab: no shape {sorted(unknown)}")
    for name, B, Sq, Sk, H, K, d, dv, causal, kw in SHAPES:
        if only and name not in only:
            continue
        q, k, v = (torch.randn(B, S, n, w, device=dev, generator=gen)
                   .to(torch.bfloat16).transpose(1, 2)
                   for S, n, w in ((Sq, H, d), (Sk, K, d), (Sk, K, dv)))
        noncausal_ms = graph_ms(
            lambda: flash_attention(q, k, v, causal=False, **kw), args.reps)
        out[name] = {"route": route(q, k, v), "ms": noncausal_ms}
        if causal:
            out[name] = {"route": route(q, k, v),
                         "ms": graph_ms(
                             lambda: flash_attention(q, k, v, **kw),
                             args.reps),
                         "noncausal_ms": noncausal_ms}
        del q, k, v
        torch.cuda.empty_cache()
    print(f"card: {_card()}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
