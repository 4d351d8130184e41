"""Time the tiled fp32 matmul kernel of the PyTorch port under every plan
it can take at a few products, beside the plan that ``tiled_plan`` picks
and one ``torch.matmul`` (TF32 off), to calibrate and check the plan.

    PYTHONPATH=src python scripts/torch_matmul_sweep.py [--max-splits 48]
        [--out results/matmul_sweep_torch.json]

Products: CNN's ``run_numeric`` default, [1024, 576] x [576, 64]; a VGG-16
conv3 layer, [3136, 2304] x [2304, 256]; the CNN column's [1024, 576] x
[576, 4] (which ``route()`` sends to the narrow kernel: here the tiled
kernel's own time); [1024, 576] x [576, 17], just past the narrow route.
Inputs are drawn from ``--seed``.  Every plan's result is held to
``matmul_ref`` within 2e-4 of the output's scale.  Each time is the
device time of one call: calls captured in one CUDA graph and replayed
five times between CUDA events.  Prints the card's name and power limit,
the kernel instances' ``ptxas -v`` registers and spills when it built the
library, and one JSON line a product: the picked plan's ms and modelled
ns, ``torch.matmul``'s ms and the three fastest plans; the whole sweep
goes to ``--out``.  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.systolic_matmul import kernel as mm
from repro_torch.kernels.systolic_matmul.ref import matmul_ref

SHAPES = (("cnn_default", 1024, 576, 64), ("vgg_conv3", 3136, 2304, 256),
          ("cnn_column", 1024, 576, 4), ("past_narrow", 1024, 576, 17))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def graph_ms(fn, reps: int, replays: int = 5) -> float:
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


def plans(M: int, K: int, N: int, max_splits: int) -> list:
    """Every (tile, splits) that gives each split whole slabs and none an
    empty range, as :class:`TiledPlan`\\ s."""
    total = -(-K // mm.SLAB)
    out = []
    for bm, bn in mm.TILES:
        tiles = -(-M // bm) * -(-N // bn)
        for splits in range(1, min(total, max_splits) + 1):
            slabs = -(-total // splits)
            if -(-total // slabs) == splits:
                out.append(mm.TiledPlan(
                    bm, bn, splits, slabs, tiles, tiles * splits,
                    mm._model_ns(M, K, N, bm, bn, splits, slabs)))
    return out


def reps_for(M: int, K: int, N: int) -> int:
    return max(10, min(200, int(2e9 / (2 * M * K * N) * 20)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-splits", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/matmul_sweep_torch.json")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {_card()}", flush=True)
    info = build.build()
    if info.built:
        lines = info.log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "matmul" in line:
                print(line.strip(), flush=True)
                for nxt in lines[i + 1:i + 4]:
                    if "Compiling entry function" in nxt:
                        break
                    print("  " + nxt.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    sweep = {}
    for name, M, K, N in SHAPES:
        a = torch.randn(M, K, device="cuda", generator=gen)
        b = torch.randn(K, N, device="cuda", generator=gen) * 0.05
        ref = matmul_ref(a, b)
        scale = max(1.0, float(ref.abs().max()))
        reps = reps_for(M, K, N)
        rows = []
        for plan in plans(M, K, N, args.max_splits):
            got = mm._launch_tiled(a, b, plan)
            err = float((got - ref).abs().max())
            if err > 2e-4 * scale:
                raise SystemExit(f"{name} plan {plan}: err {err:.3e} > "
                                 f"2e-4 * {scale:.3f}")
            ms = graph_ms(lambda: mm._launch_tiled(a, b, plan), reps)
            rows.append(dict(bm=plan.bm, bn=plan.bn, splits=plan.splits,
                             slabs=plan.slabs, blocks=plan.blocks, ms=ms,
                             model_ns=plan.model_ns, max_abs_err=err))
        picked = mm.tiled_plan(M, K, N)
        picked_ms = graph_ms(lambda: mm._launch_tiled(a, b), reps)
        lib_ms = graph_ms(lambda: torch.matmul(a, b), reps)
        fastest = sorted(rows, key=lambda r: r["ms"])[:3]
        sweep[name] = dict(shape=[M, K, N], plan=dict(
            bm=picked.bm, bn=picked.bn, splits=picked.splits,
            blocks=picked.blocks, model_ns=picked.model_ns), ms=picked_ms,
            library_ms=lib_ms, scale=scale, plans=rows)
        print(json.dumps(dict(product=name, shape=[M, K, N],
                              plan=sweep[name]["plan"], ms=picked_ms,
                              library_ms=lib_ms, fastest=fastest)),
              flush=True)
        del a, b, ref
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=_card(), sweep=sweep), indent=1))
    print(f"card: {_card()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
