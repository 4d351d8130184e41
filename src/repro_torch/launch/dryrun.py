"""Multi-pod dry run: run every (architecture × input shape × mesh) cell's
step once on fake tensors over a fake process group and extract the
roofline inputs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch

Per cell this (1) builds the partition Plan (ILP/advisor) for the H100's
memory, (2) places the state and the inputs as fake DTensors on the
production mesh (16×16, or 2×16×16 with a 'pod' axis) by the sharding
rules, (3) runs the step once (``lowered.compile()``) under the FLOP
counter, the collective recorder and the memory tracker, (4) prints
``memory_summary`` / ``cost_summary``, (5) sums the collective bytes
(within a pod and across pods), (6) writes the roofline terms to JSON.
The step runs on the CPU with the kernels' plain versions; nothing is
allocated and no kernel runs.

The process group is the ``"fake"`` backend of PyTorch's test utilities
(a rank 0 that joins every collective and moves nothing), set up here for
each cell: a process has one default group.  Its store is imported from
its private module in one place; without it the dry run fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import time
import traceback
from typing import Dict, Optional, Tuple

import torch.distributed as dist

from ..configs import ALL_ARCHS, get_arch, input_specs, supported_shapes
from ..configs.base import SHAPES
from ..core.costmodel import roofline
from . import analytic, hlo_analysis, steps
from .mesh import MULTI_POD, SINGLE_POD, make_mesh
from .plan import make_plan

#: The H100 SXM's data-sheet values, the roofline's rates: dense bf16
#: tensor-core peak, HBM3 bandwidth and capacity, and NDR InfiniBand's
#: 400 Gb/s (50 GB/s) per card for the collectives.  A 256-card pod spans
#: 32 nodes (NVLink joins only the 8 cards of a node), so collectives
#: within a pod and across pods both ride the InfiniBand links.
H100 = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "hbm_bytes": 80e9,
        "ici_bw": 50e9, "dcn_bw": 50e9}


def _fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


def fake_group(world_size: int) -> None:
    """The default process group: rank 0 of ``world_size`` on the fake
    backend (replacing any earlier fake group)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=world_size)


def _mesh_name(mesh_shape) -> str:
    return "x".join(map(str, mesh_shape))


def run_cell(arch: str, shape: str, multi_pod: bool,
             overrides: Optional[Dict] = None) -> Dict:
    """Run one cell's step on fake tensors over the production mesh;
    returns the result record."""
    cfg = get_arch(arch).full()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return run_on_mesh(arch, cfg, shape, *(MULTI_POD if multi_pod
                                           else SINGLE_POD))


def run_on_mesh(arch: str, cfg, shape: str, mesh_shape: Tuple[int, ...],
                axes: Tuple[str, ...]) -> Dict:
    """:func:`run_cell`'s work for any config of ``arch`` on any mesh
    (``axes``: ('pod', 'data', 'model') or ('data', 'model'))."""
    t0 = time.perf_counter()
    fake_group(math.prod(mesh_shape))
    mesh = make_mesh(mesh_shape, axes, device_type="cpu")
    chips = mesh.size()
    num_pods = mesh_shape[0] if "pod" in axes else 1
    chips_per_pod = chips // num_pods
    cell = SHAPES[shape]
    plan = make_plan(arch, cfg, shape, num_pods=num_pods,
                     hbm_per_chip=H100["hbm_bytes"])
    specs = input_specs(cfg, shape)

    rec: Dict = {
        "arch": arch, "shape": shape, "mesh": _mesh_name(mesh_shape),
        "chips": chips, "kind": cell.kind,
        "plan": {"pod_strategy": plan.pod_strategy,
                 "optimizer": plan.optimizer,
                 "microbatches": plan.microbatches,
                 "param_bytes": plan.param_bytes,
                 "rationale": plan.rationale,
                 "compiler": (plan.compiled.summary()
                              if plan.compiled is not None else None)},
        "ok": False,
    }
    try:
        if cell.kind == "train":
            lowered = steps.lower_train(cfg, mesh, specs,
                                        optimizer=plan.optimizer,
                                        microbatches=plan.microbatches)
        elif cell.kind == "prefill":
            lowered = steps.lower_prefill(cfg, mesh, specs)
        else:
            lowered = steps.lower_serve(cfg, mesh, specs)
        t_lower = time.perf_counter() - t0
        compiled = lowered.compile()
        t_compile = time.perf_counter() - t0 - t_lower

        mem = hlo_analysis.memory_summary(compiled)
        cost = hlo_analysis.cost_summary(compiled)
        print(f"[{arch}/{shape}/{rec['mesh']}] memory: {mem}")
        print(f"[{arch}/{shape}/{rec['mesh']}] cost: "
              f"{ {k: v for k, v in cost.items() if k != 'flops_by_op'} }")

        colls = hlo_analysis.parse_collectives(
            compiled.collectives, chips_per_pod=chips_per_pod)
        agg = hlo_analysis.collective_bytes(colls)
        ana = analytic.analyze(cfg, shape)
        terms = roofline(
            hlo_flops=ana.flops_global / chips,
            hlo_bytes=ana.hbm_bytes_global / chips,
            ici_bytes=agg["ici"], dcn_bytes=agg["dcn"], chips=chips,
            peak_flops=H100["peak_flops"], hbm_bw=H100["hbm_bw"],
            ici_bw=H100["ici_bw"], dcn_bw=H100["dcn_bw"])
        rec.update({
            "ok": True,
            "lower_s": t_lower,
            "compile_s": t_compile,
            "memory": mem,
            "cost_raw": cost,
            "collectives": {
                "ici_bytes": agg["ici"], "dcn_bytes": agg["dcn"],
                "raw_once_bytes": agg["raw_once"],
                "by_kind": agg["by_kind"],
                "by_kind_dcn": _by_kind(colls, dcn=True),
                "num_ops": len(colls)},
            "analytic": {
                "flops_global": ana.flops_global,
                "hbm_bytes_global": ana.hbm_bytes_global,
                "model_flops": ana.model_flops},
            "roofline": {
                "spec": "H100 SXM data sheet",
                "compute_s": terms.compute_s,
                "memory_s": terms.memory_s,
                "collective_s": terms.collective_s,
                "dominant": terms.dominant,
                "bound_s": terms.bound_s,
                "model_flops_ratio": (ana.model_flops
                                      / max(ana.flops_global, 1.0)),
            },
        })
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[{arch}/{shape}/{rec['mesh']}] FAILED: {rec['error']}")
    finally:
        dist.destroy_process_group()
    rec["total_s"] = time.perf_counter() - t0
    return rec


def _by_kind(ops, dcn: bool) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for op in ops:
        if op.is_dcn == dcn:
            out[op.kind] = out.get(op.kind, 0.0) + op.bytes_per_exec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    if args.all:
        for arch in ALL_ARCHS:
            mod = get_arch(arch)
            for shape in SHAPES:
                if shape in supported_shapes(mod):
                    cells.append((arch, shape))
                else:
                    for mp in meshes:
                        rec = {"arch": arch, "shape": shape,
                               "mesh": _mesh_name(
                                   (MULTI_POD if mp else SINGLE_POD)[0]),
                               "ok": None, "skipped":
                               "full-attention arch at 500k ctx "
                               "(long_500k runs only for "
                               "SSM/hybrid/linear-attn)"}
                        _write(args.out, rec)
    else:
        cells = [(args.arch, args.shape)]

    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp)
            _write(args.out, rec)
            if rec.get("ok") is False:
                n_fail += 1
            print(f"--- {arch}/{shape}/{rec['mesh']}: "
                  f"{'OK' if rec.get('ok') else 'FAIL'} "
                  f"({rec.get('total_s', 0):.1f}s)")
    return 1 if n_fail else 0


def _write(out_dir: str, rec: Dict) -> None:
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1, default=float)


if __name__ == "__main__":
    raise SystemExit(main())
