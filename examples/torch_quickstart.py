"""Quickstart on the PyTorch port: the TAPA-CS flow end-to-end on one page.

1. Express a workload as a task graph (here: the paper's KNN app).
2. Compile it onto a 4-FPGA ring with ONE call — repro_torch.compiler.
   compile() runs the whole pass pipeline: unit normalization, ILP
   partition (Eq. 1-2), per-device floorplan (Eq. 4), interconnect
   pipelining (C5), and the cost-model schedule.
3. EXECUTE the compiled design — repro_torch.exec runs the partitioned
   dataflow graph for real on the card (bounded FIFO channels at the §4.6
   balanced depths, inter-device transfers, the KNN kernel in every blue
   module) and checks the measured traffic against the partition's Eq. 2
   accounting.
4. Train a small LM for a few steps with the same machinery underneath.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(on the CUDA card unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises)
"""
import argparse

import numpy as np
import torch

from repro_torch.apps import knn as knn_app
from repro_torch.compiler import CompileOptions, compile as tapa_compile
from repro_torch.core import fpga_ring_cluster, verify_balanced
from repro_torch.exec import resolve_device


def compile_flow(ndev=4, n_points=4_000_000, dim=16, **options):
    """KNN (paper Fig. 4) compiled onto an ``ndev``-FPGA ring; ``options``
    replace fields of the example's ``CompileOptions``."""
    print("=" * 60)
    print(f"TAPA-CS flow: KNN (paper Fig. 4) on a {ndev}-FPGA ring")
    print("=" * 60)
    g = knn_app.build_graph(ndev=ndev, n_points=n_points, dim=dim)
    cl = fpga_ring_cluster(ndev)
    # One entry point for the whole flow.  hbm_tasks are softly pinned to
    # HBM-adjacent rows; floorplan_devices=(0,) keeps the example quick
    # (drop it to floorplan every FPGA).
    opts = dict(
        balance_kind="LUT", balance_tol=0.8,
        hbm_tasks=tuple(t for t in g.tasks if t.startswith("dist")),
        floorplan_devices=(0,),
        freq_hz=knn_app.FREQS["FCS"])
    opts.update(options)
    design = tapa_compile(g, cl, CompileOptions(**opts))

    p = design.partition
    for d in range(ndev):
        tasks = p.device_tasks(d)
        print(f"  FPGA {d}: {len(tasks)} modules "
              f"({', '.join(tasks[:4])}{'...' if len(tasks) > 4 else ''})")
    print(f"  cut channels: {len(p.cut_channels)}, "
          f"comm cost (Eq.2): {p.comm_cost:.0f}")
    for d, fp in sorted(design.floorplans.items()):
        print(f"  FPGA{d} floorplan: wirelength {fp.wirelength:.0f}, "
              f"{fp.grid.num_slots} slots")
    rep = design.pipeline_report
    print(f"  pipelined {rep.num_crossings} crossings "
          f"(max {rep.max_crossing} stages); balanced: "
          f"{verify_balanced(g, rep)}")
    print(f"  simulated makespan: {design.schedule.makespan * 1e3:.1f} ms")
    print(f"  pass times: "
          f"{ {r.name: round(r.wall_time_s, 2) for r in design.pass_records} }")
    print(f"  modeled speedups vs Vitis: "
          f"{ {k: round(v, 2) for k, v in knn_app.speedup_table().items()} }")
    return design


def execute_flow(design, device=None):
    """Runs the design for real: compile(...) -> execute(...) -> report,
    on ``device`` (the card unless the caller names another)."""
    result = design.execute(device=resolve_device(device))
    rpt = result.report
    dists, idx = result.outputs
    print(f"  executed: {rpt.iterations} query batches in {rpt.sweeps} "
          f"sweeps, top-{dists.shape[-1]} dists OK "
          f"(first: {float(dists[0, 0, 0]):.3f})")
    print(f"  measured inter-FPGA traffic: {rpt.measured_inter_bytes} B "
          f"over {rpt.measured_cut_channels} cut channels; "
          f"accounting agreement: {rpt.agreement()}")
    return result


def tapa_cs_flow(device=None, **sizes):
    """(design, result): :func:`compile_flow` then :func:`execute_flow`."""
    design = compile_flow(**sizes)
    return design, execute_flow(design, device)


def tiny_lm_train(arch="qwen3-4b", steps=20, lr=3e-3, batch=4, seq=32,
                  seed=0, device=None):
    """``steps`` AdamW steps of ``arch``'s smoke config through
    ``train_loss`` and ``adamw_update``, each on the next slice of a
    random token stream; returns the losses."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, train_loss
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    print("\n" + "=" * 60)
    print(f"Tiny LM training (qwen3 smoke config, {steps} steps)")
    print("=" * 60)
    device = resolve_device(device)
    cfg = get_arch(arch).smoke()
    params = init_params(torch.Generator(device=device).manual_seed(seed),
                         cfg)
    opt_state = adamw_init(params)
    opt_cfg = AdamWConfig(lr=lr)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)

    def step(params, opt_state, tokens, targets):
        batch = {"tokens": tokens, "targets": targets,
                 "weights": torch.ones(tokens.shape, dtype=torch.float32,
                                       device=device)}
        loss = train_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads))
        params, new_opt = adamw_update(
            params, tree_map(lambda _: next(it), params), opt_state, opt_cfg)
        return (params, {k: new_opt[k] for k in ("mu", "nu", "count")},
                loss.detach())

    data = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (steps + 1, batch, seq))).to(device)
    losses = []
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state,
                                       data[i], data[i + 1])
        losses.append(float(loss))
        if i % 5 == 0:
            print(f"  step {i}: loss {losses[-1]:.3f}")
    print(f"  final loss {losses[-1]:.3f}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    tapa_cs_flow(device)
    tiny_lm_train(device=device)


if __name__ == "__main__":
    main()
