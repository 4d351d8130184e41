"""The paper's four benchmarks on the PyTorch port, through the full TAPA-CS
compiler pipeline (one repro_torch.compiler.compile() call per app:
partition → floorplan → pipelining → schedule simulation) → runnable
numerics on the hand-written CUDA kernels at reduced scale.

Run:  PYTHONPATH=src python examples/torch_multi_fpga_apps.py [--device cpu]
(the numerics run on the CUDA card unless ``--device cpu`` is given;
without a card and without ``--device cpu`` it raises)
"""
import argparse

from repro_torch.apps import cnn, knn, pagerank, stencil
from repro_torch.compiler import CompileOptions, compile as tapa_compile
from repro_torch.core import fpga_ring_cluster
from repro_torch.exec import resolve_device


def run_app(name, mod, build_kwargs=None, ndev=4, **options):
    """Compiles ``mod``'s graph onto an ``ndev``-FPGA ring and prints its
    partition, pipelining and schedule; ``options`` replace fields of the
    example's ``CompileOptions``.  Returns the design."""
    g = mod.build_graph(ndev, **(build_kwargs or {}))
    cl = fpga_ring_cluster(ndev)
    freq = getattr(mod, "FREQS", {"FCS": 300e6}).get("FCS", 300e6)
    design = tapa_compile(g, cl, CompileOptions(**{
        "balance_kind": "LUT", "balance_tol": 0.8, "freq_hz": freq,
        **options}))
    p, rep, res = design.partition, design.pipeline_report, design.schedule
    print(f"{name:9s} modules={len(g.tasks):4d} cut={len(p.cut_channels):3d} "
          f"crossings={rep.num_crossings:3d} "
          f"makespan={res.makespan*1e3:9.1f} ms "
          f"speedups={ {k: round(v,2) for k,v in mod.speedup_table().items()} }")
    return design


def fabric_execution(ndev=4, device=None):
    """Compile with an explicit network fabric and execute through it:
    inter-device tokens move as MTU flits over physical ring links
    (contending, backpressured), and the congestion_feedback pass reprices
    hot links before floorplanning.  Numerics stay bit-identical to the
    ideal-transfer path.  Returns (fabric result, ideal result)."""
    from repro_torch.exec import bind_programs, bit_identical, execute
    from repro_torch.net import cluster_fabric

    device = resolve_device(device)
    print(f"\nExecuting stencil through the network fabric ({ndev}-ring):")
    g = stencil.build_graph(ndev)
    cl = fpga_ring_cluster(ndev)
    design = tapa_compile(g, cl, CompileOptions(
        balance_kind="LUT", balance_tol=0.8, fabric=cluster_fabric(cl)))
    fb = design.pass_record("congestion_feedback").detail
    print(f"  congestion_feedback: max util "
          f"{fb['max_utilization_before']:.3f} -> "
          f"{fb['max_utilization_after']:.3f} "
          f"(repartitioned={fb['repartitioned']})")
    result = execute(design, bind_programs(g, device=device), device=device)
    ideal = execute(design, bind_programs(g, device=device), device=device,
                    fabric=None)
    rep = result.report
    print(f"  bit-identical to ideal path: "
          f"{bit_identical(result.outputs, ideal.outputs)}")
    print(f"  link bytes {rep.net_link_bytes:.0f} == hop-weighted cut "
          f"traffic {rep.net_hop_weighted_bytes} "
          f"(agreement {rep.agreement()})")
    hottest = max(rep.congestion.links, key=lambda l: l.utilization)
    print(f"  hottest link {hottest.name}: {hottest.bytes:.0f} B, "
          f"utilization {hottest.utilization:.3f}")
    return result, ideal


def numerics(device=None, stencil_hw=256, stencil_iters=2,
             pagerank_nodes=512, pagerank_edges=4096, pagerank_iters=20,
             knn_n=2048, knn_dim=16, knn_q=32, knn_k=10, cnn_hw=16,
             cnn_cin=32, cnn_cout=32):
    """The four apps' ``run_numeric`` on ``device``; returns their
    outputs by app."""
    device = resolve_device(device)
    where = "CUDA kernels" if device.type == "cuda" else "plain versions"
    print(f"\nReduced-scale numerics on the {where}:")
    out = stencil.run_numeric(stencil_hw, stencil_hw, iters=stencil_iters,
                              device=device)
    print(f"  stencil {stencil_hw}x{stencil_hw} x{stencil_iters}: out range "
          f"[{float(out.min()):.2f}, {float(out.max()):.2f}]")
    rank = pagerank.run_numeric(pagerank_nodes, pagerank_edges,
                                iters=pagerank_iters, device=device)
    print(f"  pagerank {pagerank_nodes}n/{pagerank_edges}e: "
          f"sum={float(rank.sum()):.4f} max={float(rank.max()):.5f}")
    d, i = knn.run_numeric(knn_n, knn_dim, knn_q, knn_k, device=device)
    print(f"  knn N={knn_n} K={knn_k}: nearest dist "
          f"mean={float(d[:, 0].mean()):.3f}")
    conv = cnn.run_numeric(cnn_hw, cnn_hw, cnn_cin, cnn_cout, device=device)
    print(f"  cnn conv3 {cnn_hw}x{cnn_hw}x{cnn_cin}: "
          f"out std={float(conv.std(correction=0)):.3f}")
    return {"stencil": out, "pagerank": rank, "knn": (d, i), "cnn": conv}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print("TAPA-CS partitioning of the paper's four apps (4-FPGA ring):")
    run_app("stencil", stencil, {"iters": 256})
    run_app("pagerank", pagerank)
    run_app("knn", knn)
    run_app("cnn", cnn)
    fabric_execution(device=device)
    numerics(device)


if __name__ == "__main__":
    main()
