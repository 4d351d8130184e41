"""repro_torch — TAPA-CS on PyTorch, with hand-written Hopper kernels.

The PyTorch/CUDA port of the JAX package ``repro``, which stays beside it
as the reference.  The port imports nothing of ``repro`` and no JAX: it
carries its own copy of the framework-free modules (``core``,
``compiler``).  The slice ported so far is the paper's main flow for
Stencil, CNN and KNN::

    from repro_torch.apps import APPS
    from repro_torch.compiler import CompileOptions, compile
    from repro_torch.core import fpga_ring_cluster

    graph = APPS["stencil"].build_graph(4, iters=64)
    design = compile(graph, fpga_ring_cluster(4), CompileOptions())
    result = design.execute({"h": 256, "w": 256}, fabric=None)  # on cuda
    result.report.agreement()

Every entry point runs on the CUDA device unless the caller passes
``device="cpu"`` (the kernels' plain PyTorch versions).
"""
