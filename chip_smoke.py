"""Drive the PyTorch port on one CUDA card and hold its kernels to account.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Build: compiles ``src/repro_torch/csrc/*.cu`` for ``sm_90a`` (one
   ``nvcc`` per source, in parallel) and prints ``ptxas -v`` on a fresh
   build.
3. Kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the main path gives it (dilate exact; matmul
   within 2e-4 of the output's scale; knn distances within 1e-4, indices
   equal wherever the neighbours' distances differ by more than that),
   timed with CUDA events beside the plain version, the one-call PyTorch
   yardstick where one exists, and the bound the card's data-sheet rates
   give (3.35 TB/s, 67 TFLOP/s fp32).  Each row also carries
   ``device_kernels``: the mean device time of every ``__global__`` the
   wrapper launched, from ``torch.profiler`` (knn launches two passes).
   KNN's general path (D > 64 or k > 32) is checked too, at small shapes.
4. Path: stencil, CNN and KNN each built at the app's own size, compiled
   onto a 4-FPGA ring with the executor smoke's options, and executed
   through ``compile()`` → ``execute()`` on the card.  Checks parity with
   the binding's single-device ``reference()``, every ``agreement()``
   value, no starvation, and that the app's kernel launched during
   ``execute`` (launch counts are zeroed just before it and read just
   after).

Prints the ``kernels`` JSON line, then the card line, and last
``{"ok": true, "device": {...}}``.  Needs no network and one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Data-sheet peaks of one H100 SXM (dense, at the full 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

SMOKE_OPTIONS = dict(balance_kind="LUT", balance_tol=0.8,
                     floorplan_devices=(0,), exact_limit=1500)
STENCIL_SPEC = {"h": 4096, "w": 4096, "stage_iters": 16, "streams": 2,
                "seed": 0}
CNN_SPEC = {"h": 32, "w": 32, "cin": 64, "cout_per_col": 4, "streams": 32,
            "seed": 0}
KNN_SPEC = {"n": 4_000_000, "dim": 16, "q": 128, "k": 10, "streams": 2,
            "seed": 0}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernels(fn, reps: int = 20) -> list:
    """``[name, count, mean ms]`` of every CUDA kernel ``fn`` launches,
    from ``torch.profiler`` over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [[e.key, e.count, e.device_time_total / e.count / 1e3]
            for e in prof.key_averages()
            if e.count and e.device_time_total > 0]


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def knn_index_check(q, data, got_i, ref_d, ref_i, tol) -> int:
    """Positions whose index differs from the plain version's, and whose
    point is not within ``tol`` of the plain version's distance there (a
    near-tie may order either way).  Returns their count."""
    diff = got_i != ref_i
    if not bool(diff.any()):
        return 0
    pts = data[got_i.long()].double()                 # [Q, k, D]
    true_d = ((q.double()[:, None, :] - pts) ** 2).sum(-1)
    bad = diff & ((true_d - ref_d.double()).abs() > tol)
    return int(bad.sum())


# -- phase 3: kernels against their plain versions ---------------------------

def kernel_phase(dev) -> dict:
    from repro_torch.kernels import conv_op, dilate_op, knn_op, matmul_op
    from repro_torch.kernels.knn.ref import knn_ref
    from repro_torch.kernels.stencil_dilate.ref import dilate_ref
    from repro_torch.kernels.systolic_matmul.ref import im2col3x3, matmul_ref

    torch.backends.cuda.matmul.allow_tf32 = False     # full fp32 yardstick
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # dilate: one pass over a 4096 x 4096 image, the stencil's tile height.
    h = w = STENCIL_SPEC["h"]
    img = torch.randn(h, w, device=dev, generator=gen)
    got = dilate_op(img, iters=1, block_rows=min(128, h))
    ref = dilate_ref(img)
    require(torch.equal(got, ref), "dilate differs from its plain version")
    got16 = dilate_op(img, iters=STENCIL_SPEC["stage_iters"],
                      block_rows=min(128, h))
    ref16 = img
    for _ in range(STENCIL_SPEC["stage_iters"]):
        ref16 = dilate_ref(ref16)
    require(torch.equal(got16, ref16), "16 dilate passes differ")
    out = torch.empty_like(img)
    from repro_torch.kernels.stencil_dilate.kernel import dilate

    def one_pass():
        return dilate(img, out, block_rows=min(128, h))

    ms = cuda_ms(one_pass, 50)
    plain = cuda_ms(lambda: dilate_ref(img), 10)
    b, by = bound(2 * h * w * 4, 12 * h * w)
    rows["dilate"] = dict(shape=[h, w], max_abs_err=0.0, ms=ms,
                          plain_ms=plain, bound_ms=b, bound_by=by,
                          library_ms=None, bytes=2 * h * w * 4,
                          ops=12 * h * w,
                          device_kernels=device_kernels(one_pass))

    # matmul: the CNN column's im2col product and the reference's.
    hh, cin, cpc = CNN_SPEC["h"], CNN_SPEC["cin"], CNN_SPEC["cout_per_col"]
    x = torch.randn(hh, hh, cin, device=dev, generator=gen)
    cols = im2col3x3(x)                                # [1024, 576]
    M, K = cols.shape
    errs = {}
    for N in (cpc, 20 * cpc):
        wt = torch.randn(K, N, device=dev, generator=gen) * 0.05
        got = matmul_op(cols, wt)
        ref = matmul_ref(cols, wt)
        err = float((got - ref).abs().max())
        errs[N] = err
        scale = max(1.0, float(ref.abs().max()))
        require(err <= 2e-4 * scale,
                f"matmul [{M},{K}]x[{K},{N}] err {err:.3e} > 2e-4*{scale:.2f}")
    wt = torch.randn(K, cpc, device=dev, generator=gen) * 0.05
    wconv = wt.reshape(3, 3, cin, cpc)
    conv_err = float((conv_op(x, wconv)
                      - matmul_ref(cols, wt).reshape(hh, hh, cpc)).abs().max())
    require(conv_err <= 2e-4, f"conv err {conv_err:.3e}")
    from repro_torch.kernels.systolic_matmul.kernel import matmul
    ms = cuda_ms(lambda: matmul(cols, wt), 200)
    plain = cuda_ms(lambda: matmul_ref(cols, wt), 200)
    lib = cuda_ms(lambda: torch.matmul(cols, wt), 200)
    nbytes = 4 * (M * K + K * cpc + M * cpc)
    ops = 2 * M * K * cpc
    b, by = bound(nbytes, ops)
    rows["matmul"] = dict(shape=[M, K, cpc], max_abs_err=errs[cpc], ms=ms,
                          plain_ms=plain, bound_ms=b, bound_by=by,
                          library_ms=lib, bytes=nbytes, ops=ops,
                          max_abs_err_reference_shape=errs[20 * cpc],
                          device_kernels=device_kernels(
                              lambda: matmul(cols, wt)))

    # knn: a blue module's shard and the whole dataset (the reference).
    n, dim, q, k = (KNN_SPEC[s] for s in ("n", "dim", "q", "k"))
    data = torch.randn(n, dim, device=dev, generator=gen)
    queries = torch.randn(q, dim, device=dev, generator=gen)
    shard_n = -(-n // 72)
    checks = {}
    for name, pts in (("shard", data[:shard_n]), ("full", data)):
        gd, gi = knn_op(queries, pts, k)
        rd, ri = knn_ref(queries, pts, k)
        require(gi.dtype == torch.int32 and gd.dtype == torch.float32,
                "knn output types")
        derr = float((gd - rd).abs().max())
        require(derr <= 1e-4, f"knn {name} distance err {derr:.3e}")
        bad = knn_index_check(queries, pts, gi, rd, ri, 1e-4)
        require(bad == 0, f"knn {name}: {bad} indices differ beyond ties")
        checks[name] = (derr, int((gi != ri).sum()))
    # The general path (D > 64 or k > 32), at small shapes; the data are
    # scaled so the distances stay O(10), where fp32 rounding of either
    # side's sums stays well inside the 1e-4 tolerance.
    general = {}
    for gq, gn, gdim, gk in ((130, 20_000, 128, 10), (64, 20_000, 16, 64),
                             (33, 3_000, 100, 40)):
        gx = torch.randn(gn, gdim, device=dev, generator=gen) * 0.2
        gqs = torch.randn(gq, gdim, device=dev, generator=gen) * 0.2
        gd, gi = knn_op(gqs, gx, gk)
        rd, ri = knn_ref(gqs, gx, gk)
        derr = float((gd - rd).abs().max())
        require(gi.dtype == torch.int32 and derr <= 1e-4,
                f"knn general Q{gq} N{gn} D{gdim} k{gk}: err {derr:.3e}")
        bad = knn_index_check(gqs, gx, gi, rd, ri, 1e-4)
        require(bad == 0, f"knn general D{gdim} k{gk}: {bad} indices differ")
        general[f"Q{gq} N{gn} D{gdim} k{gk}"] = derr
    from repro_torch.kernels.knn.kernel import knn
    shard = data[:shard_n]
    ms = cuda_ms(lambda: knn(queries, shard, k), 100)
    plain = cuda_ms(lambda: knn_ref(queries, shard, k), 20)
    ms_full = cuda_ms(lambda: knn(queries, data, k), 10)
    plain_full = cuda_ms(lambda: knn_ref(queries, data, k), 3)

    def knn_cost(npts):
        nbytes = 4 * (q * dim + npts * dim) + 8 * q * k
        ops = q * npts * (2 * dim + 4) + 2 * dim * (npts + q)
        return nbytes, ops

    nbytes, ops = knn_cost(shard_n)
    b, by = bound(nbytes, ops)
    fb, fops = knn_cost(n)
    b_full, by_full = bound(fb, fops)
    rows["knn"] = dict(shape=[q, shard_n, dim, k],
                       max_abs_err=checks["shard"][0], ms=ms,
                       plain_ms=plain, bound_ms=b, bound_by=by,
                       library_ms=None, bytes=nbytes, ops=ops,
                       index_diffs_at_ties=checks["shard"][1],
                       device_kernels=device_kernels(
                           lambda: knn(queries, shard, k)),
                       general_path_max_abs_err=general,
                       full=dict(shape=[q, n, dim, k],
                                 max_abs_err=checks["full"][0],
                                 index_diffs_at_ties=checks["full"][1],
                                 ms=ms_full, plain_ms=plain_full,
                                 bound_ms=b_full, bound_by=by_full,
                                 device_kernels=device_kernels(
                                     lambda: knn(queries, data, k), 5)))
    for name, row in rows.items():
        print(f"[kernel] {name} {json.dumps(row)}", flush=True)
    return rows


# -- phase 4: the main path --------------------------------------------------

def path_phase(app: str, spec: dict, graph_args: tuple, kernel: str) -> dict:
    from repro_torch.apps import APPS
    from repro_torch.compiler import CompileOptions, compile
    from repro_torch.core import fpga_ring_cluster
    from repro_torch.exec import bind_programs, execute
    from repro_torch.kernels import launch_counts, reset_launch_counts

    mod = APPS[app]
    graph = mod.build_graph(*graph_args)
    t0 = time.perf_counter()
    design = compile(graph, fpga_ring_cluster(4),
                     CompileOptions(**SMOKE_OPTIONS))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    binding = bind_programs(graph, spec)             # on cuda
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = execute(design, binding, fabric=None)
    torch.cuda.synchronize()
    exec_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    expected = binding.reference()
    got = result.outputs
    if isinstance(got, tuple):                      # knn: (dists, idx)
        require(got[1].dtype == torch.int32, "knn indices are not int32")
        err = float((got[0] - expected[0]).abs().max())
        idx_diff = int((got[1] != expected[1]).sum())
        require(idx_diff == 0, f"knn path: {idx_diff} indices differ")
        require(got[0].shape == expected[0].shape, "knn output shape")
    else:
        require(got.shape == expected.shape, f"{app} output shape")
        require(bool(torch.isfinite(got).all()), f"{app} output not finite")
        err = float((got - expected).abs().max())
    agree = result.report.agreement()
    rep = result.report
    row = {"app": app, "graph": graph.name, "tasks": len(graph.tasks),
           "compile_s": compile_s, "bind_s": bind_s, "execute_s": exec_s,
           "sweeps": rep.sweeps, "firings": sum(rep.device_fired.values()),
           "measured_inter_bytes": rep.measured_inter_bytes,
           "peak_device_bytes": peak, "parity_max_err": err,
           "atol": binding.atol, "agreement": agree,
           "starvation_events": rep.starvation_events,
           "launches": launches,
           "partition": design.partition.stats.method}
    print(f"[path] {json.dumps(row)}", flush=True)
    require(err <= binding.atol, f"{app}: parity err {err} > {binding.atol}")
    require(all(agree.values()), f"{app}: agreement {agree}")
    require(not rep.starvation_events, f"{app}: starvation")
    require(launches[kernel] > 0,
            f"{app}: kernel {kernel} never launched during execute")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script (expected "
              f"{ROOT / 'src' / 'repro_torch'}): {e}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    info = build.build()
    print(f"build: {'built' if info.built else 'reused'} {info.path.name} "
          f"in {info.seconds:.2f} s", flush=True)
    if info.built:
        print(info.log.rstrip(), flush=True)
    build.library()

    rows = kernel_phase(dev)

    paths = [
        path_phase("stencil", STENCIL_SPEC, (4, 64), "dilate"),
        path_phase("cnn", CNN_SPEC, (4,), "matmul"),
        path_phase("knn", KNN_SPEC, (4,), "knn"),
    ]
    launches = {k: p["launches"][k]
                for p, k in zip(paths, ("dilate", "matmul", "knn"))}

    sources = {"dilate": ("src/repro_torch/csrc/dilate.cu",
                          "src/repro/kernels/stencil_dilate/kernel.py:52"),
               "matmul": ("src/repro_torch/csrc/matmul.cu",
                          "src/repro/kernels/systolic_matmul/kernel.py:42"),
               "knn": ("src/repro_torch/csrc/knn.cu",
                       "src/repro/kernels/knn/kernel.py:72")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": repl, "launches": launches[name],
                "max_abs_err": rows[name]["max_abs_err"],
                "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
                "bound_ms": rows[name]["bound_ms"],
                "bound_by": rows[name]["bound_by"],
                "library_ms": rows[name]["library_ms"]}
               for name, (src, repl) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
