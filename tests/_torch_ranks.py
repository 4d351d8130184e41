"""Multi-rank runs of the port on the CPU, for the parity tests.

    python tests/_torch_ranks.py SCENARIO WORLD WORKDIR

spawns WORLD processes that meet through a ``file://`` store in WORKDIR
(no port), each on one thread, on the gloo backend.  Each loads
``WORKDIR/in.pt`` (written by the test), runs SCENARIO and rank 0 writes
``WORKDIR/out.pt``; the test holds that against the JAX package.  The
test runs this under a timeout of its own, so a hung collective fails
the test.
"""
import logging
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("pod", "data", "model")[-len(shape):])


def train(rank, inp):
    """Steps of ``build_train_step(mesh=)`` from the given state; the
    losses, the whole state after them and every leaf whose local block
    has another shape than its spec gives."""
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps
    from repro_torch.models.layers import ParamTree, tree_map_with_keys
    cfg, opt = inp["cfg"], inp["optimizer"]
    mesh = _mesh(inp["mesh"])
    state = {"params": ParamTree(inp["params"]), "opt": inp["opt"],
             "step": torch.zeros((), dtype=torch.int32)}
    state = steps.shard_state(state, cfg, mesh, opt)
    specs = steps.state_shardings(cfg, mesh, opt)
    spec_of = dict(sh.flat_specs({k: specs[k] for k in ("params", "opt")}))
    bad = []

    def check(keys, leaf):
        if keys == ("opt", "count"):
            return
        want = sh.local_shape(spec_of[keys], tuple(leaf.shape), mesh)
        if tuple(leaf.to_local().shape) != want:
            bad.append((keys, tuple(leaf.to_local().shape), want))
    tree_map_with_keys(check, {"params": state["params"],
                               "opt": state["opt"]})
    step = steps.build_train_step(cfg, opt, inp["microbatches"],
                                  device="cpu", mesh=mesh)
    losses = []
    for batch in inp["batches"]:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    full = steps.full_state({"params": state["params"],
                             "opt": state["opt"]})
    return {"losses": losses, "state": full, "bad_shapes": bad,
            "step": int(state["step"])}


def serve(rank, inp):
    """The prefill step and decode steps through ``mesh=`` for each case
    (batch, prefill tokens, decode tokens); the logits."""
    from repro_torch.launch import steps
    from repro_torch.models import init_cache
    from repro_torch.models.layers import ParamTree
    cfg = inp["cfg"]
    mesh = _mesh(inp["mesh"])
    params = ParamTree(inp["params"])
    train_layout = steps.shard_params(params, cfg, mesh)
    serve_layout = steps.shard_params(params, cfg, mesh, serve=True)
    prefill = steps.build_prefill_step(cfg, device="cpu", mesh=mesh)
    decode = steps.build_serve_step(cfg, device="cpu", mesh=mesh)
    out = []
    for case in inp["cases"]:
        logits = prefill(train_layout, {"tokens": case["prefill"]})
        tokens = case["decode"]
        B = tokens.shape[0]
        cache = steps.shard_cache(init_cache(cfg, B, case["max_len"],
                                             device="cpu"), cfg, mesh)
        dec = []
        for t in range(tokens.shape[1]):
            cache, lg = decode(serve_layout, cache, tokens[:, t:t + 1], t)
            dec.append(lg)
        out.append({"prefill": logits, "decode": dec,
                    "placements": {k: [repr(p) for p in v.placements]
                                   for k, v in cache["blocks"][0].items()}})
    return out


def pipeline(rank, inp):
    """``gpipe_forward`` of tanh(x @ w[i]) for each microbatch count; a
    count that does not divide the batch must raise."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.pipeline import gpipe_forward
    mesh = _mesh(inp["mesh"])
    x = inp["x"]
    # Each pod holds its own stage's slice, as JAX's P("pod").
    w = distribute_tensor(inp["w"], mesh, [Shard(0), Replicate(),
                                           Replicate()])
    out = {}
    for M in inp["microbatches"]:
        out[M] = gpipe_forward(lambda wi, xb: torch.tanh(xb @ wi), w, x,
                               mesh, microbatches=M)
    try:
        gpipe_forward(lambda wi, xb: torch.tanh(xb @ wi), w, x, mesh,
                      microbatches=inp["bad"])
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    return out


def psum(rank, inp):
    """``compressed_psum`` of each rank's row over the whole group; every
    rank's result."""
    from repro_torch.optim import compressed_psum
    out = []
    for x in inp["inputs"]:
        got = compressed_psum(x[rank], group=None)
        every = [torch.empty_like(got) for _ in range(dist.get_world_size())]
        dist.all_gather(every, got)
        out.append(torch.stack(every))
    return out


SCENARIOS = {"train": train, "serve": serve, "pipeline": pipeline,
             "psum": psum}


def _run(rank, world, scenario, workdir):
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(workdir, "in.pt"), weights_only=False)
        out = SCENARIOS[scenario](rank, inp)
        if rank == 0:
            torch.save(out, os.path.join(workdir, "out.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    scenario, world, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_run, args=(world, scenario, workdir), nprocs=world)
