"""Pipeline parallelism over the pod axis — GPipe-style microbatch
pipeline (the `pp` strategy the TAPA-CS partitioner recommends when a
model's train state exceeds one pod's Eq. 1 budget, e.g. deepseek-v3).

Mechanics, as JAX's ``shard_map`` + ``lax.ppermute`` schedule: each pod
rank holds its own stage's parameters.  The schedule runs M + P − 1
ticks; each tick every pod applies its stage to the activation it holds,
then hands it to the next pod (a point-to-point send/recv over the
mesh's 'pod' group) — the paper's latency-insensitive FIFO channel
(C3/C5): buffering depth = 1 microbatch per hop, correctness independent
of added latency.  The other mesh axes run the same pipeline side by
side (each (data, model) coordinate has its own pod group).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.layers import tree_map


def _stage_params(stacked_params, mesh: DeviceMesh):
    """This pod's stage slice: each leaf a DTensor split over 'pod' on its
    leading axis and whole over the other mesh axes, whose local block
    [1, ...] is this pod's stage."""
    want = [Shard(0) if n == "pod" else Replicate()
            for n in mesh.mesh_dim_names]

    def one(a):
        if not isinstance(a, DTensor) or list(a.placements) != want:
            raise ValueError(f"a stage leaf must be a DTensor placed "
                             f"{want} (split over 'pod' on its leading "
                             f"axis)")
        return a.to_local()[0]
    return tree_map(one, stacked_params)


def _hop(y: torch.Tensor, stage: int, num_stages: int,
         group) -> torch.Tensor:
    """``y`` to the next stage and the previous stage's activation back;
    stage 0 receives nothing and holds zeros (``ppermute``'s fill)."""
    ops = []
    state = torch.zeros_like(y)
    if stage + 1 < num_stages:
        ops.append(dist.P2POp(dist.isend, y.contiguous(),
                              dist.get_global_rank(group, stage + 1), group))
    if stage > 0:
        ops.append(dist.P2POp(dist.irecv, state,
                              dist.get_global_rank(group, stage - 1), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return state


def gpipe_forward(stage_fn: Callable, stacked_params, x: torch.Tensor,
                  mesh: DeviceMesh, microbatches: int) -> torch.Tensor:
    """Run x through P pipeline stages (P = the mesh's 'pod' size).

    stage_fn(params_one_stage, x_mb) -> y_mb, applied by each pod to the
    microbatch currently resident on it.
    stacked_params: tree with leading axis P, DTensors split over 'pod'
    (JAX's P("pod")): each pod holds its own stage's slice.
    x: [B, ...] global batch (the same on every rank).  Returns y:
    [B, ...] after all P stages, on every rank.
    """
    num_stages = mesh.size(mesh.mesh_dim_names.index("pod"))
    stage = mesh.get_local_rank("pod")
    group = mesh.get_group("pod")
    M = microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"a batch of {B} rows is not a multiple of {M} "
                         f"microbatches")
    x_mb = x.reshape((M, B // M) + tuple(x.shape[1:]))
    p_one = _stage_params(stacked_params, mesh)
    state = torch.zeros_like(x_mb[0])           # current activation
    outs = torch.zeros_like(x_mb)               # last stage's results
    for t in range(M + num_stages - 1):
        # Stage 0 injects microbatch t (when one remains); others use
        # what arrived over the pipe.
        cur = x_mb[min(t, M - 1)] if stage == 0 else state
        # Valid window: stage s processes mb (t - s) for 0 <= t-s < M.
        mb_idx = t - stage
        valid = 0 <= mb_idx < M
        y = stage_fn(p_one, cur) if valid else state
        # Last stage writes its finished microbatch.
        if stage == num_stages - 1 and valid:
            outs[mb_idx] = y
        # Hand activation to the next stage (FIFO hop).
        state = _hop(y, stage, num_stages, group)
    # Only the last pod holds real outputs; the sum over 'pod' broadcasts
    # them (the other pods contribute zeros).
    if stage != num_stages - 1:
        outs = torch.zeros_like(outs)
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs.reshape((B,) + tuple(outs.shape[2:]))
