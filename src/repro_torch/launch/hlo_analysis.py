"""Dry-run analysis for the roofline: collective-byte inventory, plus cost
and memory extraction — the JAX package's ``hlo_analysis`` for an eager
step.

JAX reads these from the compiled HLO.  The port runs the step once on
fake tensors (``steps.lower_*``; nothing is allocated) and reads what it
dispatched:

  * FLOPs from ``FlopCounterMode`` (matmuls, convolutions, attention);
  * bytes accessed as each dispatched op's tensor inputs and outputs
    (an unfused eager step: every op reads and writes memory);
  * collectives from :class:`CollectiveRecorder`, each c10d op with its
    kind, dtype, result shape and process group's ranks, so a group that
    mixes pods is classified as crossing the slow (DCN) links as JAX's
    ``_is_dcn`` does from ``replica_groups``;
  * memory from ``MemTracker``: the arguments' local bytes, the outputs',
    and the peak of all live tensors during the step.

An eager step unrolls every loop (layers, microbatches, loss chunks), so
each collective is recorded once per execution and its ``trip_mult`` is
1.  Keys of the JAX record that the port does not fill:
``cpu_bf16_convert_bytes``, ``tpu_adjusted_peak_bytes`` and the
``_tpu_adj`` collective byte fields.  They correct for XLA's CPU backend
widening bf16 dots to f32, which an eager step on fake tensors does not
do: its payloads are already the dtypes the card would move.
``collective_bytes`` is the JAX function as it is (so it also sums the
``_tpu_adj`` fields, which stay equal to the raw ones here).

The plain attention the CPU runs materializes its [B,H,Sq,Sk] scores,
which the card's flash kernel never does: the peak and the bytes
accessed count them.  On the dry run's CPU mesh DTensor turns an
all-to-all (a Shard-to-Shard redistribution, Adafactor's) into an
all-gather and a local chunk, and records it so.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
               "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1, "c64": 8, "c128": 16}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: torch dtype → the HLO name JAX's records use.
_HLO_DTYPE = {torch.float64: "f64", torch.float32: "f32",
              torch.bfloat16: "bf16", torch.float16: "f16",
              torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
              torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}

#: Functional collective → (kind, result size / operand size as a
#: function of the group size).  A step's collectives are these (DTensor's
#: redistributions and ``shardctx.batch_sum``); any other collective
#: fails the recording.
_C10D = {
    "all_gather_into_tensor": ("all-gather", lambda g: g),
    "reduce_scatter_tensor": ("reduce-scatter", lambda g: 1.0 / g),
    "all_reduce": ("all-reduce", lambda g: 1),
    "all_to_all_single": ("all-to-all", lambda g: 1),
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: Tuple[int, ...]
    bytes_per_exec: float
    while_depth: int
    trip_mult: float
    is_dcn: bool
    line: str


def _is_dcn(ranks: Sequence[int], chips_per_pod: int) -> bool:
    """A collective crosses the pod (DCN) boundary iff its group mixes
    ranks of different pods (JAX's rule for an explicit replica group)."""
    return len({r // chips_per_pod for r in ranks}) > 1


@dataclasses.dataclass
class CollectiveRecord:
    """One dispatched c10d op: its kind, result dtype and shape (JAX's
    HLO records carry the result type), and its group's ranks."""
    op: str
    kind: str
    dtype: torch.dtype
    shape: Tuple[int, ...]
    ranks: Tuple[int, ...]


def _group_ranks(args, kwargs) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in list(args) + list(kwargs.values())
             if isinstance(a, str)]
    for name in reversed(names):
        try:
            pg = _resolve_process_group(name)
        except (ValueError, RuntimeError, KeyError):
            continue
        return tuple(dist.get_process_group_ranks(pg))
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dist.ProcessGroup):
            return tuple(dist.get_process_group_ranks(a))
    raise ValueError("a collective with no process group")


class CollectiveRecorder(TorchDispatchMode):
    """Records each collective the step dispatches, and the bytes every
    other op reads and writes (its tensor inputs and outputs)."""

    def __init__(self):
        super().__init__()
        self.records: List[CollectiveRecord] = []
        self.bytes_accessed = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.namespace in ("_c10d_functional", "c10d",
                              "_c10d_functional_autograd"):
            if name == "wait_tensor":
                return out
            if name not in _C10D:
                raise ValueError(f"the recorder does not know the "
                                 f"collective {func}")
            kind, ratio = _C10D[name]
            t = args[0]
            ranks = _group_ranks(args, kwargs)
            shape = list(t.shape)
            if shape:
                shape[0] = int(shape[0] * ratio(len(ranks)))
            self.records.append(CollectiveRecord(
                name, kind, t.dtype, tuple(shape), ranks))
            return out
        if func.namespace == "aten" and not func.is_view:
            leaves = tree_flatten((args, kwargs, out))[0]
            self.bytes_accessed += sum(
                float(t.numel() * t.element_size()) for t in leaves
                if isinstance(t, torch.Tensor))
        return out


def _shape_bytes(dtype: str, dims: Sequence[int]) -> float:
    n = 1
    for d in dims:
        n *= d
    return n * DTYPE_BYTES.get(dtype, 4)


def parse_collectives(records: Sequence[CollectiveRecord], *,
                      chips_per_pod: int = 256) -> List[CollectiveOp]:
    """Inventory of the recorded collectives (``trip_mult`` 1: an eager
    step dispatches each execution)."""
    out: List[CollectiveOp] = []
    for r in records:
        dtype = _HLO_DTYPE.get(r.dtype, "f32")
        out.append(CollectiveOp(
            kind=r.kind, dtype=dtype, shape=tuple(r.shape),
            bytes_per_exec=_shape_bytes(dtype, r.shape), while_depth=0,
            trip_mult=1.0, is_dcn=_is_dcn(r.ranks, chips_per_pod),
            line=f"{dtype}{list(r.shape)} over {len(r.ranks)} ranks "
                 f"{list(r.ranks[:4])}{'...' if len(r.ranks) > 4 else ''}"))
    return out


def collective_bytes(ops: List[CollectiveOp]) -> Dict[str, float]:
    """Aggregate per-chip wire bytes: {ici, dcn, raw, by_kind...}.

    all-gather/reduce-scatter move (g-1)/g of the buffer per chip; ring
    all-reduce ≈ 2× that; permute moves the buffer once.  We use the
    operand-size convention from the assignment (sum operand sizes), with
    the multiplier applied.
    """
    agg = {"ici": 0.0, "dcn": 0.0, "raw_once": 0.0,
           "ici_tpu_adj": 0.0, "dcn_tpu_adj": 0.0}
    by_kind: Dict[str, float] = {}
    for op in ops:
        b = op.bytes_per_exec * op.trip_mult
        agg["raw_once"] += op.bytes_per_exec
        key = "dcn" if op.is_dcn else "ici"
        factor = 2.0 if op.kind == "all-reduce" else 1.0
        agg[key] += b * factor
        # TPU adjustment: f32 collectives adjacent to dots/gathers exist in
        # f32 only because the CPU backend upcasts bf16 matmuls — on TPU
        # the payload would be bf16 (half the bytes).
        adj = 0.5 if (op.dtype == "f32"
                      and ("dot_general" in op.line or "_take" in op.line
                           or "gather" in op.line)) else 1.0
        agg[key + "_tpu_adj"] += b * factor * adj
        by_kind[op.kind] = by_kind.get(op.kind, 0.0) + b
    agg["by_kind"] = by_kind
    return agg


@dataclasses.dataclass
class Compiled:
    """What one traced run of a lowered step measured."""
    flops: float
    flops_by_op: Dict[str, float]
    bytes_accessed: float
    collectives: List[CollectiveRecord]
    memory: Dict[str, float]
    run_s: float


def _local_bytes(tree) -> float:
    """The bytes of the tensors in ``tree`` (a DTensor by its local
    block), each counted once."""
    from torch.distributed.tensor import DTensor
    seen = {}
    for t in _tensor_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        seen[id(t)] = float(t.numel() * t.element_size())
    return sum(seen.values())


def run_traced(fn, args: tuple, fake_mode) -> Compiled:
    """Run ``fn(*args)`` once inside ``fake_mode`` under the FLOP counter,
    the collective recorder and the memory tracker."""
    import time

    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    arg_bytes = _local_bytes(args)
    rec = CollectiveRecorder()
    flops = FlopCounterMode(display=False)
    mem = MemTracker()
    t0 = time.perf_counter()
    with fake_mode:
        with flops, mem, rec:
            mem.track_external(*_tensor_leaves(args))
            out = fn(*args)
    run_s = time.perf_counter() - t0
    peak = 0.0
    for dev, stats in mem.get_tracker_snapshot("peak").items():
        peak = max(peak, float(stats.get("Total", 0.0)))
    out_bytes = _local_bytes(out)
    counts = flops.get_flop_counts().get("Global", {})
    return Compiled(
        flops=float(flops.get_total_flops()),
        flops_by_op={str(k): float(v) for k, v in counts.items()},
        bytes_accessed=rec.bytes_accessed, collectives=rec.records,
        memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                "peak_bytes": peak,
                "temp_bytes": max(0.0, peak - arg_bytes)},
        run_s=run_s)


def _tensor_leaves(tree) -> list:
    from ..models.layers import ParamTree
    if isinstance(tree, ParamTree):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensor_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return []


def cost_summary(compiled: Compiled) -> Dict[str, float]:
    return {"flops": compiled.flops,
            "bytes_accessed": compiled.bytes_accessed,
            "flops_by_op": dict(compiled.flops_by_op)}


def memory_summary(compiled: Compiled) -> Dict[str, float]:
    return dict(compiled.memory)
