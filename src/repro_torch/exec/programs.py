"""Task → program bindings: what each task graph vertex *computes*.

The compiler decides *where* tasks run; a :class:`ProgramBinding` says
*what* they run.  Each of the paper's four app modules implements a
``bind_programs(graph, spec=None)`` hook that maps every task of the graph
it built to an executable torch body (each task body calls the app's
``repro_torch.kernels`` op, which launches the hand-written CUDA kernel on
a CUDA tensor) and supplies the input streams, back-edge seed tokens, and
the single-device reference the executor's numerics are checked against.

Program calling convention
--------------------------
``fn(inputs: Dict[str, Any]) -> Any | Dict[str, Any]``

* ``inputs`` maps each predecessor task name to the token popped from that
  channel; source tasks additionally receive the current stream item under
  ``SOURCE_KEY``.  Tasks with ``mem_reads`` streams receive each consumed
  memory response under its stream name (``async_mmap`` reads).
* Returning a plain value (dicts included — a dict is just a pytree token)
  broadcasts it onto every outgoing channel; returning a
  :class:`RoutedOutput` keyed by successor names routes a distinct token
  per channel (the PageRank router shards its edge stream this way).

Dispatch: :func:`bind_programs` first consults the explicit registry
(:func:`register_binder`, for custom graphs such as the deadlock-regression
fixtures), then falls back to the app module whose name prefixes
``graph.name`` (``stencil-256x4`` → ``repro_torch.apps.stencil``).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Union)

import torch

from ..core.graph import TaskGraph

# Key under which a source task's current stream item appears in `inputs`.
SOURCE_KEY = "__input__"


class RoutedOutput(dict):
    """Marker: a program output carrying one distinct token per successor.

    A plain dict return is an ordinary pytree token broadcast to every
    out-channel; wrapping it in RoutedOutput makes the executor deliver
    ``out[successor_name]`` on each channel instead.
    """

ProgramFn = Callable[[Dict[str, Any]], Any]
BinderFn = Callable[..., "ProgramBinding"]

BINDER_REGISTRY: Dict[str, BinderFn] = {}


def register_binder(prefix: str) -> Callable[[BinderFn], BinderFn]:
    """Register a binder for graphs whose name starts with ``prefix``."""
    def deco(fn: BinderFn) -> BinderFn:
        if prefix in BINDER_REGISTRY:
            raise ValueError(f"binder {prefix!r} already registered")
        BINDER_REGISTRY[prefix] = fn
        return fn
    return deco


@dataclasses.dataclass
class ProgramBinding:
    """Everything the executor needs beyond the CompiledDesign.

    ``iterations`` is the steady-state firing count per task (T input items
    streamed through the pipeline, or T convergence sweeps for iterative
    graphs).  ``source_inputs`` holds per-firing stream items for tasks with
    no in-channels.  ``prime`` seeds back-edge channels, keyed by channel
    index in ``graph.channels`` (the dependency cycle's initial tokens —
    PageRank's rank vector).  ``finalize`` folds the per-firing outputs of
    the sink tasks into the value compared against ``reference()``.

    ``mem_reads`` declares the ``async_mmap``-style memory streams:
    ``task → stream name → per-firing payload tokens``.  The executor turns
    each stream into an ``AsyncMemChannel`` (the JAX package's mem layer)
    bound to the task's device and bank; the program receives firing *i*'s
    token under the stream name.  The payloads live here — the bank model only
    schedules *when* each response arrives — so bank-modeled and ideal
    executions are bit-identical by construction.
    """

    graph: TaskGraph
    programs: Mapping[str, ProgramFn]
    iterations: int
    source_inputs: Mapping[str, Sequence[Any]] = dataclasses.field(
        default_factory=dict)
    mem_reads: Mapping[str, Mapping[str, Sequence[Any]]] = dataclasses.field(
        default_factory=dict)
    prime: Mapping[int, Any] = dataclasses.field(default_factory=dict)
    finalize: Optional[Callable[[Dict[str, List[Any]]], Any]] = None
    reference: Optional[Callable[[], Any]] = None
    atol: float = 1e-5

    def validate(self) -> None:
        missing = [t for t in self.graph.tasks if t not in self.programs]
        if missing:
            raise ValueError(f"no program bound for task(s) {missing}")
        nch = len(self.graph.channels)
        bad = [i for i in self.prime if not (0 <= i < nch)]
        if bad:
            raise ValueError(f"prime refers to unknown channel(s) {bad}")
        for t, stream in self.source_inputs.items():
            if len(stream) < self.iterations:
                raise ValueError(
                    f"source {t!r}: {len(stream)} stream items < "
                    f"{self.iterations} iterations")
        fed = {ch.dst for ch in self.graph.channels}
        starved = [t for t in self.graph.tasks
                   if t not in fed and t not in self.source_inputs
                   and t not in self.mem_reads]
        if starved:
            raise ValueError(
                f"task(s) {starved} have no in-channels, no source_inputs "
                "stream, and no mem_reads stream — nothing feeds them")
        for t, streams in self.mem_reads.items():
            if t not in self.graph.tasks:
                raise ValueError(f"mem_reads for unknown task {t!r}")
            preds = {ch.src for ch in self.graph.channels if ch.dst == t}
            for name, tokens in streams.items():
                if name in preds or name == SOURCE_KEY:
                    raise ValueError(
                        f"memory stream {t}.{name} shadows an input key "
                        f"(predecessors: {sorted(preds)})")
                if len(tokens) < self.iterations:
                    raise ValueError(
                        f"memory stream {t}.{name}: {len(tokens)} tokens < "
                        f"{self.iterations} iterations")


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The one device a run uses: ``cuda`` unless the caller names another.

    There is no silent CPU: without a card, ``device=None`` raises.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the kernels' plain versions")
        device = "cuda"
    return torch.device(device)


def bind_programs(graph: TaskGraph, spec: Optional[Mapping[str, Any]] = None,
                  *, device: Union[None, str, torch.device] = None
                  ) -> ProgramBinding:
    """Resolve the binding for ``graph`` — registry first, app hook second.

    ``spec`` is forwarded to the binder: the reduced numeric configuration
    (shapes, iteration counts, seeds) overriding its CI-scale defaults.
    ``device`` is where the binder places its tensors (see
    :func:`resolve_device`); a binder is called as
    ``binder(graph, spec, device=device)``.
    """
    device = resolve_device(device)
    for prefix, binder in BINDER_REGISTRY.items():
        if graph.name.startswith(prefix):
            binding = binder(graph, spec, device=device)
            binding.validate()
            return binding
    from .. import apps   # deferred: apps import the kernel wrappers
    kind = graph.name.split("-", 1)[0]
    mod = apps.APPS.get(kind)
    if mod is None or not hasattr(mod, "bind_programs"):
        raise KeyError(
            f"no program binding for graph {graph.name!r}: register one "
            f"with repro_torch.exec.register_binder, or name the graph after "
            f"an app module with a bind_programs hook ({sorted(apps.APPS)})")
    binding = mod.bind_programs(graph, spec, device=device)
    binding.validate()
    return binding
