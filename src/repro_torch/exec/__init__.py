"""repro_torch.exec — the dataflow executor (paper §4.6 + §5) in PyTorch.

The compiler (:mod:`repro_torch.compiler`) plans a design; this package
*runs* it.  ``execute(design)`` turns a
:class:`~repro_torch.compiler.CompiledDesign` into a synchronous-dataflow
program: every task becomes a torch body bound by the app's
``bind_programs`` hook (which launches the app's CUDA kernel), every graph
channel becomes a bounded FIFO whose capacity is the §4.6 balanced depth
and whose latency is the inserted pipeline registers, and inter-device
channels are accounted byte for byte, double-buffered when depth ≥ 2.

    from repro_torch.compiler import CompileOptions, compile
    from repro_torch.exec import execute

    design = compile(graph, cluster, CompileOptions(balance_kind="LUT"))
    result = execute(design)              # on cuda; device="cpu" to test
    result.outputs                        # numerics == single-device ref
    result.report.agreement()             # measured vs Eq. 2 accounting

Every logical device maps onto the one torch device; logical placement
keeps driving the traffic accounting.  ``execute(..., checkpoint_dir=,
checkpoint_every=)`` snapshots the run at sweep barriers and
:func:`resume_execution` continues a killed one (``python -m
repro_torch.exec.smoke`` drives one app end to end).
"""
from .channels import ChannelStats, FifoChannel, bit_identical, token_bytes
from .executor import (DeadlockError, ExecutionResult, ExecutionState,
                       StarvationError, execute)
from .programs import (BINDER_REGISTRY, ProgramBinding, RoutedOutput,
                       SOURCE_KEY, bind_programs, register_binder,
                       resolve_device)
from .report import ChannelTrace, ExecutionReport, MemChannelTrace
from .snapshot import (latest_snapshot_step, load_snapshot, restore_state,
                       resume_execution, save_snapshot, snapshot_steps)

__all__ = [
    "BINDER_REGISTRY", "ChannelStats", "ChannelTrace", "DeadlockError",
    "ExecutionReport", "ExecutionResult", "ExecutionState", "FifoChannel",
    "MemChannelTrace", "ProgramBinding", "RoutedOutput", "SOURCE_KEY",
    "StarvationError", "bind_programs", "bit_identical", "execute",
    "latest_snapshot_step", "load_snapshot", "register_binder",
    "resolve_device", "restore_state", "resume_execution", "save_snapshot",
    "snapshot_steps", "token_bytes",
]
