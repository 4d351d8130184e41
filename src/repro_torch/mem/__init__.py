"""repro_torch.mem — the HBM bank model (the "HBM" in distributed HBM-FPGAs).

A copy of the JAX package's ``mem`` layer.  The model is plain Python on
the host: it decides *when* each memory response reaches its task, while
the payloads (torch tensors on the run's device) stay where the program
binding put them.

* :mod:`~repro_torch.mem.banks` models each device's HBM as independent
  pseudo-channels: per-bank bandwidth budgets per sweep, fair burst
  arbitration across the memory channels mapped to one bank, exact byte
  accounting (Σ bank bytes == Σ channel bytes once drained);
* :mod:`~repro_torch.mem.channels` exposes banks to tasks as
  :class:`AsyncMemChannel` — requests pumped ahead of consumption up to a
  credit bound, responses consumed in issue order out of a bounded reorder
  window (``issue_read_addr`` / ``receive_read_resp``);
* :mod:`~repro_torch.mem.contention` tracks per-bank utilization into a
  :class:`MemContentionReport` (measured from a
  :class:`~repro_torch.mem.banks.MemorySystem`, or projected analytically
  from ``Task.hbm_bytes`` + a partition assignment and task→bank map);
* :mod:`~repro_torch.mem.calibrate` feeds the projection back into the
  compiler: the registered ``memory_feedback`` pass re-maps task→bank
  assignments (LPT) and, failing that, repartitions with bank bandwidth as
  an Eq. 1 capacity — tagging ``method: "...-membound"``.

Quickstart (compile with banks → execute → per-bank report)::

    from repro_torch.compiler import CompileOptions, compile
    from repro_torch.mem import MemConfig

    design = compile(graph, cluster,
                     CompileOptions(balance_kind="LUT", mem=MemConfig()))
    result = design.execute()            # reads now contend for banks
    result.report.mem_contention.summary()   # measured per-bank usage
    design.mem_contention.summary()          # projected (compiler side)

``python -m repro_torch.mem.smoke`` runs one memory-bound app through the
bank model and the ideal path and checks bit identity and conservation.
"""
from .banks import SWEEP_TIME_S, BankCounters, MemConfig, MemorySystem
from .calibrate import (MEM_KIND, membound_pair_partition,
                        memory_feedback_pass, rebalance_bank_map)
from .channels import AsyncMemChannel, MemChannelStats
from .contention import (BankUsage, MemContentionReport, default_bank_map,
                         measure, project)

__all__ = [
    "AsyncMemChannel", "BankCounters", "BankUsage", "MEM_KIND",
    "MemChannelStats", "MemConfig", "MemContentionReport", "MemorySystem",
    "SWEEP_TIME_S", "default_bank_map", "measure", "membound_pair_partition",
    "memory_feedback_pass", "project", "rebalance_bank_map",
]
