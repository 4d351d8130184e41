"""TAPA-CS core: task-graph partitioning/floorplanning/pipelining (C1-C5).

The free functions ``partition`` / ``floorplan_device`` /
``pipeline_interconnect`` exported here are deprecated shims around the
real implementations — new code should drive the whole flow through
``repro.compiler.compile()`` (one entry point, composable passes).
"""
import functools
import warnings

from .graph import Channel, ResourceProfile, Task, TaskGraph, linear_graph
from .topology import (ALVEO_U55C, ETHERNET_100G, INTER_NODE_10G, PCIE_GEN3X16,
                       TPU_DCN, TPU_ICI, TPU_V5E, Bus, Cluster, DaisyChain,
                       DeviceSpec, Hypercube, Mesh2D, Protocol, Ring, Star,
                       Topology, fpga_ring_cluster, lam, tpu_pod_cluster)
from .partitioner import Partition
from .partitioner import partition as _partition_impl
from .floorplan import Floorplan, SlotGrid, TPU_POD_GRID, U55C_GRID
from .floorplan import floorplan_device as _floorplan_device_impl
from .pipelining import PipelineReport, verify_balanced
from .pipelining import pipeline_interconnect as _pipeline_interconnect_impl
from .costmodel import (FreqModel, RooflineTerms, ScheduleResult, roofline,
                        simulate, task_time, transfer_time,
                        TPU_PEAK_FLOPS, TPU_HBM_BW, TPU_ICI_BW, TPU_DCN_BW)
from .scaleup import ScalePlan, graph_intensity, lm_pod_strategy, plan_scaleup
from .ilp import ILPError, Model, SolveStats


def _deprecated_entry(fn, name):
    """Wrap a legacy free-function entry point with a DeprecationWarning.

    The compiler passes call the underlying module functions directly, so
    only code still hand-wiring the chain sees the warning.
    """
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        warnings.warn(
            f"repro.core.{name}() is deprecated as a standalone entry "
            "point; drive the flow through repro.compiler.compile() "
            "(see the repro.compiler docstring for the pass pipeline)",
            DeprecationWarning, stacklevel=2)
        return fn(*args, **kwargs)
    return wrapper


partition = _deprecated_entry(_partition_impl, "partition")
floorplan_device = _deprecated_entry(_floorplan_device_impl,
                                     "floorplan_device")
pipeline_interconnect = _deprecated_entry(_pipeline_interconnect_impl,
                                          "pipeline_interconnect")

__all__ = [
    "Channel", "ResourceProfile", "Task", "TaskGraph", "linear_graph",
    "Bus", "Cluster", "DaisyChain", "DeviceSpec", "Hypercube", "Mesh2D",
    "Protocol", "Ring", "Star", "Topology", "lam",
    "ALVEO_U55C", "TPU_V5E", "ETHERNET_100G", "PCIE_GEN3X16",
    "INTER_NODE_10G", "TPU_ICI", "TPU_DCN",
    "fpga_ring_cluster", "tpu_pod_cluster",
    "Partition", "partition",
    "Floorplan", "SlotGrid", "U55C_GRID", "TPU_POD_GRID", "floorplan_device",
    "PipelineReport", "pipeline_interconnect", "verify_balanced",
    "FreqModel", "RooflineTerms", "ScheduleResult", "roofline", "simulate",
    "task_time", "transfer_time",
    "TPU_PEAK_FLOPS", "TPU_HBM_BW", "TPU_ICI_BW", "TPU_DCN_BW",
    "ScalePlan", "graph_intensity", "lm_pod_strategy", "plan_scaleup",
    "ILPError", "Model", "SolveStats",
]
