"""Sweep-barrier checkpoint/restore of a live execution.

A :class:`~repro_torch.exec.executor.ExecutionState` is a deterministic
state machine: firing counts, FIFO contents, memory-stream progress, and
the tokens still transiting the network fully determine the rest of the
run.  :func:`save_snapshot` captures exactly that every N sweeps (the
executor's ``checkpoint_every`` barrier) with the atomic-publish idiom —
write into ``step_<sweep>.tmp/``, ``os.rename`` to ``step_<sweep>/`` — so
a reader never observes a torn snapshot, and :func:`resume_execution`
continues a killed run from the last barrier: a kill now costs (sweeps
since the barrier) + network drain instead of a full re-run.

What is (and is not) in a snapshot:

* **in** — per-channel queued tokens with their absolute visibility
  sweeps; tokens still in the network are marked in-flight and simply
  **resubmitted** on restore (the transport's own flit/ARQ state is
  reconstructed by replaying the submission, never saved); memory-stream
  progress as the consumed count (unconsumed responses re-issue from the
  binding's tokens — deterministic by construction); firing counts, sink
  outputs, and the starvation/congestion tallies.
* **out** — programs and bindings (callables; the resume caller re-binds,
  and determinism of the binding is what makes the re-issue exact), and
  any transport/memsys internals.

Tensors are saved as CPU tensors with their dtype (``torch.save``), so
every dtype — bfloat16 included, which numpy lacks — round-trips bit for
bit.  On restore **every** tensor leaf (queued tokens and sink outputs)
goes back onto the state's device: the kernel wrappers refuse CPU
tensors, so a resumed card run must not hand them one.

Accounting across a restore: token counts and measured (Eq. 2) bytes
restore **cumulatively**, so ``comm_cost_match`` certifies the whole
logical run; network and memory byte counters restart at zero, so the
substrate conservation identities (goodput per link, per-bank bytes) hold
exactly over the resumed *segment* — each segment's books close on their
own, which is the stronger claim under faults.  The host-time tallies
(``net_model_s``, ``mem_model_s``) are the resumed segment's.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .channels import _Entry
from .executor import ExecutionResult, ExecutionState
from .programs import RoutedOutput

_STEP_RE = re.compile(r"^step_(\d+)$")
_PAYLOAD = "state.pt"


def _map_tensors(obj: Any, fn) -> Any:
    """Apply ``fn`` to every tensor leaf of a token (RoutedOutput is a dict
    *subclass* torch's pytree treats as a leaf, so it is descended by
    hand)."""
    if isinstance(obj, RoutedOutput):
        return RoutedOutput({k: _map_tensors(v, fn) for k, v in obj.items()})
    return pytree.tree_map(
        lambda leaf: fn(leaf) if isinstance(leaf, torch.Tensor) else leaf,
        obj)


def _to_host(obj: Any) -> Any:
    return _map_tensors(obj, lambda t: t.detach().to("cpu"))


def _place(obj: Any, device: torch.device) -> Any:
    return _map_tensors(obj, lambda t: t.to(device))


# -- write side --------------------------------------------------------------
def save_snapshot(state: ExecutionState, sweep: int, directory: str) -> str:
    """Snapshot ``state`` as of the end of ``sweep`` into
    ``directory/step_<sweep>/`` (atomic tmp-dir → rename; an existing
    published snapshot of the same sweep is kept — the content would be
    identical by determinism).  Returns the published path."""
    channels: List[Dict[str, Any]] = []
    for fc in state.channels:
        entries: List[Tuple[Optional[int], Any, int]] = []
        for e in fc._q:
            entries.append((e.vis, _to_host(e.token), e.nbytes))
        st = fc.stats
        channels.append({
            "entries": entries,
            "tokens": st.tokens, "measured_bytes": st.measured_bytes,
            "max_occupancy": st.max_occupancy,
            "blocked_pushes": st.blocked_pushes,
            "empty_pops": st.empty_pops,
        })
    mem = [{"consumed": mc.stats.consumed,
            "blocked_issues": mc.stats.blocked_issues,
            "max_outstanding": mc.stats.max_outstanding,
            "response_waits": mc.stats.response_waits}
           for mc in state.mem_channels]
    payload = {
        "format": "exec-snapshot/v1",
        "graph": state.graph.name,
        "iterations": state.iterations,
        "sweep": int(sweep),
        "fired": dict(state.fired),
        "sink_outputs": {t: [_to_host(o) for o in outs]
                         for t, outs in state.sink_outputs.items()},
        "channels": channels,
        "mem_channels": mem,
        "busy_s": dict(state.busy_s),
        "dev_fired": dict(state.dev_fired),
        "starve_events": dict(state.starve_events),
        "starve_detail": list(state.starve_detail),
        "congestion_waits": dict(state.congestion_waits),
        "mem_waits": dict(state.mem_waits),
    }
    final = os.path.join(directory, f"step_{sweep}")
    if os.path.isdir(final):
        return final
    tmp = final + ".tmp"
    if os.path.isdir(tmp):                 # leftovers of a crashed writer
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, _PAYLOAD))
    os.rename(tmp, final)                  # the atomic publish
    return final


# -- read side ---------------------------------------------------------------
def snapshot_steps(directory: str) -> List[int]:
    """Published snapshot sweeps, ascending (``.tmp`` leftovers ignored)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.isdir(os.path.join(directory, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_snapshot_step(directory: str) -> Optional[int]:
    steps = snapshot_steps(directory)
    return steps[-1] if steps else None


def load_snapshot(directory: str, step: int) -> Dict[str, Any]:
    """The payload of ``directory/step_<step>/``, tensors on the CPU.  It
    holds a :class:`RoutedOutput` where a sink returned one, so it is read
    as a full pickle, not with ``weights_only``: load only snapshots this
    package wrote."""
    path = os.path.join(directory, f"step_{step}", _PAYLOAD)
    return torch.load(path, map_location="cpu", weights_only=False)


def restore_state(state: ExecutionState, payload: Dict[str, Any]) -> None:
    """Load a snapshot into a freshly constructed ``ExecutionState``.

    The state must be built from the same design + binding the snapshot
    was taken from (same graph, same iteration count) — determinism of the
    binding is what makes the restored run's remaining firings produce the
    exact tokens the killed run would have.  Tokens that were in the
    network at the barrier are resubmitted to the (fresh) transport here;
    memory streams rewind to their consumed count and re-issue.  Every
    tensor goes back onto ``state.device``.
    """
    if payload.get("graph") != state.graph.name:
        raise ValueError(
            f"snapshot is of graph {payload.get('graph')!r}, "
            f"state runs {state.graph.name!r}")
    if payload.get("iterations") != state.iterations:
        raise ValueError(
            f"snapshot took {payload.get('iterations')} iterations, "
            f"binding has {state.iterations}")
    device = state.device
    sweep = payload["sweep"]
    state.fired = dict(payload["fired"])
    state.sink_outputs = {t: [_place(o, device) for o in outs]
                          for t, outs in payload["sink_outputs"].items()}
    state.busy_s = dict(payload["busy_s"])
    state.dev_fired = dict(payload["dev_fired"])
    state.starve_events = dict(payload["starve_events"])
    state.starve_detail = list(payload["starve_detail"])
    state.congestion_waits = dict(payload["congestion_waits"])
    state.mem_waits = dict(payload["mem_waits"])
    state.sweeps_done = sweep + 1
    for fc, snap in zip(state.channels, payload["channels"]):
        fc._q.clear()
        fc._pending.clear()
        st = fc.stats
        st.tokens = snap["tokens"]
        st.measured_bytes = snap["measured_bytes"]
        st.max_occupancy = snap["max_occupancy"]
        st.blocked_pushes = snap["blocked_pushes"]
        st.empty_pops = snap["empty_pops"]
        st.net_bytes = st.net_delivered_bytes = 0   # segment-fresh books
        for vis, token, nbytes in snap["entries"]:
            token = _place(token, device)
            if vis is None:
                # Still in the network at the barrier: resubmit — the
                # transport rebuilds its flit/ARQ state by replaying.
                mid = fc.transport.submit(fc.index, fc.net_src_dev,
                                          fc.net_dst_dev, nbytes, sweep)
                st.net_bytes += nbytes
                entry = _Entry(None, token, mid, nbytes)
                fc._pending[mid] = entry
            else:
                entry = _Entry(vis, token, None, nbytes)
            fc._q.append(entry)
    for mc, snap in zip(state.mem_channels, payload["mem_channels"]):
        # Rewind to the consumed prefix; everything issued-but-unconsumed
        # re-issues from the binding's tokens on the next pump.
        mc._window.clear()
        mc._by_rid.clear()
        ms = mc.stats
        ms.issued = ms.consumed = snap["consumed"]
        ms.requested_bytes = ms.delivered_bytes = 0  # segment-fresh books
        ms.blocked_issues = snap["blocked_issues"]
        ms.max_outstanding = snap["max_outstanding"]
        ms.response_waits = snap["response_waits"]


def resume_execution(design, directory: str, *,
                     step: Optional[int] = None,
                     binding=None,
                     inputs=None,
                     injector=None,
                     checkpoint_every: Optional[int] = None,
                     **state_kwargs) -> ExecutionResult:
    """Continue a checkpointed run from its last (or a chosen) barrier.

    Builds a fresh :class:`ExecutionState` for ``design`` (``binding`` /
    ``inputs`` / ``state_kwargs`` — ``device`` among them — exactly as
    the killed run was built), loads the snapshot, and drives it to
    completion — resuming at ``snapshot sweep + 1``.  With
    ``checkpoint_every`` the resumed run keeps checkpointing into the same
    directory.
    """
    if step is None:
        step = latest_snapshot_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no published snapshot under {directory!r}")
    payload = load_snapshot(directory, step)
    state = ExecutionState(design, binding, inputs=inputs, **state_kwargs)
    restore_state(state, payload)
    return state.run(injector=injector, start_sweep=payload["sweep"] + 1,
                     checkpoint_dir=directory if checkpoint_every else None,
                     checkpoint_every=checkpoint_every)
