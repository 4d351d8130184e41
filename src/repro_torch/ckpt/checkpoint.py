"""Atomic, async checkpointing of a tree of torch tensors.

Layout:  <dir>/step_<N>.tmp/ → leaf files `<idx>.npy` + manifest.json,
atomically renamed to step_<N>/ when complete (a crash mid-write never
corrupts the latest checkpoint — the restart loop only sees published dirs).

The JAX package's format on torch tensors: leaves are named by their key
path as JAX's ``keystr`` writes it (``['params']['blocks'][0]['attn']
['wq_dhk']``; a ``ParamTree`` is walked as the nested dicts of its names,
``models.layers.tree_paths``), each leaf is one ``.npy`` file (bf16
viewed as uint16, as npy has no bf16) and the manifest records each
leaf's file, shape and dtype.  JAX restores onto a mesh's shardings; the port restores onto the
devices and dtypes of the ``like`` tree's tensors.

A tree of DTensors (a mesh's train state) is saved whole: every rank
gathers each leaf (``full_tensor``, a collective), rank 0 writes and
publishes, and every rank waits for the publish (a barrier), so a save
blocks.  It is restored with ``distribute_tensor`` onto each ``like``
leaf's placements.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.layers import tree_paths

def _flatten(tree) -> Dict[str, torch.Tensor]:
    return dict(tree_paths(tree))


def _distributed(flat: Dict[str, torch.Tensor]) -> bool:
    return any(isinstance(v, DTensor) for v in flat.values())


def _writer() -> bool:
    """Whether this process writes: rank 0, or a process with no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` (bf16 as its uint16 bit patterns); a DTensor
    whole."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree, *,
                    blocking: bool = True,
                    overwrite: bool = False) -> threading.Thread:
    """Write tree to directory/step_<step>; returns writer thread.

    A *published* ``step_<N>/`` is immutable by default: saving onto one
    raises :class:`FileExistsError` unless ``overwrite=True`` — silently
    clobbering the checkpoint a restart would restore from is exactly the
    failure mode the atomic-rename layout exists to prevent.  (Leftover
    ``.tmp`` dirs from a crashed writer are fair game either way.)
    """
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    flat = _flatten(tree)
    sharded = _distributed(flat)
    if sharded and not _writer():
        for v in flat.values():
            _host_array(v)             # this rank's part of each gather
        dist.barrier()                 # rank 0 has published
        return _done_thread()
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(final) and not overwrite:
        raise FileExistsError(
            f"checkpoint step_{step} already published in {directory!r}; "
            "pass overwrite=True to replace it")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    # The device→host copies happen on the caller's thread (so a later
    # in-place update cannot race them); serialization runs in the
    # background writer.
    host_flat = {k: (str(v.dtype).replace("torch.", ""), _host_array(v))
                 for k, v in flat.items()}

    def _write():
        manifest = {}
        for i, (key, (dtype, arr)) in enumerate(sorted(host_flat.items())):
            fname = f"{i}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    t = threading.Thread(target=_write, daemon=True)
    t.start()
    if blocking or sharded:
        t.join()
    if sharded:
        dist.barrier()
    return t


def _done_thread() -> threading.Thread:
    t = threading.Thread(target=lambda: None, daemon=True)
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


@torch.no_grad()
def load_checkpoint(directory: str, like_tree, step: Optional[int] = None):
    """Restore the checkpoint of ``step`` (default: the latest) into the
    tensors of ``like_tree``, in place, each on its own device and in its
    own dtype.  Returns ``(like_tree, step)``.  In place, so that restoring
    a large state needs no second copy of it on the device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    for key, like in tree_paths(like_tree):
        meta = manifest[key]
        arr = np.load(os.path.join(path, meta["file"]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key} has shape "
                             f"{tuple(arr.shape)}, the tree's "
                             f"{tuple(like.shape)}")
        t = torch.from_numpy(arr)
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.int16).view(torch.bfloat16)
        else:
            t = t.to(getattr(torch, meta["dtype"]))
        if isinstance(like, DTensor):
            t = distribute_tensor(t.to(device=like.device, dtype=like.dtype),
                                  like.device_mesh, like.placements)
        like.copy_(t)
    return like_tree, step


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; async writes; restart discovery."""

    def __init__(self, directory: str, keep: int = 3,
                 save_interval: int = 100):
        self.directory = directory
        self.keep = keep
        self.save_interval = save_interval
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def save(self, step: int, tree, blocking: bool = False):
        if self._pending is not None:
            self._pending.join()
        # The manager owns its directory, and a restarted trainer may
        # legitimately re-save the step it just restored (same state by
        # construction) — managed saves replace in place.
        self._pending = save_checkpoint(self.directory, step, tree,
                                        blocking=blocking, overwrite=True)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore(self, like_tree):
        return load_checkpoint(self.directory, like_tree)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self):
        if not _writer():
            return
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
