"""Host-sharded token pipeline with background prefetch.

A copy of the JAX package's ``data/pipeline.py`` (numpy only, so the same
seed gives the same batches bit for bit); ``synthetic_batch_specs`` gives
the dry run's stand-ins for one global batch as meta tensors.

Production posture: each host produces only its slice of the global batch
(``host_index``/``num_hosts``), batches are assembled as dicts of numpy
arrays matching the model's inputs, and a double-buffered prefetch
thread hides host-side latency behind the device step.  Sources:
synthetic LM stream (seeded, reproducible) or a memory-mapped token file.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    host_index: int = 0
    num_hosts: int = 1
    seed: int = 0
    token_file: Optional[str] = None
    frontend_tokens: int = 0      # vision patches prepended
    d_model: int = 0              # frontend embedding width
    enc_len: int = 0              # enc-dec source length (audio frames)
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def _synthetic_stream(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed + 7919 * cfg.host_index)
    text_len = cfg.seq_len - cfg.frontend_tokens
    while True:
        toks = rng.integers(0, cfg.vocab, (cfg.host_batch, text_len + 1),
                            dtype=np.int32)
        batch = {
            "tokens": toks[:, :-1],
            "targets": np.concatenate(
                [np.zeros((cfg.host_batch, cfg.frontend_tokens), np.int32),
                 toks[:, 1:]], axis=1),
            "weights": np.concatenate(
                [np.zeros((cfg.host_batch, cfg.frontend_tokens), np.float32),
                 np.ones((cfg.host_batch, text_len), np.float32)], axis=1),
        }
        if cfg.frontend_tokens:
            batch["frontend"] = rng.standard_normal(
                (cfg.host_batch, cfg.frontend_tokens, cfg.d_model)
            ).astype(np.float32)
        if cfg.enc_len:
            batch["src"] = rng.standard_normal(
                (cfg.host_batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
        yield batch


def _file_stream(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Memory-mapped flat int32 token file, strided by host."""
    data = np.memmap(cfg.token_file, dtype=np.int32, mode="r")
    span = cfg.seq_len + 1
    n_seq = len(data) // span
    idx = cfg.host_index
    while True:
        rows = []
        for _ in range(cfg.host_batch):
            start = (idx % n_seq) * span
            rows.append(np.asarray(data[start:start + span]))
            idx += cfg.num_hosts
        toks = np.stack(rows)
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:],
               "weights": np.ones((cfg.host_batch, cfg.seq_len), np.float32)}


class Pipeline:
    """Background-thread prefetching iterator."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        src = _file_stream(cfg) if cfg.token_file else _synthetic_stream(cfg)
        self._src = src
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._src:
                if self._stop.is_set():
                    return
                self._q.put(batch)
        except Exception as e:  # pragma: no cover
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass


def make_pipeline(cfg: DataConfig) -> Pipeline:
    return Pipeline(cfg)


def synthetic_batch_specs(cfg: DataConfig):
    """Meta tensors for one *global* batch (dry-run input), the JAX
    package's shapes and dtypes."""
    import torch

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    B = cfg.global_batch
    specs = {
        "tokens": meta((B, cfg.seq_len - cfg.frontend_tokens), torch.int32),
        "targets": meta((B, cfg.seq_len), torch.int32),
        "weights": meta((B, cfg.seq_len), torch.float32),
    }
    if cfg.frontend_tokens:
        specs["frontend"] = meta((B, cfg.frontend_tokens, cfg.d_model),
                                 torch.float32)
    if cfg.enc_len:
        specs["src"] = meta((B, cfg.enc_len, cfg.d_model), torch.float32)
    return specs
