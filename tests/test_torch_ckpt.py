"""The port's checkpoints (``repro_torch.ckpt``) and data pipeline
(``repro_torch.data``) on the CPU: the port's cases of
``tests/test_substrate.py``'s checkpoint tests (roundtrip with a bf16
leaf, gc and latest, the ignored ``.tmp``, a published step immutable
without ``overwrite``, a crash mid-write), the key paths and the manifest
of a parameter tree, and the pipeline's batches bit for bit against the
JAX package's (text, vision, enc-dec, host-sharded, a token file).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import make_pipeline as j_make_pipeline
from repro.data.pipeline import _file_stream as j_file_stream
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              load_checkpoint, save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.data.pipeline import _file_stream
from repro_torch.models import init_params
from repro_torch.models.layers import tree_leaves, tree_map, tree_paths


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


# -- checkpoints ----------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16) * 1.5},
            "step": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 7, tree)
    got, step = load_checkpoint(str(tmp_path), _zeros_like(tree))
    assert step == 7
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    manifest = json.load(open(tmp_path / "step_7" / "manifest.json"))
    assert manifest["leaves"]["['b']['c']"]["dtype"] == "bfloat16"
    # bf16 is stored as its uint16 bit patterns.
    f = manifest["leaves"]["['b']['c']"]["file"]
    assert np.load(tmp_path / "step_7" / f).dtype == np.uint16


def test_checkpoint_of_a_param_tree(tmp_path):
    """A ParamTree is walked as the nested dicts of its names; a restore
    writes into the like tree's own tensors, in their dtype."""
    cfg = get_arch("qwen3-4b").smoke()
    params = init_params(torch.Generator().manual_seed(0), cfg)
    state = {"params": params, "step": torch.tensor(3, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 3, state)
    keys = set(json.load(open(tmp_path / "step_3" / "manifest.json"))[
        "leaves"])
    assert "['params']['blocks'][1]['attn']['wq_dhk']" in keys
    assert len(keys) == len(tree_paths(state))
    like = {"params": init_params(torch.Generator().manual_seed(1), cfg),
            "step": torch.tensor(0, dtype=torch.int32)}
    before = tree_leaves(like)
    got, step = load_checkpoint(str(tmp_path), like)
    assert step == 3 and got is like
    assert all(a is b for a, b in zip(before, tree_leaves(got)))
    for a, b in zip(tree_leaves(state), tree_leaves(got)):
        assert torch.equal(a, b)


def test_checkpoint_refuses_a_tree_of_other_shapes(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.ones((2,))})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(str(tmp_path), {"x": torch.zeros((3,))})


def test_checkpoint_gc_and_latest(tmp_path):
    tree = {"x": torch.ones((2,))}
    mgr = CheckpointManager(str(tmp_path), keep=2, save_interval=1)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, blocking=True)
    mgr.wait()
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_3", "step_4"]
    assert mgr.latest_step() == 4


def test_checkpoint_atomicity_tmp_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.ones((2,))})
    os.makedirs(tmp_path / "step_9.tmp")   # simulated crash
    assert CheckpointManager(str(tmp_path)).latest_step() == 1


def test_checkpoint_published_step_is_immutable_without_overwrite(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, {"x": torch.zeros((2,))})
    with pytest.raises(FileExistsError, match="step_3"):
        save_checkpoint(d, 3, {"x": torch.ones((2,))})
    got, _ = load_checkpoint(d, {"x": torch.ones((2,))}, step=3)
    assert got["x"].tolist() == [0.0, 0.0]
    save_checkpoint(d, 3, {"x": torch.ones((2,))}, overwrite=True)
    got, _ = load_checkpoint(d, {"x": torch.zeros((2,))}, step=3)
    assert got["x"].tolist() == [1.0, 1.0]
    # Managed saves replace in place (a restarted trainer re-saves the
    # step it restored).
    CheckpointManager(d, save_interval=1).save(3, {"x": torch.zeros((2,))},
                                               blocking=True)


def test_checkpoint_crash_mid_write_restores_previous_step(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"x": torch.full((2,), 5.0)})
    tmp = tmp_path / "step_2.tmp"
    os.makedirs(tmp)
    np.save(tmp / "0.npy", np.ones((2,)))
    assert latest_step(d) == 1
    got, step = load_checkpoint(d, {"x": torch.zeros((2,))})
    assert step == 1 and got["x"].tolist() == [5.0, 5.0]
    save_checkpoint(d, 2, {"x": torch.full((2,), 7.0)})
    assert not tmp.exists()
    assert latest_step(d) == 2


def test_async_save_copies_before_returning(tmp_path):
    """The device→host copy is taken on the caller's thread, so an
    in-place update after ``save`` returns does not reach the file."""
    x = torch.full((4,), 2.0)
    mgr = CheckpointManager(str(tmp_path), save_interval=1)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    got, _ = load_checkpoint(str(tmp_path), {"x": torch.zeros(4)})
    assert got["x"].tolist() == [2.0] * 4


# -- data pipeline --------------------------------------------------------------

def _batches(make, cfg_cls, n=3, **kw):
    p = make(cfg_cls(**kw))
    out = [next(iter(p)) for _ in range(n)]
    p.close()
    return out


@pytest.mark.parametrize("kw", [
    dict(global_batch=4, seq_len=16, vocab=100),
    dict(global_batch=8, seq_len=16, vocab=100, host_index=1, num_hosts=2,
         seed=5),
    dict(global_batch=2, seq_len=16, vocab=100, frontend_tokens=4,
         d_model=8),
    dict(global_batch=2, seq_len=32, vocab=100, enc_len=8, d_model=8,
         seed=3),
], ids=["text", "host1of2", "vision", "encdec"])
def test_pipeline_matches_jax_bit_for_bit(kw):
    got = _batches(make_pipeline, DataConfig, **kw)
    want = _batches(j_make_pipeline, JDataConfig, **kw)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_file_stream_matches_jax(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 10 * 17 + 5).astype(
        np.int32).tofile(path)
    for host in (0, 1):
        kw = dict(global_batch=4, seq_len=16, vocab=1000, host_index=host,
                  num_hosts=2, token_file=str(path))
        got, want = _file_stream(DataConfig(**kw)), j_file_stream(
            JDataConfig(**kw))
        for _ in range(4):
            g, w = next(got), next(want)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        assert g["tokens"].shape == (2, 16)
    # Through the pipeline too: the token file, not the synthetic stream.
    b = _batches(make_pipeline, DataConfig, n=1, global_batch=2, seq_len=16,
                 vocab=1000, token_file=str(path))[0]
    data = np.fromfile(path, np.int32)
    np.testing.assert_array_equal(b["tokens"][0], data[:16])
    np.testing.assert_array_equal(b["targets"][1], data[18:34])


def test_pipeline_host_sharding_disjoint_and_deterministic():
    def batches(host):
        return _batches(make_pipeline, DataConfig, n=2, global_batch=8,
                        seq_len=16, vocab=100, host_index=host, num_hosts=2,
                        seed=5)
    a0, a1, b0 = batches(0), batches(1), batches(0)
    for x, y in zip(a0, b0):
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
    assert not np.array_equal(a0[0]["tokens"], a1[0]["tokens"])
    assert a0[0]["tokens"].shape == (4, 16)


def test_pipeline_vision_weights_mask():
    b = _batches(make_pipeline, DataConfig, n=1, global_batch=2, seq_len=16,
                 vocab=100, frontend_tokens=4, d_model=8)[0]
    assert b["frontend"].shape == (2, 4, 8)
    assert np.all(b["weights"][:, :4] == 0)
    assert np.all(b["weights"][:, 4:] == 1)
