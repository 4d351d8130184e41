"""PyTorch port: the fabric and bank smokes' ``--trace``, and the launch
package's re-export, held against the JAX package.

The CI runs ``python -m repro.net.smoke --app stencil --rows 2 --cols 2
--trace ...`` and ``python -m repro.mem.smoke --app axpy --ndev 4 --trace
...``.  The port's smokes take the same flags; on the CPU (``--device
cpu``) each writes the JAX smoke's Chrome trace event for event (the
wall-clock ``args.busy_s`` of a task firing aside, on both sides), with
the same ``otherData``, and a record whose every field the JAX record has
too is the JAX record's.  Without ``--trace`` no trace is written and the
record keeps its fields.

The JAX smokes run in a subprocess (importing them sets ``XLA_FLAGS`` for
the whole process) on the JAX CPU backend, their kernels in interpret
mode; the port's ``main`` runs in this process.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.mem import smoke as mem_smoke
from repro_torch.net import smoke as net_smoke

ROOT = pathlib.Path(__file__).resolve().parent.parent

# name: (JAX module, port module, the CI's arguments, trace events)
SMOKES = {
    "net": ("repro.net.smoke", net_smoke,
            ["--app", "stencil", "--rows", "2", "--cols", "2"], 93),
    "mem": ("repro.mem.smoke", mem_smoke,
            ["--app", "axpy", "--ndev", "4"], 259),
}

# The port's records before ``--trace`` came over.
RECORD_KEYS = {
    "net": {"app", "mesh", "device", "parity_max_err", "atol",
            "bit_identical", "agreement", "sweeps", "ideal_sweeps",
            "fabric", "congestion", "feedback"},
    "mem": {"app", "ndev", "device", "agreement", "bit_identical", "sweeps",
            "ideal_sweeps", "mem_waits", "config", "bank_map", "measured",
            "projected", "feedback"},
}


def _without_busy_s(doc: dict) -> dict:
    """The trace with the wall-clock ``busy_s`` of each firing removed."""
    for ev in doc["traceEvents"]:
        ev.get("args", {}).pop("busy_s", None)
    return doc


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{name: (record, trace)} of the JAX smokes at the CI's arguments."""
    runs = {}
    for name, (module, _, argv, _) in SMOKES.items():
        d = tmp_path_factory.mktemp(f"jax_{name}")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(
            [sys.executable, "-m", module, *argv,
             "--out", str(d / "record.json"),
             "--trace", str(d / "trace.json")],
            env=env, cwd=d, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
        runs[name] = (json.loads((d / "record.json").read_text()),
                      json.loads((d / "trace.json").read_text()))
    return runs


def _port_run(name: str, d: pathlib.Path, capsys, trace: bool = True):
    """(record, trace or None, stdout) of the port's smoke on the CPU."""
    _, smoke, argv, _ = SMOKES[name]
    extra = ["--trace", str(d / "trace.json")] if trace else []
    assert smoke.main([*argv, "--device", "cpu",
                       "--out", str(d / "record.json"), *extra]) == 0
    stdout = capsys.readouterr().out
    doc = (json.loads((d / "trace.json").read_text())
           if (d / "trace.json").exists() else None)
    return json.loads((d / "record.json").read_text()), doc, stdout


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_trace_equals_jax(name, jax_runs, tmp_path, capsys):
    _, doc, stdout = _port_run(name, tmp_path, capsys)
    want = jax_runs[name][1]
    events = SMOKES[name][3]
    assert len(doc["traceEvents"]) == len(want["traceEvents"]) == events
    assert doc["otherData"] == want["otherData"]
    assert _without_busy_s(doc) == _without_busy_s(want)
    assert (f"wrote Chrome trace ({events} events) to "
            f"{tmp_path / 'trace.json'}") in stdout.splitlines()


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_record_equals_jax(name, jax_runs, tmp_path, capsys):
    record, _, _ = _port_run(name, tmp_path, capsys)
    want = jax_runs[name][0]
    assert set(want) <= set(record)
    assert {k: record[k] for k in want} == want
    assert record["device"] == "cpu"


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_no_trace_without_the_flag(name, tmp_path, capsys):
    traced, _, _ = _port_run(name, tmp_path / "traced", capsys)
    record, doc, stdout = _port_run(name, tmp_path / "plain", capsys,
                                    trace=False)
    assert doc is None
    assert sorted(os.listdir(tmp_path / "plain")) == ["record.json"]
    assert "Chrome trace" not in stdout
    assert set(record) == RECORD_KEYS[name]
    assert record == traced


def test_make_production_mesh_is_exported_by_the_package():
    from repro_torch.launch import make_production_mesh
    from repro_torch.launch import mesh
    assert make_production_mesh is mesh.make_production_mesh
