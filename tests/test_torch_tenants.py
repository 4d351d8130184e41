"""PyTorch port, tenant slice: ``repro_torch.tenants`` and the executor's
shared mode held against the JAX package's ``repro.tenants``.

* traffic, admission, the fluid simulation, fair share, the isolation
  check and ``shrink_cluster`` — every case of ``tests/test_tenants.py``'s
  first half, run through both packages with equal results (floats bit for
  bit: both are the same numpy code), and the case's own assertions on the
  port;
* the tenant server — every server case of ``tests/test_tenants.py``, the
  port on ``device="cpu"`` and the JAX package on its CPU backend, each
  with its own assertions and also the JAX run's sweeps, statuses,
  ``killed_at`` / ``recovered_as`` / ``recovered_via``, per-link
  ``flow_bytes``, the ``conservation()`` dict, each tenant's
  ``congestion.kind`` and link bytes, and its outputs bit for bit (stencil
  is bit-exact); ``recompile``'s partition equal to the JAX one;
* two ``axpy`` tenants over a shared bank model, and their kill, against
  the JAX run: bank bytes per tenant and outputs bit for bit;
* the cost ledger, the substrate registry, ``server.metrics()`` and an
  ``SLOMonitor`` over a real server equal to ``repro.obs`` over the JAX
  server, a monitored run bit-identical to an unmonitored one;
* ``ExecutionState``'s shared-mode errors, with the JAX package's messages;
* the tenant smoke with ``--device cpu``, and no silent CPU without it.

Both packages compile the same graphs with the same options on the same
host, so the partition MILP breaks its ties alike.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.tenants as jt
import repro_torch.obs as tobs
import repro_torch.tenants as tt
from repro.apps import APPS as JAX_APPS
from repro.compiler import CompileOptions as JaxOptions
from repro.compiler import compile as jax_compile
from repro.core import fpga_ring_cluster as jax_ring
from repro.exec import bind_programs as jax_bind
from repro.mem import MemConfig as JaxMemConfig
from repro.net import NetConfig as JaxNetConfig
from repro.net import cluster_fabric as jax_fabric
from repro.net.faults import FaultModel as JaxFaultModel
from repro.net.faults import LinkFaults as JaxLinkFaults
from repro_torch.apps import APPS
from repro_torch.compiler import CompileOptions, compile
from repro_torch.core import fpga_ring_cluster
from repro_torch.exec import bind_programs, bit_identical, execute
from repro_torch.mem import MemConfig
from repro_torch.net import NetConfig, cluster_fabric
from repro_torch.net.faults import FaultModel, LinkFaults
from repro_torch.tenants.smoke import serve_counters

ROOT = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
PKGS = {"jax": jt, "port": tt}


def _astuples(rows):
    return [dataclasses.astuple(r) for r in rows]


def _same_bits(port, ref) -> bool:
    """A port tensor and a JAX array: same dtype, shape and bit pattern."""
    a = port.detach().cpu().numpy()
    b = np.asarray(ref)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Traffic, admission, the fluid model (tests/test_tenants.py:38-200).
# ---------------------------------------------------------------------------

def _traffic(pkg, **kw):
    base = pkg.TrafficConfig(rate_rps=200.0, mean_size=4096.0,
                             duration_s=2.0)
    return dataclasses.replace(base, **kw)


def test_traffic_is_deterministic_per_seed_and_tenant():
    out = {}
    for k, pkg in PKGS.items():
        cfg = _traffic(pkg)
        out[k] = (pkg.generate(cfg, 0, np.random.default_rng([7, 0])),
                  pkg.generate(cfg, 0, np.random.default_rng([7, 0])),
                  pkg.generate(cfg, 1, np.random.default_rng([7, 1])))
    a1, a2, b = out["port"]
    assert a1 == a2 and a1 != b
    assert all(r.tenant == 0 for r in a1) and all(r.size > 0 for r in a1)
    arr = [r.t_arrival for r in a1]
    assert arr == sorted(arr) and arr[-1] <= 2.0
    for p, j in zip(out["port"], out["jax"]):
        assert _astuples(p) == _astuples(j)


def test_traffic_rate_and_mean_size_are_calibrated():
    out = {}
    for k, pkg in PKGS.items():
        cfg = _traffic(pkg, duration_s=50.0)
        reqs = pkg.generate(cfg, 0, np.random.default_rng([3, 0]))
        out[k] = (len(reqs) / cfg.duration_s,
                  float(np.mean([r.size for r in reqs])),
                  pkg.offered_load(reqs, cfg.duration_s),
                  pkg.offered_load([], 0.0))
    rate, mean, load, empty = out["port"]
    assert rate == pytest.approx(200.0, rel=0.1)
    assert mean == pytest.approx(4096.0, rel=0.2)
    assert load == pytest.approx(200.0 * 4096.0, rel=0.25)
    assert empty == 0.0
    assert out["port"] == out["jax"]


def test_traffic_scaled_and_merge():
    out = {}
    for k, pkg in PKGS.items():
        cfg = _traffic(pkg)
        a = pkg.generate(cfg, 0, np.random.default_rng([1, 0]))
        b = pkg.generate(cfg, 1, np.random.default_rng([1, 1]))
        out[k] = (cfg.scaled(2.0).rate_rps, a, b, pkg.merge([a, b]))
    doubled, a, b, m = out["port"]
    assert doubled == 2 * 200.0
    assert len(m) == len(a) + len(b)
    assert [r.t_arrival for r in m] == sorted(r.t_arrival for r in m)
    assert out["port"][0] == out["jax"][0]
    for p, j in zip(out["port"][1:], out["jax"][1:]):
        assert _astuples(p) == _astuples(j)


def test_profiles_modulate_the_rate():
    out = {}
    for k, pkg in PKGS.items():
        diurnal = _traffic(pkg, profile="diurnal", swing=0.5, period_s=10.0)
        ramp = _traffic(pkg, profile="ramp", swing=0.9, duration_s=20.0)
        flat = _traffic(pkg, duration_s=20.0)
        out[k] = (
            [diurnal.rate_at(t) for t in (0.0, 2.5, 7.5)],
            [ramp.rate_at(t) for t in (0.0, 20.0)],
            float(np.median([r.t_arrival for r in pkg.generate(
                flat, 0, np.random.default_rng([5, 0]))])),
            float(np.median([r.t_arrival for r in pkg.generate(
                ramp, 0, np.random.default_rng([5, 0]))])))
    (d0, d25, d75), (r0, r20), mf, mr = out["port"]
    assert d25 > d0 > d75
    assert r20 > r0
    assert mr > mf + 2.0
    assert out["port"] == out["jax"]


def _req(pkg, rid, tenant, t, size=1000.0):
    return pkg.Request(rid=rid, tenant=tenant, t_arrival=t, size=size)


def _stats(ctrl):
    return {t: dataclasses.astuple(s) for t, s in ctrl.stats.items()}


def test_admission_three_way_call():
    out = {}
    for k, pkg in PKGS.items():
        slo = pkg.SLO(target_latency_s=1.0, max_inflight=1,
                      deadline_factor=3.0)
        ctrl = pkg.AdmissionController({0: slo}, {0: 1000.0})
        calls = [ctrl.offer(_req(pkg, 0, 0, 0.0), 0.0),
                 ctrl.offer(_req(pkg, 1, 0, 0.1), 0.1),
                 ctrl.offer(_req(pkg, 2, 0, 0.2, size=3000.0), 0.2)]
        out[k] = (calls, _stats(ctrl))
    calls, _ = out["port"]
    assert calls == [tt.ADMIT, tt.QUEUE, tt.REJECT]
    assert out["port"] == out["jax"]


def test_priority_aging_prefers_tight_slo():
    out = {}
    for k, pkg in PKGS.items():
        tight = pkg.SLO(target_latency_s=0.1, max_inflight=1,
                        deadline_factor=40.0)
        loose = pkg.SLO(target_latency_s=10.0, max_inflight=1,
                        deadline_factor=4.0)
        ctrl = pkg.AdmissionController({0: loose, 1: tight},
                                       {0: 1e6, 1: 1e6})
        calls = [ctrl.offer(_req(pkg, 0, 0, 0.0), 0.0),
                 ctrl.offer(_req(pkg, 1, 1, 0.0), 0.0),
                 ctrl.offer(_req(pkg, 2, 0, 0.1), 0.1),
                 ctrl.offer(_req(pkg, 3, 1, 0.3), 0.3)]
        ctrl.complete(_req(pkg, 0, 0, 0.0))
        ctrl.complete(_req(pkg, 1, 1, 0.0))
        first, second = ctrl.release(1.0), ctrl.release(1.0)
        out[k] = (calls, (first.tenant, first.rid),
                  (second.tenant, second.rid), _stats(ctrl))
    calls, first, second, _ = out["port"]
    assert calls == [tt.ADMIT, tt.ADMIT, tt.QUEUE, tt.QUEUE]
    assert first == (1, 3) and second == (0, 2)
    assert out["port"] == out["jax"]


def test_expired_pending_is_shed_as_rejected():
    out = {}
    for k, pkg in PKGS.items():
        slo = pkg.SLO(target_latency_s=0.1, max_inflight=1,
                      deadline_factor=2.0)
        ctrl = pkg.AdmissionController({0: slo}, {0: 1e9})
        calls = [ctrl.offer(_req(pkg, 0, 0, 0.0), 0.0),
                 ctrl.offer(_req(pkg, 1, 0, 0.0), 0.0)]
        ctrl.complete(_req(pkg, 0, 0, 0.0))
        released = ctrl.release(10.0)
        out[k] = (calls, released, ctrl.stats[0].rejected, ctrl.pending,
                  _stats(ctrl))
    calls, released, rejected, pending, _ = out["port"]
    assert calls == [tt.ADMIT, tt.QUEUE]
    assert released is None and rejected == 1 and pending == 0
    assert out["port"] == out["jax"]


def _load(pkg, name, rate_frac, capacity, weight=1.0, mean=65536.0):
    share = capacity * weight / 2.0
    return pkg.TenantLoad(
        name=name,
        slo=pkg.SLO(target_latency_s=16 * mean / share, weight=weight,
                    max_inflight=8),
        traffic=pkg.TrafficConfig(rate_rps=rate_frac * share / mean,
                                  mean_size=mean, duration_s=2.0))


def test_simulate_underload_meets_slo():
    cap = 1e8
    out = {k: pkg.simulate({0: _load(pkg, "a", 0.3, cap),
                            1: _load(pkg, "b", 0.3, cap)}, cap, seed=1)
           for k, pkg in PKGS.items()}
    res = out["port"]
    for t in (0, 1):
        st = res.tenants[t]
        assert st.completed > 0
        assert st.rejected <= 0.01 * st.offered
        assert st.completed_in_slo >= 0.99 * st.completed
        assert st.goodput_bytes > 0
    assert dataclasses.asdict(res) == dataclasses.asdict(out["jax"])
    assert res.summary() == out["jax"].summary()


def test_load_sweep_goodput_folds_over_at_saturation():
    cap = 1e8
    out = {k: pkg.load_sweep({0: _load(pkg, "a", 1.0, cap),
                              1: _load(pkg, "b", 1.0, cap)},
                             cap, [0.25, 1.0, 4.0], seed=2)
           for k, pkg in PKGS.items()}
    rows = out["port"]
    assert [r["load_factor"] for r in rows] == [0.25, 1.0, 4.0]
    g = [sum(t["goodput_Bps"] for t in r["tenants"].values())
         for r in rows]
    assert g[1] > g[0] and g[2] <= cap
    p99 = [r["tenants"]["a"]["p99_latency_s"] for r in rows]
    assert p99[2] >= p99[0]
    assert rows[2]["tenants"]["a"]["rejected"] > 0
    assert rows == out["jax"]


def test_isolation_invariant_against_an_oversubscribing_peer():
    out = {k: pkg.isolation_check(1e9, seed=0) for k, pkg in PKGS.items()}
    iso = out["port"]
    assert iso["isolated"] and iso["victim_share_frac"] >= 0.9
    assert iso["aggressor"]["rejected"] > 0
    assert iso == out["jax"]


def test_fair_share_is_weight_proportional():
    w = {0: 3.0, 1: 1.0}
    for t, want in ((0, 6e9), (1, 2e9)):
        got = tt.fair_share(8e9, w, t)
        assert got == pytest.approx(want)
        assert got == jt.fair_share(8e9, w, t)


def test_shrink_cluster_topology_families():
    from repro.core import Bus as JBus
    from repro.core.topology import ALVEO_U55C as JU55C
    from repro.core.topology import Cluster as JCluster
    from repro_torch.core import Bus, DaisyChain, Ring
    from repro_torch.core.topology import ALVEO_U55C, Cluster
    port = {
        "ring3": tt.shrink_cluster(fpga_ring_cluster(4), 3),
        "ring2": tt.shrink_cluster(fpga_ring_cluster(4), 2),
        "bus3": tt.shrink_cluster(Cluster(ALVEO_U55C, Bus(4)), 3),
        "grouped2": tt.shrink_cluster(
            fpga_ring_cluster(4, devices_per_node=2), 2)}
    ref = {
        "ring3": jt.shrink_cluster(jax_ring(4), 3),
        "ring2": jt.shrink_cluster(jax_ring(4), 2),
        "bus3": jt.shrink_cluster(JCluster(JU55C, JBus(4)), 3),
        "grouped2": jt.shrink_cluster(jax_ring(4, devices_per_node=2), 2)}
    assert isinstance(port["ring3"].topology, Ring)
    assert isinstance(port["ring2"].topology, DaisyChain)
    assert isinstance(port["bus3"].topology, Bus)
    assert port["bus3"].topology.num_devices == 3
    assert port["grouped2"].devices_per_node is None
    for k in port:
        p, j = port[k], ref[k]
        assert type(p.topology).__name__ == type(j.topology).__name__, k
        assert p.topology.num_devices == j.topology.num_devices, k
        assert p.devices_per_node == j.devices_per_node, k


# ---------------------------------------------------------------------------
# The tenant server (tests/test_tenants.py:240-455), both packages.
# ---------------------------------------------------------------------------

_OPTS = dict(balance_kind="LUT", balance_tol=0.8, exact_limit=1500,
             floorplan_devices=(0,))
_SPECS = {"a": {"seed": 0}, "b": {"seed": 7}}
_AXPY_SPECS = {"a": {"seed": 0}, "b": {"seed": 1}}


def jax_binding(app: str, graph, spec):
    """The JAX package's binding of ``graph`` streaming the port's numpy
    inputs (``make_inputs``), so both packages compute on the same
    arrays: the JAX binders draw theirs with ``jax.random``."""
    import jax.numpy as jnp
    arrays = APPS[app].make_inputs(graph, spec)
    if app == "stencil":
        binding = jax_bind(graph, spec)
        return dataclasses.replace(binding, source_inputs={
            t: [jnp.asarray(img) for img in arrays["imgs"]]
            for t in binding.source_inputs})
    from unittest import mock
    streams = lambda sp, names=("x", "y"): {  # noqa: E731
        n: [jnp.asarray(a) for a in arrays[n]] for n in names}
    with mock.patch(f"repro.apps.{app}.make_streams", streams):
        return jax_bind(graph, spec)


class _Side:
    """One package's compiled tenants, solo runs and server plumbing.  The
    JAX side binds the port's inputs (:func:`jax_binding`)."""

    def __init__(self, port: bool, app: str, specs):
        self.port = port
        self.app = app
        self.specs = specs
        self.pkg = tt if port else jt
        apps = APPS if port else JAX_APPS
        ring = fpga_ring_cluster if port else jax_ring
        comp = compile if port else jax_compile
        opts = (CompileOptions if port else JaxOptions)(**_OPTS)
        self.graphs = {n: apps[app].build_graph(2) for n in specs}
        self.designs = {n: comp(self.graphs[n], ring(2), opts)
                        for n in specs}
        if port:
            self.solo = {n: execute(self.designs[n],
                                    bind_programs(self.graphs[n], specs[n],
                                                  device=CPU),
                                    device=CPU, fabric=None, mem=None)
                         for n in specs}

    def fabric(self):
        return (cluster_fabric(fpga_ring_cluster(4)) if self.port
                else jax_fabric(jax_ring(4)))

    def tenants(self, **fields):
        pkg = self.pkg
        place = {"a": ([0, 2], 2.0), "b": ([0, 1], 1.0)}
        return [pkg.Tenant(n, self.designs[n], device_map=list(place[n][0]),
                           slo=pkg.SLO(1e-3, weight=place[n][1]),
                           inputs=self.specs[n],
                           make_binding=self.make_binding(n),
                           **fields.get(n, {}))
                for n in self.specs]

    def make_binding(self, name):
        if self.port:
            return None
        return lambda: jax_binding(self.app, self.graphs[name],
                                   self.specs[name])

    def server(self, tenants, **kw):
        if self.port:
            kw.setdefault("device", CPU)
        return self.pkg.TenantServer(self.fabric(), tenants, **kw)

    def reference(self, name):
        """The port's binding of ``name``: both sides' ``reference()``."""
        return bind_programs(self.graphs[name], self.specs[name], device=CPU)


@pytest.fixture(scope="module")
def sides():
    return _Side(True, "stencil", _SPECS), _Side(False, "stencil", _SPECS)


def _assert_same_run(pserver, pout, jserver, jout):
    """The smoke's integer record of both runs equal (sweeps, statuses,
    kills and recoveries, per-link flow bytes, conservation, each
    tenant's congestion kind and link and bank bytes), and every finished
    tenant's outputs bit for bit."""
    assert serve_counters(pserver, pout) == serve_counters(jserver, jout)
    for prec, jrec in zip(pout.records, jout.records):
        if prec.result is not None:
            assert _same_bits(prec.result.outputs, jrec.result.outputs), \
                prec.name


def test_corun_is_bit_identical_with_exact_conservation(sides):
    runs = []
    for side in sides:
        server = side.server(side.tenants())
        out = server.run()
        for n in _SPECS:
            rec = out.record(n)
            assert rec.status == "done"
            assert all(rec.result.report.agreement().values()), n
        assert any(len(c.flow_bytes) >= 2 for c in server.transport.counters)
        cons = out.conservation
        assert cons["exact"]
        assert sum(cons["per_tenant_link_bytes"].values()) \
            == cons["total_link_bytes"]
        assert all(b > 0 for b in cons["per_tenant_link_bytes"].values())
        for n in _SPECS:
            cong = out.record(n).result.report.congestion
            assert sum(l.bytes for l in cong.links) \
                == cons["per_tenant_link_bytes"][n]
            assert cong.kind.endswith(f"flow{out.record(n).flow}")
        runs.append((server, out))
    (ps, po), (js, jo) = runs
    for n in _SPECS:
        assert bit_identical(po.record(n).result.outputs,
                             sides[0].solo[n].outputs), n
    _assert_same_run(ps, po, js, jo)
    assert po.sweeps == 9 and po.conservation["total_link_bytes"] == 147456


def test_device_kill_drains_readmits_and_spares_the_peer(sides):
    runs = []
    for side in sides:
        server = side.server(side.tenants())
        out = server.run(faults=[side.pkg.DeviceKill(device=2, sweep=2)])
        killed = out.record("a")
        assert killed.status == "killed" and killed.killed_at == 2
        recovered = out.record("a+recovered")
        assert recovered.status == "done"
        assert recovered.flow != killed.flow
        assert out.record("b").status == "done"
        assert out.conservation["exact"]
        binding = sides[0].reference("a")
        got = np.asarray(recovered.result.outputs)
        assert np.max(np.abs(got - binding.reference().numpy())) \
            <= binding.atol
        runs.append((server, out))
    (ps, po), (js, jo) = runs
    assert bit_identical(po.record("b").result.outputs,
                         sides[0].solo["b"].outputs)
    _assert_same_run(ps, po, js, jo)


def test_kill_without_readmit_leaves_victim_dead(sides):
    runs = []
    for side in sides:
        server = side.server(side.tenants())
        out = server.run(faults=[side.pkg.DeviceKill(device=2, sweep=2,
                                                     readmit=False)])
        assert out.record("a").status == "killed"
        assert out.record("a").recovered_as is None
        assert out.record("b").status == "done"
        with pytest.raises(KeyError):
            out.record("a+recovered")
        runs.append((server, out))
    (ps, po), (js, jo) = runs
    _assert_same_run(ps, po, js, jo)


def test_recompile_survivor_design_is_first_class(sides):
    port, ref = (s.pkg.recompile(s.designs["a"], 1) for s in sides)
    assert port.cluster.topology.num_devices == 1
    assert port.partition is not None
    assert set(port.partition.assignment.values()) == {0}
    assert port.options.fabric is None
    assert port.partition.assignment == ref.partition.assignment
    assert port.partition.comm_cost == ref.partition.comm_cost


def test_duplicate_tenant_names_rejected(sides):
    for side in sides:
        tenants = side.tenants()
        tenants[1] = dataclasses.replace(tenants[1], name="a")
        with pytest.raises(ValueError, match="duplicate tenant names"):
            side.server(tenants)


def test_solo_tenant_matches_solo_execution(sides):
    runs = []
    for side in sides:
        net = NetConfig() if side.port else JaxNetConfig()
        server = side.server([side.tenants()[0]], net_config=net)
        out = server.run()
        assert out.record("a").status == "done"
        assert out.conservation["exact"]
        runs.append((server, out))
    (ps, po), (js, jo) = runs
    assert bit_identical(po.record("a").result.outputs,
                         sides[0].solo["a"].outputs)
    _assert_same_run(ps, po, js, jo)


def test_plan_recovery_prefers_restore_when_cluster_survives(tmp_path):
    def plans():
        return [(k, pkg.plan_recovery(dm, dead, checkpoint_dir=str(tmp_path)))
                for k, pkg in PKGS.items()
                for dm, dead in (([0, 2], []), ([0, 2], [2]), ([2], [2]))]
    before = plans()
    (tmp_path / "step_4").mkdir()
    after = plans()
    for seq in (before, after):
        port = [dataclasses.astuple(p) for k, p in seq if k == "port"]
        ref = [dataclasses.astuple(p) for k, p in seq if k == "jax"]
        assert port == ref
    port = {i: p for i, (k, p) in enumerate(
        [x for x in before if x[0] == "port"])}
    assert port[0].action == "recompile" and port[0].ndev == 2
    port = [p for k, p in after if k == "port"]
    assert isinstance(port[0], tt.RecoveryPlan)
    assert port[0].action == "restore" and port[0].step == 4
    assert port[1].action == "recompile" and port[1].ndev == 1
    assert port[2].action == "recompile" and port[2].ndev == 0


def test_transient_kill_restores_from_barrier(sides, tmp_path):
    runs = []
    for side in sides:
        d = tmp_path / ("port" if side.port else "jax")
        server = side.server(side.tenants(a={"checkpoint_dir": str(d)}))
        out = server.run(faults=[side.pkg.DeviceKill(device=2, sweep=4,
                                                     transient=True)],
                         checkpoint_every=2)
        killed = out.record("a")
        assert killed.status == "killed"
        assert killed.recovered_as == "a+recovered"
        rec = out.record("a+recovered")
        assert rec.status == "done" and rec.recovered_via == "restore"
        assert rec.tenant.device_map == [0, 2]
        assert rec.tenant.design is side.designs["a"]
        assert out.conservation["exact"]
        runs.append((server, out))
    (ps, po), (js, jo) = runs
    for n in ("a+recovered", "b"):
        assert bit_identical(po.record(n).result.outputs,
                             sides[0].solo[n[0]].outputs), n
    _assert_same_run(ps, po, js, jo)


def test_permanent_kill_recompiles_and_labels_it(sides, tmp_path):
    runs = []
    for side in sides:
        d = tmp_path / ("port" if side.port else "jax")
        server = side.server(side.tenants(a={"checkpoint_dir": str(d)}))
        out = server.run(faults=[side.pkg.DeviceKill(device=2, sweep=4)],
                         checkpoint_every=2)
        rec = out.record("a+recovered")
        assert rec.status == "done" and rec.recovered_via == "recompile"
        assert rec.tenant.device_map == [0]
        assert rec.tenant.checkpoint_dir is None
        runs.append((server, out))
    (ps, po), (js, jo) = runs
    _assert_same_run(ps, po, js, jo)


def test_kill_that_leaves_no_survivors_declines_gracefully(sides):
    from repro.exec.executor import DeadlockError as JaxDeadlock
    from repro_torch.exec import DeadlockError
    for side, err in zip(sides, (DeadlockError, JaxDeadlock)):
        one_dev = side.pkg.recompile(side.designs["a"], 1)
        server = side.server([side.pkg.Tenant(
            "solo", one_dev, device_map=[2], inputs=_SPECS["a"],
            make_binding=side.make_binding("a"))])
        with pytest.raises(err, match="no surviving devices"):
            server.run(faults=[side.pkg.DeviceKill(device=2, sweep=2)])
        with pytest.raises(ValueError, match="at least one surviving"):
            side.pkg.recompile(side.designs["a"], 0)


def test_double_kill_of_same_device_is_idempotent(sides):
    runs = []
    for side in sides:
        server = side.server(side.tenants())
        kill = side.pkg.DeviceKill
        out = server.run(faults=[kill(device=2, sweep=2),
                                 kill(device=2, sweep=4)])
        killed = out.record("a")
        assert killed.status == "killed" and killed.killed_at == 2
        assert killed.recovered_as == "a+recovered"
        assert out.record("a+recovered").status == "done"
        assert len([r for r in out.records if r.name.startswith("a")]) == 2
        assert out.conservation["exact"]
        runs.append((server, out))
    (ps, po), (js, jo) = runs
    assert bit_identical(po.record("b").result.outputs,
                         sides[0].solo["b"].outputs)
    _assert_same_run(ps, po, js, jo)


def test_cancel_flow_twice_is_a_noop(sides):
    books = []
    for side in sides:
        server = side.server(side.tenants())
        tr = server.transport
        sweep = 0
        while not tr.active and sweep < 16:
            for rec in server.records:
                if rec.state is not None:
                    rec.state.advance(sweep)
            tr.step(sweep)
            sweep += 1
        assert tr.active, "no in-flight traffic to cancel"
        first = tr.cancel_flow(0)
        snap = [(c.bytes, dict(c.flow_bytes)) for c in tr.counters]
        second = tr.cancel_flow(0)
        assert first and second == []
        assert snap == [(c.bytes, dict(c.flow_bytes)) for c in tr.counters]
        assert not tr.flow_active(0)
        books.append((sweep, first, snap))
    assert books[0] == books[1]


# ---------------------------------------------------------------------------
# Shared banks: two axpy tenants over one MemorySystem.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def axpy_sides():
    return (_Side(True, "axpy", _AXPY_SPECS),
            _Side(False, "axpy", _AXPY_SPECS))


@pytest.mark.parametrize("kill", [False, True], ids=["corun", "kill"])
def test_shared_bank_corun_matches_jax(axpy_sides, kill):
    runs = []
    for side in axpy_sides:
        mem = MemConfig() if side.port else JaxMemConfig()
        server = side.server(side.tenants(), mem_config=mem)
        faults = [side.pkg.DeviceKill(device=2, sweep=2)] if kill else []
        out = server.run(faults=faults)
        cons = out.conservation
        assert cons["total_bank_bytes"] \
            == sum(cons["per_tenant_bank_bytes"].values())
        for rec in out.records:
            if rec.status == "done":
                rep = rec.result.report
                assert all(rep.agreement().values()), rec.name
                assert sum(b.bytes for b in rep.mem_contention.banks) \
                    == cons["per_tenant_bank_bytes"][rec.name]
        runs.append((server, out))
    (ps, po), (js, jo) = runs
    _assert_same_run(ps, po, js, jo)
    port = axpy_sides[0]
    for rec in po.records:
        if rec.status == "done":
            want = (port.solo[rec.name].outputs if rec.recovered_via is None
                    else port.reference("a").reference())
            assert bit_identical(rec.result.outputs, want), rec.name
    if kill:
        assert po.sweeps == 7
        assert [r.recovered_via for r in po.records] \
            == [None, None, "recompile"]
    else:
        assert po.sweeps == 6
        assert po.conservation["per_tenant_bank_bytes"] == {
            "a": 49152, "b": 49152}


# ---------------------------------------------------------------------------
# The cost ledger, the substrate registry and the SLO monitor over a real
# server.
# ---------------------------------------------------------------------------

def _obs_run(side, scenario):
    obs = tobs if side.port else jobs
    tracer = obs.Tracer()
    kw = {}
    faults = []
    if scenario == "lossy":
        lf = LinkFaults if side.port else JaxLinkFaults
        fm = (FaultModel if side.port else JaxFaultModel)(
            seed=3, default=lf(drop=0.10, corrupt=0.05),
            fail_threshold=None)
        kw["net_config"] = (NetConfig if side.port else JaxNetConfig)(
            faults=fm)
    if scenario == "kill":
        faults = [side.pkg.DeviceKill(device=2, sweep=2)]
    server = side.server(side.tenants(), tracer=tracer, **kw)
    monitor = obs.SLOMonitor(window=32, latency_limit_s=1e-9)
    out = server.run(faults=faults, monitor=monitor)
    crit = obs.analyze(tracer, sweeps=out.sweeps)
    ledger = obs.build_ledger(server, crit=crit)
    registry = obs.substrate_metrics(server)
    obs.assert_ledger_consistent(ledger, server, crit=crit,
                                 registry=registry)
    if scenario == "kill":
        obs.assert_peers_uncharged(ledger, ["a"])
    return server, out, tracer, monitor, ledger, registry


@pytest.mark.parametrize("scenario", ["clean", "lossy", "kill"])
def test_ledger_registry_and_monitor_match_jax(sides, scenario):
    port, ref = (_obs_run(side, scenario) for side in sides)
    ps, po, ptr, pmon, pled, preg = port
    js, jo, jtr, jmon, jled, jreg = ref
    _assert_same_run(ps, po, js, jo)
    assert pled.to_json() == jled.to_json()
    assert preg.to_json() == jreg.to_json()
    assert ps.metrics().to_json() == js.metrics().to_json()
    assert pmon.alerts == jmon.alerts
    assert pmon.summary(po.sweeps) == jmon.summary(jo.sweeps)
    assert ptr.count("slo_alert") == len(pmon.alerts) > 0
    by = pled.by_lineage()
    if scenario == "lossy":
        assert by["a"]["retransmit_bytes"] > 0
        assert by["b"]["retransmit_bytes"] > 0
    if scenario == "kill":
        assert by["a"]["cancelled_bytes"] > 0
        assert by["a"]["restore_sweeps"] > 0
    if scenario == "clean":
        # The monitor only reads the trace and appends alerts: a monitored
        # run is bit-identical to an unmonitored one.
        side = sides[0]
        base = side.server(side.tenants()).run()
        assert base.sweeps == po.sweeps
        for n in _SPECS:
            assert bit_identical(base.record(n).result.outputs,
                                 po.record(n).result.outputs), n


# ---------------------------------------------------------------------------
# ExecutionState's shared mode: the JAX package's errors.
# ---------------------------------------------------------------------------

def test_shared_mode_errors_match_jax(sides):
    from repro.exec.executor import ExecutionState as JaxState
    from repro.net import FabricTransport as JaxTransport
    from repro.tenants import FlowTransport as JaxFlow
    from repro_torch.exec import ExecutionState
    from repro_torch.net import FabricTransport
    from repro_torch.tenants import FlowTransport
    port, ref = sides
    cases = [([0], "device_map covers 1 logical devices but the partition "
                   "uses 2"),
             ([0, 5], r"device_map targets fabric devices \[5\] outside "
                      r"the shared fabric's 0\.\.3")]
    for dm, msg in cases:
        with pytest.raises(ValueError, match=msg):
            JaxState(ref.designs["a"], ref.make_binding("a")(),
                     transport=JaxFlow(JaxTransport(ref.fabric()), 0, 0),
                     device_map=dm)
        with pytest.raises(ValueError, match=msg):
            ExecutionState(port.designs["a"], device=CPU,
                           transport=FlowTransport(
                               FabricTransport(port.fabric()), 0, 0),
                           device_map=dm)


# ---------------------------------------------------------------------------
# No silent CPU, and the smoke.
# ---------------------------------------------------------------------------

def test_server_and_smoke_need_a_card_or_cpu_asked(sides, monkeypatch):
    from repro_torch.tenants import smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = sides[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.TenantServer(port.fabric(), port.tenants())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoke.main(["--out", os.devnull])


def test_tenant_smoke_runs_on_cpu(tmp_path):
    out = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.tenants.smoke", "--device",
         "cpu", "--out", str(out), "--trace", str(tmp_path / "t.json")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "SERVE_SMOKE_OK" in res.stdout
    import json
    doc = json.loads(out.read_text())
    assert doc["stencil"]["counters"]["corun"]["sweeps"] == 9
    assert doc["banks"]["counters"]["corun"]["conservation"][
        "per_tenant_bank_bytes"] == {"a": 49152, "b": 49152}
