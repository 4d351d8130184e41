"""PyTorch port, fabric slice: ``repro_torch.net`` (a copy of the JAX
package's ``net``) and the executor's fabric path, each against the JAX
package.

The transport cases are the fixed cases of ``tests/test_net.py`` and
``tests/test_conservation_properties.py`` (routing, conservation, hop
latency, weighted flows, cancellation, fault attribution, kill-peer, route
repair), each run through both packages: every per-link counter, every
delivery sweep and every per-flow tally must be equal, and each case's own
invariants must hold in the port.  No case asserts the order in which one
channel's messages complete (the JAX transport completes them out of order
on some inputs; ``FifoChannel`` keeps the executor right).  The compiler's
``congestion_feedback`` pass gives the same detail and partition.  Through
the executor, the fabric path computes the same bits as the ideal path,
and its report's ``net`` summary equals the JAX run's.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.net as jnet
import repro.net.faults as jfaults
import repro_torch.core as tcore
import repro_torch.net as tnet
import repro_torch.net.faults as tfaults
from repro.apps import APPS as JAX_APPS
from repro.compiler import CompileOptions as JaxOptions
from repro.compiler import compile as jax_compile
from repro.exec import execute as jax_execute
from repro_torch.apps import APPS
from repro_torch.compiler import CompileOptions, compile
from repro_torch.exec import execute
from repro_torch.net import smoke as net_smoke

from _torch_parity import fabric_designs

sys.path.insert(0, str(Path(__file__).parent))
from _hypothesis_compat import given, settings, st  # noqa: E402

PKGS = {"jax": (jcore, jnet, jfaults), "port": (tcore, tnet, tfaults)}
# test_net.py's ALL_TOPOS and test_conservation_properties.py's _TOPOS.
ALL_TOPOS = [("DaisyChain", (5,)), ("Ring", (6,)), ("Bus", (4,)),
             ("Star", (5,)), ("Mesh2D", (3, 4)), ("Mesh2D", (3, 4, True)),
             ("Hypercube", (3,))]
CONS_TOPOS = [("DaisyChain", (3,)), ("Ring", (4,)), ("Ring", (5,)),
              ("Bus", (3,)), ("Star", (4,)), ("Mesh2D", (2, 3)),
              ("Hypercube", (3,))]


def _topo(core, spec):
    name, args = spec
    return getattr(core, name)(*args)


def _cfg(core, net, budget_flits=2, mtu=64, credits=4, **kw):
    # sweep_time sized so an Ethernet link moves `budget_flits` per sweep.
    bw = core.topology.ETHERNET_100G.bandwidth_Bps
    return net.NetConfig(mtu_bytes=mtu, link_credits=credits,
                         sweep_time_s=(budget_flits * mtu) / bw, **kw)


def _counters(tr):
    return [dataclasses.asdict(c) for c in tr.counters]


def _run(tr, start=0):
    """Step until the transport is idle: (sorted (sweep, mid, channel)
    deliveries, the sweep it stopped at)."""
    done, s = [], start
    while tr.active:
        done += [(s, mid, ch) for mid, ch in tr.step(s)]
        s += 1
        assert s < 100_000, "transport failed to make progress"
    return sorted(done), s


def _both(case, *args):
    """``case`` through each package; the two results must be equal."""
    got = case(*PKGS["port"], *args)
    assert got == case(*PKGS["jax"], *args)
    return got


# ---------------------------------------------------------------------------
# Fabric: link derivation + deterministic routing.
# ---------------------------------------------------------------------------

def _fabric_case(core, net, faults, spec):
    topo = _topo(core, spec)
    fab = net.build_fabric(topo)
    n = topo.num_devices
    routes = {(i, j): fab.route(i, j) for i in range(n) for j in range(n)}
    for (i, j), r in routes.items():
        assert len(r) == topo.dist(i, j)
        if r and not fab.links[r[0]].shared:
            assert fab.links[r[0]].src == i and fab.links[r[-1]].dst == j
            for a, b in zip(r, r[1:]):
                assert fab.links[a].dst == fab.links[b].src
    dead = frozenset({0})
    avoid = {(i, j): fab.route_avoiding(i, j, dead)
             for i in range(n) for j in range(n)}
    return (fab.describe(), [(l.src, l.dst, l.twin, l.shared)
                             for l in fab.links], routes, avoid,
            fab.diameter())


@pytest.mark.parametrize("spec", ALL_TOPOS,
                         ids=lambda s: f"{s[0]}{s[1]}")
def test_fabric_routes_match_jax(spec):
    _both(_fabric_case, spec)


def test_route_cost_and_lambda_crosscheck():
    def case(core, net, faults):
        cluster = core.fpga_ring_cluster(6)
        fab = net.cluster_fabric(cluster)
        costs = [[fab.route_cost(i, j, 512.0) for j in range(6)]
                 for i in range(6)]
        for i in range(6):
            for j in range(6):
                assert costs[i][j] == pytest.approx(
                    cluster.comm_cost(i, j, 512.0), abs=1e-12)
        topo, t = core.Ring(4), core.topology
        traffic = [(i, j, 512.0) for i in range(4) for j in range(4)
                   if i != j]
        res = net.lambda_crosscheck(
            net.build_fabric(topo, t.ETHERNET_100G),
            net.build_fabric(topo, t.PCIE_GEN3X16), traffic)
        assert res["ratio"] == pytest.approx(12.5, abs=1e-9)
        return costs, res
    _both(case)


# ---------------------------------------------------------------------------
# Transport: contention, backpressure, conservation, latency, flows.
# ---------------------------------------------------------------------------

def _contended_link(core, net, faults):
    fab = net.build_fabric(core.DaisyChain(2))
    solo = net.FabricTransport(fab, _cfg(core, net))
    solo.submit(0, 0, 1, 8 * 64, 0)
    solo_done, solo_sweeps = _run(solo)
    both = net.FabricTransport(fab, _cfg(core, net))
    both.submit(0, 0, 1, 8 * 64, 0)
    both.submit(1, 0, 1, 8 * 64, 0)
    done, both_sweeps = _run(both)
    assert both_sweeps >= 2 * solo_sweeps - 1
    assert abs(done[0][1] - done[1][1]) == 1        # both message ids
    return solo_done, done, _counters(solo), _counters(both)


def _credit_backpressure(core, net, faults):
    fab = net.build_fabric(core.DaisyChain(3))
    tr = net.FabricTransport(fab, _cfg(core, net, budget_flits=2, credits=2))
    l01 = fab.route(0, 2)[0]
    tr.submit(0, 0, 2, 32 * 64, 0)
    tr.submit(1, 1, 2, 32 * 64, 0)
    done = _run(tr)
    assert tr.counters[l01].stalled_flits > 0
    assert tr.counters[l01].peak_queue <= tr.config.link_credits
    return done, _counters(tr)


def _ring_conservation(core, net, faults):
    fab = net.build_fabric(core.Ring(4))
    tr = net.FabricTransport(fab, _cfg(core, net, mtu=100))
    payloads = [(0, 2, 1234), (1, 3, 999), (3, 0, 100), (2, 1, 4001)]
    for ch, (s, d, n) in enumerate(payloads):
        tr.submit(ch, s, d, n, 0)
    done = _run(tr)
    assert tr.total_delivered_bytes == sum(n for _, _, n in payloads)
    assert sum(c.bytes for c in tr.counters) == sum(
        n * fab.hops(s, d) for s, d, n in payloads)
    assert sum(c.flits for c in tr.counters) == sum(
        tr.config.flits_for(n) * fab.hops(s, d) for s, d, n in payloads)
    return done, _counters(tr), tr.total_delivered_bytes


def _hop_latency(core, net, faults):
    fab = net.build_fabric(core.DaisyChain(3))
    base = _cfg(core, net)
    lat = dataclasses.replace(base, hop_latency=True)
    eth = core.topology.ETHERNET_100G
    delay = math.ceil(eth.latency_s / base.sweep_time_s)
    assert delay > 1 and lat.hop_delay(eth.latency_s) == 1 + delay
    assert base.hop_delay(eth.latency_s) == 1

    def first_delivery(cfg, dst):
        tr = net.FabricTransport(fab, cfg)
        tr.submit(0, 0, dst, cfg.mtu_bytes, 0)
        done, _ = _run(tr)
        return done[0][0]
    sweeps = {(name, dst): first_delivery(cfg, dst)
              for name, cfg in (("base", base), ("lat", lat))
              for dst in (1, 2)}
    assert sweeps["lat", 1] - sweeps["base", 1] == delay
    assert sweeps["lat", 2] - sweeps["base", 2] == 2 * delay
    return sweeps


def _weighted_flows(core, net, faults):
    fab = net.build_fabric(core.DaisyChain(2))
    tr = net.FabricTransport(fab, _cfg(core, net),
                             flow_weights={0: 2.0, 1: 1.0})
    flits = 30
    tr.submit(0, 0, 1, flits * 64, 0, flow=0)
    tr.submit(1, 0, 1, flits * 64, 0, flow=1)
    link = fab.route(0, 1)[0]
    s, heavy_done, light_flits = 0, None, None
    while tr.active:
        for _, ch in tr.step(s):
            if ch == 0 and heavy_done is None:
                heavy_done = s
                light_flits = tr.counters[link].flow_flits.get(1, 0)
        s += 1
        assert s < 10_000
    assert heavy_done is not None and tr.flow_active(0) is False
    assert abs(light_flits - flits / 2) <= 2
    c = tr.counters[link]
    assert c.flow_flits[0] == c.flow_flits[1] == flits
    assert sum(c.flow_bytes.values()) == c.bytes
    return heavy_done, light_flits, s, _counters(tr)


def _flow_attribution(core, net, faults):
    fab = net.build_fabric(core.Ring(4))
    tr = net.FabricTransport(fab, _cfg(core, net, mtu=100),
                             flow_weights={0: 1.0, 1: 3.0})
    payloads = [(0, 2, 1234, 0), (1, 3, 999, 1), (3, 0, 100, 0),
                (2, 1, 4001, 1)]
    for ch, (s, d, n, f) in enumerate(payloads):
        tr.submit(ch, s, d, n, 0, flow=f)
    done = _run(tr)
    for c in tr.counters:
        assert sum(c.flow_bytes.values()) == c.bytes
        assert sum(c.flow_flits.values()) == c.flits
    for f in (0, 1):
        assert tr.flow_link_bytes(f) == sum(
            n * fab.hops(s, d) for s, d, n, g in payloads if g == f)
    return done, _counters(tr), [tr.flow_link_bytes(f) for f in (0, 1)]


def _cancel_flow(core, net, faults):
    fab = net.build_fabric(core.DaisyChain(3))

    def mk():
        return net.FabricTransport(fab, _cfg(core, net),
                                   flow_weights={0: 1.0, 1: 1.0})
    solo = mk()
    solo.submit(1, 0, 2, 20 * 64, 0, flow=1)
    _, solo_sweeps = _run(solo)
    tr = mk()
    tr.submit(0, 0, 2, 20 * 64, 0, flow=0)
    tr.submit(1, 0, 2, 20 * 64, 0, flow=1)
    early = [tr.step(s) for s in range(3)]
    cancelled = tr.cancel_flow(0)
    assert cancelled and not tr.flow_active(0) and tr.flow_active(1)
    done, end = _run(tr, start=3)
    assert [ch for _, _, ch in done] == [1]
    assert end <= solo_sweeps + 3
    assert tr.flow_link_bytes(1) == solo.flow_link_bytes(1)
    assert tr.flow_link_bytes(0) > 0
    for c in tr.counters:
        assert sum(c.flow_bytes.values()) == c.bytes
    return early, cancelled, done, end, _counters(tr), tr.cancelled_bytes


def _rival_contention(core, net, faults):
    """test_fifo_order_fixed's traffic: one channel's messages against a
    rival's on a shared link (the completion sweeps are compared with the
    JAX package's; their order is not asserted)."""
    fab = net.build_fabric(core.DaisyChain(3))
    tr = net.FabricTransport(fab, _cfg(core, net, 2, 64, 4))
    sizes = [1000, 64, 333]
    for i in range(5):
        tr.submit(0, 0, 2, sizes[i % 3], 0)
        tr.submit(1, 1, 2, sizes[(i + 1) % 3], 0)
    done = tr.drain(0)
    assert sorted(ch for _, ch in done) == [0] * 5 + [1] * 5
    return sorted(done), _counters(tr)


def _flow_weights_validation(core, net, faults):
    fab = net.build_fabric(core.DaisyChain(2))
    with pytest.raises(ValueError):
        net.FabricTransport(fab, _cfg(core, net), flow_weights={0: 0.0})
    tr = net.FabricTransport(fab, _cfg(core, net), flow_weights={0: 1.0})
    with pytest.raises(ValueError):
        tr.submit(0, 0, 1, 64, 0, flow=7)
    return True


@pytest.mark.parametrize("case", [
    _contended_link, _credit_backpressure, _ring_conservation, _hop_latency,
    _weighted_flows, _flow_attribution, _cancel_flow, _rival_contention,
    _flow_weights_validation], ids=lambda f: f.__name__.strip("_"))
def test_transport_case_matches_jax(case):
    _both(case)


def _conservation(core, net, faults, topo_idx, payloads, mtu, credits,
                  budget, fault_model=None):
    """check_fabric_conservation's body (and, with ``fault_model`` =
    ``(drop, corrupt, seed, down)``, the lossy case of
    check_trace_net_conservation without its tracer)."""
    topo = _topo(core, CONS_TOPOS[topo_idx % len(CONS_TOPOS)])
    n = topo.num_devices
    fab = net.build_fabric(topo)
    fm = None
    if fault_model is not None:
        drop, corrupt, seed, down = fault_model
        fm = faults.FaultModel(
            seed=seed, default=faults.LinkFaults(drop=drop, corrupt=corrupt,
                                                 down=tuple(down)),
            fail_threshold=None)
    tr = net.FabricTransport(fab, _cfg(core, net, budget, mtu, credits),
                             faults=fm)
    routed = []
    for ch, (s, d, nb) in enumerate(payloads):
        s, d = s % n, d % n
        if s == d:
            continue
        tr.submit(ch, s, d, nb, 0)
        routed.append((s, d, nb))
    done = tr.drain(0)
    assert tr.total_delivered_bytes == sum(nb for _, _, nb in routed)
    assert len(done) == len(routed)
    if fm is None:
        assert sum(c.bytes for c in tr.counters) == sum(
            nb * fab.hops(s, d) for s, d, nb in routed)
        assert sum(c.flits for c in tr.counters) == sum(
            tr.config.flits_for(nb) * fab.hops(s, d) for s, d, nb in routed)
        for li in range(len(fab.links)):
            assert tr.utilization(li) <= 1.0 + 1e-12
    else:
        assert tr.arq_books_closed()
        assert tr.goodput_hop_bytes_total() == sum(c.bytes
                                                   for c in tr.counters)
    return sorted(done), _counters(tr)


@pytest.mark.parametrize("args", [
    (1, [(0, 2, 1234), (1, 3, 999), (3, 0, 100), (2, 2, 64)], 100, 4, 2),
    (3, [(0, 1, 1), (2, 0, 4999)], 32, 1, 1),
    (1, [(0, 2, 1234), (1, 3, 999), (3, 0, 100)], 100, 4, 2,
     (0.0, 0.0, 0, ())),
    (1, [(0, 2, 2000), (2, 0, 4999)], 32, 2, 1, (0.3, 0.1, 7, ((0, 3),))),
], ids=["ring", "bus", "ring-faults-off", "ring-lossy-down"])
def test_conservation_case_matches_jax(args):
    _both(_conservation, *args)


@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(topo_idx=st.integers(min_value=0, max_value=len(CONS_TOPOS) - 1),
       payloads=st.lists(
           st.tuples(st.integers(min_value=0, max_value=7),
                     st.integers(min_value=0, max_value=7),
                     st.integers(min_value=1, max_value=5000)),
           min_size=1, max_size=8),
       mtu=st.sampled_from([32, 64, 100, 256]),
       credits=st.integers(min_value=1, max_value=6),
       budget=st.integers(min_value=1, max_value=4))
def test_conservation_property_matches_jax(topo_idx, payloads, mtu, credits,
                                           budget):
    _both(_conservation, topo_idx, payloads, mtu, credits, budget)


def _link_death(core, net, faults):
    """A permanent link death mid-transfer: route repair delivers every
    byte, and the reclassified crossings land in the retransmit column."""
    fab = net.build_fabric(core.Ring(4))
    dead = {li for li, l in enumerate(fab.links) if (l.src, l.dst) == (0, 1)}
    fm = faults.FaultModel(
        seed=3, links={li: faults.LinkFaults(down=((2, None),))
                       for li in dead}, fail_threshold=3)
    tr = net.FabricTransport(fab, _cfg(core, net, 1, 64, 2), faults=fm)
    tr.submit(0, 0, 1, 4000, 0)
    done = tr.drain(0)
    assert tr.total_delivered_bytes == 4000
    assert dead <= set(tr.dead_links)
    return sorted(done), _counters(tr), sorted(tr.dead_links)


def _weighted_fault_attribution(core, net, faults, seed, w, drop):
    fab = net.build_fabric(core.DaisyChain(2))
    fm = faults.FaultModel(seed=seed, default=faults.LinkFaults(drop=drop),
                           fail_threshold=None, backoff_base=1,
                           backoff_cap=1)
    tr = net.FabricTransport(fab, _cfg(core, net, 2, 64, 8),
                             flow_weights={0: float(w), 1: 1.0}, faults=fm)
    msgs = 24
    for _ in range(msgs):
        tr.submit(0, 0, 1, 64, 0, flow=0)
        tr.submit(1, 0, 1, 64, 0, flow=1)
    link = fab.route(0, 1)[0]
    sweep, snap = 0, None
    while tr.active:
        tr.step(sweep)
        c = tr.counters[link]
        if snap is None and c.attempt_flits >= 30:
            snap = {f: c.flow_flits.get(f, 0)
                    + c.flow_retransmit_flits.get(f, 0) for f in (0, 1)}
        sweep += 1
        assert sweep < 100_000
    assert tr.total_delivered_bytes == 2 * msgs * 64
    for c in tr.counters:
        assert sum(c.flow_bytes.values()) == c.bytes
        assert sum(c.flow_retransmit_bytes.values()) == c.retransmit_bytes
        assert sum(c.flow_retransmit_flits.values()) == c.retransmit_flits
        assert sum(c.flow_backoff_sweeps.values()) == c.backoff_sweeps
        assert sum(c.flow_arq_stalls.values()) == c.arq_stalls
    total = snap[0] + snap[1]
    assert abs(snap[1] - total / (w + 1.0)) <= 2
    return snap, sweep, _counters(tr), [tr.flow_fault_totals(f)
                                        for f in (0, 1)]


def _kill_peer(core, net, faults, topo_idx, kill_after, nbytes, mtu,
               credits):
    fab = net.build_fabric(_topo(core, CONS_TOPOS[topo_idx]))
    tr = net.FabricTransport(fab, _cfg(core, net, 2, mtu, credits),
                             flow_weights={0: 1.0, 1: 1.0})
    tr.submit(0, 0, 1, nbytes, 0, flow=0)
    tr.submit(1, 0, 1, nbytes, 0, flow=1)
    sweep, done = 0, []
    while sweep < kill_after and tr.active:
        done += [(sweep, *d) for d in tr.step(sweep)]
        sweep += 1
    tr.cancel_flow(0)
    while tr.active:
        done += [(sweep, *d) for d in tr.step(sweep)]
        sweep += 1
        assert sweep < 100_000
    assert tr.cancelled_flow_bytes.get(1, 0) == 0
    assert sum(tr.cancelled_flow_bytes.values()) == tr.cancelled_bytes
    assert tr.flow_fault_totals(1) == {
        "retransmit_bytes": 0, "retransmit_flits": 0, "backoff_sweeps": 0,
        "arq_stalls": 0}
    assert any(ch == 1 for _, _, ch in done)
    return sorted(done), _counters(tr), dict(tr.cancelled_flow_bytes)


@pytest.mark.parametrize("case,args", [
    (_link_death, ()),
    (_weighted_fault_attribution, (3, 2, 0.1)),
    (_weighted_fault_attribution, (7, 3, 0.2)),
    (_weighted_fault_attribution, (0, 1, 0.0)),
    (_kill_peer, (1, 3, 4000, 64, 2)),
    (_kill_peer, (0, 0, 1, 32, 1)),
], ids=["link-death", "attribution-3-2", "attribution-7-3",
        "attribution-0-1", "kill-peer-ring", "kill-peer-chain"])
def test_fault_case_matches_jax(case, args):
    _both(case, *args)


# ---------------------------------------------------------------------------
# Congestion feedback (the compiler pass) and the projection.
# ---------------------------------------------------------------------------

def _hot_bus(core, net, faults):
    g = core.TaskGraph("hotbus")
    lut = {"a": 350e3, "b": 350e3, "c": 150e3, "d": 150e3}
    for name, l in lut.items():
        g.add_task(core.Task(name, core.ResourceProfile({"LUT": l})))
    g.add_channel("a", "b", 4096, bytes_per_step=65536.0)
    g.add_channel("b", "c", 64, bytes_per_step=8.0)
    g.add_channel("c", "d", 4096, bytes_per_step=65536.0)
    return g, core.Cluster(core.ALVEO_U55C, core.Bus(2)), dict(
        balance_kind="LUT", balance_tol=0.1)


def _forced_hot(core, net, faults):
    g = core.TaskGraph("forced-hot")
    for name in ("a", "b"):
        g.add_task(core.Task(name, core.ResourceProfile({"LUT": 450e3})))
    g.add_channel("a", "b", 4096, bytes_per_step=65536.0)
    return g, core.Cluster(core.ALVEO_U55C, core.Bus(2)), {}


def _cool(core, net, faults):
    g = core.TaskGraph("cool")
    for name in ("x", "y"):
        g.add_task(core.Task(name, core.ResourceProfile({"LUT": 700e3})))
    g.add_channel("x", "y", 8, bytes_per_step=1.0)
    return g, core.fpga_ring_cluster(2), {}


@pytest.mark.parametrize("build", [_hot_bus, _forced_hot, _cool],
                         ids=["hot-bus", "uniform-calibration", "cool"])
def test_congestion_feedback_matches_jax(build):
    out = {}
    for name, opts_cls, comp in (("port", CompileOptions, compile),
                                 ("jax", JaxOptions, jax_compile)):
        core, net, faults = PKGS[name]
        g, cluster, kw = build(core, net, faults)
        design = comp(g, cluster, opts_cls(
            fabric=net.cluster_fabric(cluster),
            passes=("normalize_units", "partition", "congestion_feedback"),
            **kw))
        out[name] = (dict(design.pass_record("congestion_feedback").detail),
                     design.partition.assignment,
                     design.partition.stats.method,
                     design.congestion.summary())
    assert out["port"] == out["jax"]
    detail, assign, method, cong = out["port"]
    if build is _hot_bus:
        assert detail["repartitioned"] and method.endswith("-congested")
        assert (detail["max_utilization_after"]
                < detail["max_utilization_before"])
        assert assign["a"] == assign["b"] != assign["c"] == assign["d"]
        assert cong["max_utilization"] == pytest.approx(
            detail["max_utilization_after"])
    elif build is _forced_hot:
        assert detail["calibration_uniform"] and detail["retries"] == 0
        assert not detail["repartitioned"]
    else:
        assert not detail["repartitioned"]
        assert not method.endswith("-congested")


def test_calibrated_pair_cost_matches_jax():
    def case(core, net, faults):
        fab = net.cluster_fabric(core.fpga_ring_cluster(4))
        g = core.TaskGraph("two")
        for name in ("u", "v"):
            g.add_task(core.Task(name, core.ResourceProfile({"LUT": 1.0})))
        g.add_channel("u", "v", 4096, bytes_per_step=65536.0)
        report = net.project(g, {"u": 0, "v": 1}, fab)
        pair = net.calibrated_pair_cost(fab, report, threshold=0.75)
        base = core.topology.lam(core.topology.ETHERNET_100G)
        assert pair[0, 1] > base and pair[2, 3] == pytest.approx(base)
        return report.summary(), pair.tolist()
    _both(case)


# ---------------------------------------------------------------------------
# The executor's fabric path.
# ---------------------------------------------------------------------------

SPECS = {"stencil": {"h": 32, "w": 32, "stage_iters": 2, "streams": 2},
         "pagerank": {"n_nodes": 256, "n_edges": 2048, "iters": 4},
         "knn": {"n": 512, "dim": 8, "q": 8, "k": 5, "streams": 2},
         "cnn": {"h": 8, "w": 8, "cin": 4, "cout_per_col": 2,
                 "streams": 2}}


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("app", ["stencil", "pagerank"])
def test_ring4_fabric_matches_ideal_and_jax(app):
    port, ref = fabric_designs(app, 4)
    assert (dict(port.pass_record("congestion_feedback").detail)
            == dict(ref.pass_record("congestion_feedback").detail))
    assert port.partition.assignment == ref.partition.assignment
    via_net = port.execute(SPECS[app], device="cpu")
    ideal = execute(port, inputs=SPECS[app], device="cpu", fabric=None)
    assert torch.equal(_bits(via_net.outputs), _bits(ideal.outputs))
    rep = via_net.report
    assert all(rep.agreement().values()) and rep.used_fabric
    assert rep.net_link_bytes == rep.net_hop_weighted_bytes > 0
    assert rep.net_submitted_bytes == sum(c.net_delivered_bytes
                                          for c in rep.channels)
    assert rep.measured_route_comm_cost == pytest.approx(
        port.partition.comm_cost, rel=1e-9)
    assert rep.net_model_s > 0 and ideal.report.net_model_s == 0.0
    want = jax_execute(ref, inputs=SPECS[app]).report
    assert rep.sweeps == want.sweeps
    assert rep.summary()["net"] == want.summary()["net"]
    assert rep.agreement() == want.agreement()
    assert rep.task_congestion_waits == want.task_congestion_waits
    assert port.summary()["net"] == ref.summary()["net"]


@pytest.mark.parametrize("app", ["knn", "cnn"])
def test_ring2_fabric_matches_ideal(app):
    port, _ = fabric_designs(app, 2)
    via_net = port.execute(SPECS[app], device="cpu")
    ideal = execute(port, inputs=SPECS[app], device="cpu", fabric=None)
    got, want = via_net.outputs, ideal.outputs
    if app == "knn":
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    assert torch.equal(_bits(got), _bits(want))
    assert all(via_net.report.agreement().values())
    assert via_net.report.net_link_bytes == \
        via_net.report.net_hop_weighted_bytes > 0


def test_fabric_with_faults_matches_jax():
    """A lossy fabric (drops and a down window): ARQ keeps the outputs
    bit-identical to the ideal path, and every counter equals JAX's."""
    port, ref = fabric_designs("stencil", 4)
    spec = SPECS["stencil"]
    fm = {name: faults.FaultModel(
        seed=5, default=faults.LinkFaults(drop=0.2, down=((3, 9),)),
        fail_threshold=None)
        for name, (_, _, faults) in PKGS.items()}
    got = execute(port, inputs=spec, device="cpu", faults=fm["port"])
    want = jax_execute(ref, inputs=spec, faults=fm["jax"])
    ideal = execute(port, inputs=spec, device="cpu", fabric=None)
    assert torch.equal(_bits(got.outputs), _bits(ideal.outputs))
    rep = got.report
    assert all(rep.agreement().values())
    assert rep.net_retransmit_bytes_total > 0
    assert rep.net_goodput_hop_bytes == want.report.net_goodput_hop_bytes
    assert (rep.net_retransmit_bytes_total
            == want.report.net_retransmit_bytes_total)
    assert rep.sweeps == want.report.sweeps
    assert rep.summary()["net"] == want.report.summary()["net"]


def _net_config(core, net, faults, kind):
    if kind == "hop_latency":
        return net.NetConfig(hop_latency=True)
    if kind == "small_flits":
        # test_exec_channels.py's contention config: one 64 B flit a sweep
        # per Ethernet link and two credits, so hops stall on credits.
        return _cfg(core, net, budget_flits=1, mtu=64, credits=2)
    # Faults given through the config rather than execute(faults=).
    return net.NetConfig(faults=faults.FaultModel(
        seed=7, default=faults.LinkFaults(drop=0.1, corrupt=0.05),
        fail_threshold=None))


@pytest.mark.parametrize("kind", ["hop_latency", "small_flits",
                                  "config_faults"])
@pytest.mark.parametrize("app", ["stencil", "pagerank"])
def test_fabric_net_config_matches_jax(app, kind):
    """``execute(net_config=)`` with a non-default NetConfig: the ideal
    path's bits, and every link counter, sweep and wait equal to JAX's."""
    port, ref = fabric_designs(app, 4)
    spec = SPECS[app]
    cfg = {name: _net_config(*mods, kind) for name, mods in PKGS.items()}
    got = execute(port, inputs=spec, device="cpu", net_config=cfg["port"])
    want = jax_execute(ref, inputs=spec, net_config=cfg["jax"]).report
    ideal = execute(port, inputs=spec, device="cpu", fabric=None)
    assert torch.equal(_bits(got.outputs), _bits(ideal.outputs))
    rep = got.report
    assert all(rep.agreement().values()) and rep.used_fabric
    assert rep.sweeps == want.sweeps
    assert rep.summary()["net"] == want.summary()["net"]
    assert rep.task_congestion_waits == want.task_congestion_waits
    if kind == "small_flits" and app == "pagerank":
        # The router's flows share ring links; stencil's do not.
        assert sum(l.stalled_flits for l in rep.congestion.links) > 0
    if kind == "config_faults":
        assert rep.net_retransmit_bytes_total > 0
    default = execute(port, inputs=spec, device="cpu").report
    assert rep.sweeps != default.sweeps


def test_fabric_must_span_the_cluster():
    port, _ = fabric_designs("stencil", 4)
    with pytest.raises(ValueError, match="fabric spans"):
        execute(port, inputs=SPECS["stencil"], device="cpu",
                fabric=tnet.cluster_fabric(tcore.fpga_ring_cluster(2)))


def test_net_smoke_writes_its_record(tmp_path):
    out = tmp_path / "net.json"
    assert net_smoke.main(["--app", "pagerank", "--device", "cpu",
                           "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["bit_identical"] and all(rec["agreement"].values())
    assert rec["parity_max_err"] <= rec["atol"] == 1e-5
    assert rec["fabric"]["topology"] == "mesh2d"
    assert rec["congestion"]["total_link_bytes"] > 0
    assert JAX_APPS["pagerank"].build_graph(4).name == \
        APPS["pagerank"].build_graph(4).name
