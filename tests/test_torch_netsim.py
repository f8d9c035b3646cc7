"""The port's netsim (K12: the scan path and the Nakamoto event engine)
against `cpr_tpu.netsim` on the CPU.

Both engines get the same numpy-built topology (`convert.compiled_net`
of the JAX package's `CompiledNet`), seeds and activation delays; the
port runs its plain versions (`device="cpu"`). Integer outputs (head,
heights, rewards, node activations, steps, capacity counters) must be
equal; float64 times within TIME_RTOL relative. The scan path's mint
times are a running sum, which XLA:CPU adds in another order (up to a
few 1e-11 absolute on 10^4 draws), so an integer could differ where a
decision compared two times closer than that: each case prints the
smallest such gap of the plain run (`margin`), which is far above it.

The reference enters `jax.experimental.enable_x64()`, gone from jax
0.9.0; the `jax_x64` fixture stands in `jax.enable_x64(True)` for the
duration of a test (nothing in `cpr_tpu/` changes). The helpers here
serve test_torch_netsim_attack.py and test_torch_netsim_golden.py too.
"""

from __future__ import annotations

import io
import json

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from cpr_tpu import distributions as jdist
from cpr_tpu import netsim as jnetsim
from cpr_tpu import network as jnetwork
from cpr_tpu_torch import convert, netsim, network, telemetry
from cpr_tpu_torch import distributions as tdist
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.netsim import engine as E

# float64 times: the JAX package's and the port's differ by the summation
# order of the mint times (~1e-15 relative a term) and by log1p ULPs
TIME_RTOL = 1e-9
TIME_KEYS = ("sim_time", "progress", "on_chain")
INT_KEYS = ("head", "head_height", "n_blocks", "n_act", "node_act",
            "reward", "steps", "drop_q", "drop_p", "drop_b", "win_miss",
            "exhausted")


def enter_x64_standin():
    """Give jax.experimental the `enable_x64()` that cpr_tpu.netsim
    enters (jax 0.9.0 has only jax.enable_x64), for a script run."""
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run a few hundred small ops a step, which a
    thread pool only slows (and, beside the suite's parallel workers,
    oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def clique(n=5, ad=25.0, pd=1.0, delay=None):
    """The JAX package's symmetric clique, its links' delays replaced by
    `delay` (a cpr_tpu.distributions.Distribution) if given."""
    net = jnetwork.symmetric_clique(n, activation_delay=ad,
                                    propagation_delay=pd)
    if delay is not None:
        for nd in net.nodes:
            for ln in nd.links:
                ln.delay = delay
    return net


DELAYS = {"const": None, "exp": jdist.exponential(2.0),
          "uni": jdist.uniform(0.5, 3.0), "geo": jdist.geometric(0.4)}


def assert_clean(out, activations):
    """The reference's invariants of a healthy run (tests/test_netsim.py
    `_assert_clean`): no overflow, all activations accounted for, rewards
    summing to the head chain's height."""
    for key in ("drop_q", "drop_p", "drop_b", "win_miss"):
        assert not np.any(out[key]), (key, out[key])
    assert not np.any(out["exhausted"])
    assert np.all(out["node_act"].sum(axis=1) == activations)
    np.testing.assert_allclose(out["reward"].sum(axis=1), out["progress"],
                               rtol=1e-6)


def assert_parity(out, ref, what, keys=INT_KEYS):
    assert set(ref) <= set(out) | {"margin"}, set(ref) - set(out)
    for k in keys:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(ref[k]), err_msg=f"{what} {k}")
        assert np.asarray(out[k]).dtype == np.asarray(ref[k]).dtype, \
            (what, k, np.asarray(out[k]).dtype, np.asarray(ref[k]).dtype)
    for k in TIME_KEYS:
        np.testing.assert_allclose(out[k], ref[k], rtol=TIME_RTOL, atol=0,
                                   err_msg=f"{what} {k}")


def port_lanes(tcn, mode, A, seeds, delays, **kw):
    """The port's plain version with its margin: (outputs, margin)."""
    keys = E.lane_keys(seeds, "cpu")
    dl = torch.tensor(delays, dtype=torch.float64)
    eng = netsim.Engine(tcn, activations=A, mode=mode, device="cpu", **kw)
    if eng.mode == "scan":
        out = E.scan_plain(tcn, A, eng.lookback, keys, dl)
    else:
        out = E.event_plain(tcn, A, eng.B, eng.M, eng.F, eng.S, keys, dl)
    return out, float(out["margin"].min())


def run_both(jnet, mode, A, seeds, delays, **kw):
    """(the port's outputs as Engine.run gives them, the reference's, the
    port's smallest decision margin)."""
    jcn = jnetsim.compile_network(jnet)
    ref = jnetsim.Engine(jcn, activations=A, mode=mode, **kw).run(
        seeds, delays)
    out, margin = port_lanes(convert.compiled_net(jcn), mode, A, seeds,
                             delays, **kw)
    del out["margin"]
    return E.finish(out), ref, margin


SEEDS, LANE_DELAYS = [0, 1, 2, 3], [25.0, 25.0, 60.0, 60.0]


@pytest.mark.parametrize("delay", sorted(DELAYS))
def test_scan_matches_reference(delay):
    A = 500 if delay == "const" else 400
    out, ref, margin = run_both(clique(delay=DELAYS[delay]), "scan", A,
                                SEEDS, LANE_DELAYS)
    print(f"scan {delay}: smallest decision margin {margin:.3e} "
          f"(times up to {ref['sim_time'].max():.0f})")
    assert margin > TIME_RTOL * float(ref["sim_time"].max())
    assert_parity(out, ref, f"scan {delay}")
    if delay == "const":
        assert_clean(out, A)


def test_scan_lookback_window_loops():
    # a lookback above the warp width (K12-scan's slots loop) and below it
    for lookback in (8, 40):
        out, ref, _ = run_both(clique(delay=DELAYS["exp"]), "scan", 300,
                               SEEDS[:2], LANE_DELAYS[:2], lookback=lookback)
        assert_parity(out, ref, f"scan lookback {lookback}")


def test_event_simple_matches_reference():
    out, ref, margin = run_both(clique(), "event", 300, SEEDS, LANE_DELAYS)
    print(f"event simple: smallest decision margin {margin:.3e}")
    assert margin > TIME_RTOL * float(ref["sim_time"].max())
    assert_parity(out, ref, "event simple")
    assert_clean(out, 300)


def flooding_net():
    return jnetwork.random_regular(6, 3, activation_delay=25.0,
                                   delay=jdist.exponential(2.0), seed=3)


def test_event_flooding_matches_reference():
    out, ref, margin = run_both(flooding_net(), "event", 80, SEEDS[:3],
                                LANE_DELAYS[:3])
    print(f"event flooding: smallest decision margin {margin:.3e}")
    assert margin > TIME_RTOL * float(ref["sim_time"].max())
    assert_parity(out, ref, "event flooding")
    assert_clean(out, 80)


def test_event_small_queue_drops_as_reference():
    # capacities too small: the port drops and counts what the reference
    # does (a pending buffer of 1, a queue of 4 entries)
    out, ref, _ = run_both(flooding_net(), "event", 60, SEEDS[:2],
                           LANE_DELAYS[:2], queue_cap=4, pend_cap=1)
    assert np.any(ref["drop_q"]) and np.any(ref["drop_p"])
    assert_parity(out, ref, "event small capacities")


def test_scan_lane_matches_single_lane():
    """Lane i of a batched run is the same (seed, delay) run alone."""
    eng = netsim.Engine(network.symmetric_clique(
        5, activation_delay=50.0, propagation_delay=1.0), activations=300,
        device="cpu")
    batch = eng.run([0, 1, 2, 3], [40.0, 40.0, 160.0, 160.0])
    solo = eng.run([2], [160.0])
    for key in ("head_height", "progress", "sim_time"):
        assert batch[key][2] == solo[key][0], key
    np.testing.assert_array_equal(batch["reward"][2], solo["reward"][0])
    assert_clean(batch, 300)


def test_scan_matches_event_engine_stats():
    """The two modes describe the same process: on a constant-delay
    clique the orphan rates agree within sampling noise (their draws
    differ, so runs are equal only in distribution)."""
    net = network.symmetric_clique(5, activation_delay=25.0,
                                   propagation_delay=1.0)
    seeds, delays = netsim.grid([0, 1, 2, 3], [25.0])
    a = 800
    scan = netsim.Engine(net, activations=a, mode="scan",
                         device="cpu").run(seeds, delays)
    event = netsim.Engine(net, activations=a, mode="event",
                          device="cpu").run(seeds, delays)
    assert_clean(scan, a)
    assert_clean(event, a)
    orphan = [1.0 - o["progress"] / a for o in (scan, event)]
    gap = abs(float(orphan[0].mean()) - float(orphan[1].mean()))
    assert gap < 0.02, (gap, orphan)


def test_compile_network_planes_match_reference():
    for jnet in (clique(4, ad=30.0, pd=2.0), flooding_net(),
                 clique(delay=DELAYS["uni"])):
        jcn = jnetsim.compile_network(jnet)
        tnet = network.of_graphml(jnetwork.to_graphml(jnet))
        tcn = netsim.compile_network(tnet)
        for f in ("compute", "kind", "p0", "p1"):
            np.testing.assert_array_equal(getattr(tcn, f), getattr(jcn, f))
            assert getattr(tcn, f).dtype == getattr(jcn, f).dtype
        assert (tcn.n, tcn.activation_delay, tcn.flooding) == \
            (jcn.n, jcn.activation_delay, jcn.flooding)
        conv = convert.compiled_net(jcn)
        np.testing.assert_array_equal(conv.kind, tcn.kind)


def test_compile_network_rejections():
    with pytest.raises(ValueError, match="at least 2 nodes"):
        netsim.compile_network(network.Network(
            nodes=[network.NetNode(1.0)], activation_delay=1.0))
    bad = network.Network(
        nodes=[network.NetNode(0.5, [network.Link(1, tdist.discrete([1, 2]))]),
               network.NetNode(0.5, [network.Link(0, tdist.constant(1.0))])],
        activation_delay=1.0)
    with pytest.raises(ValueError, match="not 'discrete'"):
        netsim.compile_network(bad)
    with pytest.raises(ValueError, match="unknown dissemination"):
        netsim.compile_network(network.Network(
            nodes=network.symmetric_clique(
                3, activation_delay=1.0, propagation_delay=1.0).nodes,
            activation_delay=1.0, dissemination="telepathy"))
    geo = network.Network(
        nodes=[network.NetNode(0.5, [network.Link(1, tdist.geometric(0.5))]),
               network.NetNode(0.5, [network.Link(0, tdist.geometric(0.5))])],
        activation_delay=1.0)
    assert netsim.compile_network(geo).kind[0, 1] == \
        netsim.NETSIM_KINDS["geometric"]


def test_engine_validation(monkeypatch):
    net = network.symmetric_clique(5, activation_delay=50.0,
                                   propagation_delay=1.0)
    with pytest.raises(ValueError, match="supports protocols"):
        netsim.Engine(net, protocol="tailstorm", activations=100,
                      device="cpu")
    with pytest.raises(ValueError, match="k >= 1"):
        netsim.Engine(net, protocol="bk", k=0, activations=100,
                      device="cpu")
    with pytest.raises(ValueError, match="mode must be"):
        netsim.Engine(net, activations=100, mode="warp", device="cpu")
    with pytest.raises(ValueError, match="scan mode needs nakamoto"):
        netsim.Engine(net, protocol="bk", k=2, activations=100, mode="scan",
                      device="cpu")
    eng = netsim.Engine(net, activations=100, device="cpu")
    assert eng.mode == "scan"  # auto picks the fast path
    assert netsim.Engine(net, activations=100, mode="event",
                         device="cpu").mode == "event"
    with pytest.raises(ValueError, match="pair up"):
        eng.run([0, 1], [50.0])
    # the JAX package's other protocols run on the event engine (their
    # parity: test_torch_netsim_protocols.py); float32 clocks and meshes
    # are queued, each naming its ROADMAP item
    for proto, k in (("bk", 2), ("ethereum-byzantium", 1), ("spar", 4)):
        other = netsim.Engine(net, protocol=proto, k=k, activations=20,
                              device="cpu")
        assert other.mode == "event"
        out = other.run([0], [50.0])
        assert out["n_act"][0] == 20 and not out["exhausted"][0]
    with pytest.raises(NotImplementedError, match="item 11b"):
        netsim.Engine(net, activations=100, x64=False, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        netsim.Engine(net, activations=100, mesh=object(), device="cpu")
    # CPR_DEVICE_METRICS=1 (K17 ported): the run emits the reference's
    # netsim cells instead of raising
    monkeypatch.setenv("CPR_DEVICE_METRICS", "1")
    stream = io.StringIO()
    telemetry.configure(stream=stream)
    try:
        out = eng.run([0], [50.0])
    finally:
        telemetry.configure(None)
    (ev,) = [e for e in map(json.loads, stream.getvalue().splitlines())
             if e.get("name") == "device_metrics"]
    assert ev["scope"] == "netsim" and ev["protocol"] == "nakamoto"
    assert ev["metrics"]["steps"] == int(out["steps"].sum())
    for proto, k, scheme in (("nakamoto", 1, "constant"),
                             ("bk", 8, "block"), ("tailstorm", 8, "constant"),
                             ("bk", 8, "discount"), ("spar", 0, "constant"),
                             ("ethereum-whitepaper", 1, "")):
        assert netsim.supports(proto, k, scheme) == \
            jnetsim.supports(proto, k, scheme), (proto, k, scheme)
    assert netsim.SUPPORTED_PROTOCOLS == jnetsim.SUPPORTED_PROTOCOLS


def test_kernel_node_limit():
    big = network.symmetric_clique(33, activation_delay=50.0,
                                   propagation_delay=1.0)
    from cpr_tpu_torch import kernels
    cn = netsim.compile_network(big)
    # past 32 nodes the kernels hold two or more node slots a thread: a
    # 33-node clique is accepted, in its own launch counter
    E.check_kernel_nodes(cn.n, "K12-event")
    assert E.node_slots(cn.n) == 2
    assert E.kernel_name("K12-event", cn.n) == "K12-event-n64"
    assert E.kernel_name("K12-event", 32) == "K12-event"
    # the limit: 8 slots of 32 nodes, fewer where a lane's queue and
    # pending buffers outgrow a block's shared memory; one node past it
    # is refused by name, naming item 11b
    lane = netsim.Engine(cn, activations=40, mode="event",
                         device="cpu").kernel_lane()
    limit = E.kernel_node_limit(lane)
    assert limit == E.KERNEL_MAX_NODES == 256
    E.check_kernel_nodes(limit, "K12-event", lane)
    with pytest.raises(NotImplementedError,
                       match=r"K12-event .*at most 256 .*item 11b"):
        E.check_kernel_nodes(limit + 1, "K12-event", lane)
    queue = (11500, 8, 0)
    small = E.kernel_node_limit(queue)
    assert 0 < small < 256 and kernels.event_smem(
        11500, 8, E.node_slots(small + 1)) > kernels.SMEM_PER_BLOCK
    with pytest.raises(NotImplementedError, match=f"at most {small} .*11b"):
        E.check_kernel_nodes(small + 1, "K13", queue)
    # a queue entry's block field: 2^23 blocks at any node count
    E.check_kernel_nodes(10, "K12-event", lane, B=E.KERNEL_MAX_BLOCKS - 1)
    with pytest.raises(ValueError, match="block field"):
        E.check_kernel_nodes(10, "K12-event", lane, B=E.KERNEL_MAX_BLOCKS)
    # the plain version takes any N
    out = netsim.Engine(cn, activations=40, device="cpu").run([0], [50.0])
    assert out["node_act"].shape == (1, 33)
    keys = E.lane_keys([0], "cpu")
    with pytest.raises(ValueError, match="CUDA"):  # before any launch
        kernels.netsim_scan(cn, 10, 32, keys, torch.ones(1, dtype=torch.float64))


def test_grid_helper():
    ss, dd = netsim.grid([0, 1], [30.0, 60.0])
    assert ss == [0, 1, 0, 1]
    assert dd == [30.0, 30.0, 60.0, 60.0]
    assert (ss, dd) == jnetsim.grid([0, 1], [30.0, 60.0])


def test_lane_keys_are_64_bit_mode_keys():
    seeds = [0, 7, 2**32 + 5, -3, 2**40 + 11]
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jax.random.PRNGKey(s)) for s in seeds])
    np.testing.assert_array_equal(rnd.to_numpy_words(
        E.lane_keys(seeds, "cpu")), want)
    for s in seeds:
        np.testing.assert_array_equal(
            rnd.to_numpy_words(rnd.PRNGKey(s, "cpu", x64=True)),
            want[seeds.index(s)])


@pytest.mark.parametrize("shape", [(6, 5), (40, 3)])
def test_sample_delay_matrix_matches_reference(shape):
    rng = np.random.default_rng(shape[0])
    kind = rng.integers(0, 4, shape).astype(np.int32)
    p0 = rng.uniform(0.1, 1.2, shape)
    p1 = p0 + rng.uniform(0.0, 2.0, shape)
    with jax.enable_x64(True):
        key = jax.random.PRNGKey(11)
        want = np.asarray(jnetsim.sample_delay_matrix(
            key, jax.numpy.asarray(kind), jax.numpy.asarray(p0),
            jax.numpy.asarray(p1), jax.numpy.float64))
    got = netsim.sample_delay_matrix(
        rnd.PRNGKey(11, "cpu", x64=True), torch.from_numpy(kind),
        torch.from_numpy(p0), torch.from_numpy(p1)).numpy()
    assert got.dtype == np.float64
    # uniform and constant bit for bit; exponential and geometric through
    # log/log1p, which XLA:CPU evaluates within a few ULP of the port's
    # (up to 20 ULP seen on small values)
    exact = kind <= 1
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def test_distribution_samplers_match_reference():
    dists = [("constant", (2.5,)), ("uniform", (0.5, 3.0)),
             ("exponential", (1.5,)), ("geometric", (0.3,)),
             ("geometric", (1.0,)), ("discrete", (1.0, 3.0, 0.5))]
    for kind, params in dists:
        jd = jdist.Distribution(kind, params)
        td = tdist.Distribution(kind, params)
        assert td.to_string() == jd.to_string()
        assert tdist.of_string(jd.to_string()) == td
        assert td.ev == pytest.approx(jd.ev)
        for seed in range(6):
            want = np.asarray(jd.sample_jax(jax.random.PRNGKey(seed)))
            got = td.sample_torch(rnd.PRNGKey(seed, "cpu")).numpy()
            np.testing.assert_allclose(got, want, rtol=2e-7,
                                       err_msg=f"{kind} {seed}")
            assert got.dtype == np.float32


def test_network_constructors_match_reference(tmp_path):
    pairs = [
        (network.symmetric_clique(4, activation_delay=30.0,
                                  propagation_delay=2.0),
         jnetwork.symmetric_clique(4, activation_delay=30.0,
                                   propagation_delay=2.0)),
        (network.two_agents(alpha=0.3, activation_delay=60.0),
         jnetwork.two_agents(alpha=0.3, activation_delay=60.0)),
        (network.selfish_mining(alpha=0.3, gamma=0.5, defenders=3,
                                activation_delay=60.0, propagation_delay=1.0),
         jnetwork.selfish_mining(alpha=0.3, gamma=0.5, defenders=3,
                                 activation_delay=60.0,
                                 propagation_delay=1.0)),
        (network.random_regular(9, 4, activation_delay=25.0,
                                delay=tdist.exponential(2.0), seed=3),
         jnetwork.random_regular(9, 4, activation_delay=25.0,
                                 delay=jdist.exponential(2.0), seed=3)),
        (network.preferential_attachment(13, 2, distribution="uniform",
                                         seed=5),
         jnetwork.preferential_attachment(13, 2, distribution="uniform",
                                          seed=5)),
    ]
    for t, j in pairs:
        assert network.to_graphml(t) == jnetwork.to_graphml(j)
        assert network.topology_stats(t) == jnetwork.topology_stats(j)
        back = network.of_graphml(network.to_graphml(t))
        assert network.to_graphml(back) == network.to_graphml(t)
    paths = network.write_topology_batch(str(tmp_path / "t"), count=2, n=7)
    jpaths = jnetwork.write_topology_batch(str(tmp_path / "j"), count=2, n=7)
    assert [p.rsplit("/", 1)[1] for p in paths] == \
        [p.rsplit("/", 1)[1] for p in jpaths]
    for p, q in zip(paths, jpaths):
        assert open(p).read() == open(q).read()
    with pytest.raises(NotImplementedError, match="item 9"):
        network.simulate(pairs[0][0], activations=10)


def test_netsim_emits_span_and_event():
    """The port's telemetry: a netsim:compile span the first time a lane
    count runs, a netsim:run span each run and the typed `netsim` point
    event, with the JAX package's fields."""
    buf = io.StringIO()
    telemetry.configure(stream=buf)
    try:
        eng = netsim.Engine(network.symmetric_clique(
            5, activation_delay=50.0, propagation_delay=1.0),
            activations=200, device="cpu")
        for _ in range(2):
            eng.run([0], [60.0])
    finally:
        telemetry.configure()
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [e["counters"]["lanes"] for e in events
            if e.get("name") == "netsim:compile"] == [1]
    spans = [e for e in events if e.get("name") == "netsim:run"]
    assert len(spans) == 2
    points = [e for e in events if e.get("event") == "netsim"
              or e.get("name") == "netsim"]
    assert spans and points, events
    point = points[0]
    for field in ("protocol", "lanes", "activations", "steps", "drops"):
        assert field in json.dumps(point), (field, point)


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    net = network.symmetric_clique(3, activation_delay=50.0,
                                   propagation_delay=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        netsim.Engine(net, activations=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        netsim.AttackEngine(net, activations=10)


def test_kernel_wrappers_refuse_cpu_tensors():
    from cpr_tpu_torch import kernels
    cn = netsim.compile_network(network.symmetric_clique(
        3, activation_delay=50.0, propagation_delay=1.0))
    keys = E.lane_keys([0, 1], "cpu")
    dl = torch.full((2,), 50.0, dtype=torch.float64)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.netsim_scan(cn, 10, 32, keys, dl)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.netsim_event(cn, 10, 12, 256, 8, 100, keys, dl)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.netsim_attack(cn, 10, 12, 256, 8, 100, 12, keys, dl,
                              torch.full((2,), 0.3),
                              torch.zeros(2, dtype=torch.int32), True)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.threefry(keys, 2, 0, rnd.MODE_EXPONENTIAL64)
    assert kernels.launches == before
