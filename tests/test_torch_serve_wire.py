"""The port's serving front-end on the CPU (`cpr_tpu_torch.serve`:
scheduler, wire protocol, ServeServer), in process, against cpr_tpu's.

  * the scheduler cases of tests/test_serve.py:276-346 on the port's
    LaneScheduler;
  * `pack_frame` bytes equal the reference's, and frames read back;
  * a ServeServer on the CPU (port 0), driven by the reference's
    ServeClient and by the port's: a scripted and a `ppo` (a snapshot
    the JAX package exported) `episode.run`, an interactive episode
    stepped to its end, `netsim.query`, stats and a drain; each seeded
    episode replays `rollout(PRNGKey(seed))`;
  * `mdp.solve_grid`, the exact `break_even.revenue` and
    `netsim.attack_sweep` answer from the port's modules;
  * admission control sheds in band on a full queue;
  * a drain with executor work in flight never hangs a blocking client.

Every wait is bounded (socket timeouts, `join(timeout=)`).
"""

from __future__ import annotations

import asyncio
import queue
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpr_tpu.serve import protocol as jwire
from cpr_tpu.serve.protocol import ServeClient as JClient
from cpr_tpu.train import driver as jdriver
from cpr_tpu.train.ppo import ActorCritic as JNet
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry
from cpr_tpu_torch.params import make_params
from cpr_tpu_torch.serve import LaneScheduler, ResidentEngine, ServeClient
from cpr_tpu_torch.serve import protocol as wire
from cpr_tpu_torch.serve.scheduler import QueueFull
from cpr_tpu_torch.serve.server import ServeServer
from cpr_tpu_torch.train import driver as tdriver

MAX_STEPS = 16
N_LANES = 4
BURST = 8
TIMEOUT = 60.0


# -- scheduler -----------------------------------------------------------------

def test_scheduler_backfill_and_occupancy():
    sched = LaneScheduler(2)
    a, b, c = object(), object(), object()
    assert sched.enqueue(a) == 0 and sched.enqueue(b) == 1
    assert sched.enqueue(c) == 2
    assert sched.place() == [(0, a), (1, b)]
    assert sched.occupancy() == 1.0 and sched.n_queued() == 1
    assert sched.place() == []
    assert sched.retire(0) is a
    assert sched.place() == [(0, c)]
    assert sched.assigned() == {0: c, 1: b}
    assert sched.cancel(a) is False
    assert set(sched.drain()) == {b, c}
    assert sched.n_assigned() == 0 and sched.n_queued() == 0
    with pytest.raises(ValueError):
        LaneScheduler(0)


def test_scheduler_priority_ordering_and_cancel_edge_cases():
    sched = LaneScheduler(2, max_queued=4)
    a, b, c, d = object(), object(), object(), object()
    assert sched.enqueue(a, priority=2) == 0
    assert sched.enqueue(b, priority=1) == 0
    assert sched.enqueue(c, priority=1) == 1
    assert sched.enqueue(d, priority=0) == 0
    assert sched.place() == [(0, d), (1, b)]
    assert sched.cancel(object()) is False
    assert sched.cancel(d) is False
    assert sched.cancel(c) is True
    assert sched.n_queued() == 1
    assert sched.drain() == [a, d, b]
    for _ in range(4):
        sched.enqueue(object())
    with pytest.raises(QueueFull, match="capacity"):
        sched.enqueue(object())


def test_scheduler_tenant_quota_skips_without_blocking():
    sched = LaneScheduler(2, tenant_quota=1)
    a, b, c = object(), object(), object()
    sched.enqueue(a, tenant="t")
    sched.enqueue(b, tenant="t")
    sched.enqueue(c, tenant="u")
    assert sched.place() == [(0, a), (1, c)]
    assert sched.tenant_load("t") == 2 and sched.tenant_load("u") == 1
    assert sched.tenant_load(None) == 0
    assert sched.retire(0) is a
    assert sched.place() == [(0, b)]
    assert sched.tenant_load("t") == 1


# -- wire protocol -------------------------------------------------------------

FRAMES = [
    {"op": "hello"},
    {"op": "episode.run", "policy": "ppo#sample", "seed": 7,
     "priority": "batch", "tenant": None},
    {"ok": True, "obs": [0.0, 0.5, 1e-7, -3.25], "info": {"x": 1.5},
     "latency": {"total_s": 0.125}, "u": "ünïcode", "big": 2 ** 40},
    {"op": "learn.feed", "obs": [[[0.1, 0.2]]], "done": [[True, False]],
     "steps": 64},
]


@pytest.mark.parametrize("obj", FRAMES, ids=range(len(FRAMES)))
def test_pack_frame_bytes_equal_reference(obj):
    data = wire.pack_frame(obj)
    assert data == jwire.pack_frame(obj)

    async def run():
        r = asyncio.StreamReader()
        r.feed_data(data)
        r.feed_eof()
        return await wire.read_frame(r), await wire.read_frame(r)

    first, second = asyncio.run(run())
    assert first == obj and second is None

    async def torn():
        r = asyncio.StreamReader()
        r.feed_data(data[:3])
        r.feed_eof()
        return await wire.read_frame(r)

    with pytest.raises(wire.ProtocolError, match="mid-header"):
        asyncio.run(torn())


# -- the server ----------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    return registry.get_sized("nakamoto", MAX_STEPS)


@pytest.fixture(scope="module")
def params():
    return make_params(alpha=0.25, gamma=0.5, max_steps=MAX_STEPS)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A serving snapshot the JAX package exported, loaded by the port."""
    net = JNet(4, (8, 8))
    p = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(11),
                                          jnp.zeros((1, 4))))
    path = str(tmp_path_factory.mktemp("snap") / "ppo.msgpack")
    jdriver.export_policy_snapshot(path, p, protocol="nakamoto",
                                   n_actions=4, observation_length=4,
                                   hidden=[8, 8])
    return path


def spawn(server):
    """Run a ServeServer's loop in a daemon thread; (thread, port)."""
    ports: queue.Queue = queue.Queue()

    def run():
        async def amain():
            await server.start()
            ports.put(server.port)
            await server.serve_until_drained()

        asyncio.run(amain())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, ports.get(timeout=TIMEOUT)


def solo(env, params, seed, policy="honest"):
    return env.rollout(rnd.PRNGKey(seed, device="cpu"), params, policy,
                       MAX_STEPS + 1)


def test_server_end_to_end_both_clients(env, params, snapshot):
    policy, meta = tdriver.load_policy_snapshot(snapshot, device="cpu")
    engine = ResidentEngine(env, params, n_lanes=N_LANES, burst=BURST,
                            extra_policies={"ppo": policy}, device="cpu")
    engine.start()
    t, port = spawn(ServeServer(engine, heartbeat_s=0.2,
                                idle_sleep_s=0.001, protocol="nakamoto"))
    try:
        with JClient("127.0.0.1", port, timeout=TIMEOUT) as c:
            hello = c.request("hello")
            assert hello["ok"] and hello["n_lanes"] == N_LANES
            assert {"honest", "ppo"} <= set(hello["policies"])
            r = c.request("episode.run", policy="honest", seed=7)
            assert r["ok"] and r["seed"] == 7 and "_lane" not in r
            lat = r["latency"]
            assert abs(lat["total_s"] - lat["queue_wait_s"]
                       - lat["service_s"]) < 1e-6
            _, _, _, done, info = solo(env, params, 7)
            idx = int(np.argmax(done.numpy()))
            ep = r["episode"]
            assert ep["reward_attacker"] == float(
                info["episode_reward_attacker"][idx])
            assert ep["n_steps"] == int(info["episode_n_steps"][idx])
            # interactive: stepped with the policy the rollout runs
            o = c.request("episode.open", seed=11)
            assert o["ok"]
            obs, action, reward, done, _ = solo(env, params, 11)
            np.testing.assert_allclose(o["obs"], obs[0].numpy(),
                                       rtol=1e-6)
            for step in range(MAX_STEPS + 1):
                s = c.request("episode.step", session=o["session"],
                              action=int(action[step]))
                assert s["ok"] and s["reward"] == float(reward[step])
                assert s["done"] == bool(done[step])
                if s["done"]:
                    break
            assert s["done"]
            dead = c.request("episode.step", session=o["session"],
                             action=0)
            assert not dead["ok"] and "session" in dead["error"]
        with ServeClient("127.0.0.1", port, timeout=TIMEOUT) as c:
            r = c.request("episode.run", policy="ppo", seed=8)
            assert r["ok"] and r["policy"] == "ppo"
            _, _, _, done, info = solo(env, params, 8, policy)
            idx = int(np.argmax(done.numpy()))
            assert r["episode"]["reward_attacker"] == float(
                info["episode_reward_attacker"][idx])
            o = c.request("episode.open", seed=12)
            assert c.request("episode.close", session=o["session"])["ok"]
            bad = c.request("episode.run", policy="nope")
            assert not bad["ok"] and "unknown policy" in bad["error"]
            q = c.request("netsim.query", n_nodes=3, activations=40,
                          activation_delay=30.0, seed=1)
            assert q["ok"] and sum(q["activations"]) == 40, q
            be = c.request("break_even.revenue", protocol="nakamoto",
                           policy="honest", gamma=0.5, alpha=0.3)
            assert not be["ok"] and "item 9" in be["error"]
            stats = c.request("stats")
            assert stats["ok"] and stats["report"]["steps"] > 0
            assert stats["occupancy"] == 0.0
            assert stats["latencies"]["episode.run"]["count"] >= 2
            assert c.request("drain")["ok"]
    finally:
        t.join(TIMEOUT)
    assert not t.is_alive(), "server loop did not drain"


def test_server_query_endpoints_run_the_ports_modules(env, params,
                                                     tmp_path, monkeypatch):
    """`mdp.solve_grid`, the exact `break_even.*` and
    `netsim.attack_sweep` answer from the port's own modules on the
    engine's device, through their disk caches."""
    monkeypatch.setenv("CPR_TPU_CACHE", str(tmp_path))
    engine = ResidentEngine(env, params, n_lanes=N_LANES, burst=BURST,
                            device="cpu")
    engine.start()
    t, port = spawn(ServeServer(engine, heartbeat_s=0.2,
                                idle_sleep_s=0.001))
    try:
        with JClient("127.0.0.1", port, timeout=TIMEOUT) as c:
            grid = dict(protocol="fc16", cutoff=3, alphas=[0.3],
                        gammas=[0.5])
            first = c.request("mdp.solve_grid", **grid)
            assert first["ok"] and not first["cached"], first
            again = c.request("mdp.solve_grid", **grid)
            assert again["ok"] and again["cached"]
            assert again["revenue"] == first["revenue"]
            be = c.request("break_even.revenue", protocol="fc16",
                           mode="exact", gamma=0.5, cutoff=3, alpha=0.3)
            assert be["ok"] and be["revenue"] == [
                pytest.approx(np.asarray(first["revenue"]).ravel()[0])]
            sweep = c.request("netsim.attack_sweep", activations=30,
                              reps=1, alphas=[0.3], policies=["honest"])
            assert sweep["ok"] and sweep["rows"], sweep
            assert c.request("drain")["ok"]
    finally:
        t.join(TIMEOUT)
    assert not t.is_alive()


def test_admission_sheds_in_band(env, params):
    engine = ResidentEngine(env, params, n_lanes=N_LANES, burst=BURST,
                            device="cpu")
    engine.start()
    server = ServeServer(engine, heartbeat_s=5.0, idle_sleep_s=0.001,
                         max_queued=1)
    t, port = spawn(server)
    raw = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    try:
        with JClient("127.0.0.1", port, timeout=TIMEOUT) as c:
            held = [c.request("episode.open", seed=100 + i)["session"]
                    for i in range(N_LANES)]
            # one run parks in the queue behind the held lanes
            raw.sendall(wire.pack_frame(dict(op="episode.run",
                                             policy="honest", seed=3)))
            for _ in range(500):
                if c.request("stats")["queued"] >= 1:
                    break
                time.sleep(0.01)
            else:
                raise AssertionError("the parked run never queued")
            shed = c.request("episode.run", policy="honest", seed=4)
            assert not shed["ok"] and shed["shed"]
            assert shed["reason"] == "queue_full"
            assert shed["retry_after"] > 0
            for sid in held:
                assert c.request("episode.close", session=sid)["ok"]
            raw.settimeout(TIMEOUT)
            reply = jwire._decode(_read_frame(raw))
            assert reply["ok"] and reply["seed"] == 3
            stats = c.request("stats")
            assert stats["sheds"] == 1
            assert stats["shed_reasons"] == {"queue_full": 1}
            assert c.request("drain")["ok"]
    finally:
        raw.close()
        t.join(TIMEOUT)
    assert not t.is_alive()


def _read_frame(sock) -> bytes:
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            assert chunk, "server closed the connection"
            buf += chunk
        return buf

    (n,) = wire._HEADER.unpack(exact(4))
    return exact(n)


def test_drain_never_hangs_blocking_clients(env, params):
    """The op running on the executor finishes and gets its reply; the
    op queued behind it is cancelled and refused with `draining`."""
    engine = ResidentEngine(env, params, n_lanes=N_LANES, burst=BURST,
                            device="cpu")
    engine.start()
    server = ServeServer(engine, heartbeat_s=0.2, idle_sleep_s=0.001)
    entered, release = threading.Event(), threading.Event()
    calls = []

    def slow_query(req):
        calls.append(req)
        if len(calls) == 1:
            entered.set()
            assert release.wait(30.0)
        return dict(ok=True, n=len(calls))

    server._netsim_query = slow_query
    t, port = spawn(server)

    def query():
        with ServeClient("127.0.0.1", port, timeout=TIMEOUT) as c:
            return c.request("netsim.query")

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            fa = pool.submit(query)
            assert entered.wait(30.0)
            fb = pool.submit(query)
            with JClient("127.0.0.1", port, timeout=TIMEOUT) as c:
                for _ in range(500):
                    if c.request("stats")["exec_ops"] >= 2:
                        break
                    time.sleep(0.01)
                else:
                    raise AssertionError("second query never in flight")
                assert c.request("drain")["ok"]
            rb = fb.result(timeout=30)
            assert not rb.get("ok") and rb.get("draining"), rb
            release.set()
            ra = fa.result(timeout=30)
            assert ra.get("ok") and ra["n"] == 1, ra
    finally:
        release.set()
    t.join(TIMEOUT)
    assert not t.is_alive()
    assert len(calls) == 1
