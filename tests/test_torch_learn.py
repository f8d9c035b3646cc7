"""Port parity of the always-on learning loop (`cpr_tpu_torch.learn`:
the experience rings K15's plain twins, the feed codec, the learner)
against cpr_tpu's `learn/` on the CPU.

  * `record`/`consolidate` on the same numpy-seeded steps, with a ring
    that wraps and a lane that dies halfway (tests/test_learn.py:84-128),
    give the reference's rings and batches exactly; `step_keys` equals
    `vmap(jax.random.fold_in)` bit for bit;
  * the feed frames of a drained batch are byte for byte the
    reference's;
  * `Learner.ingest` of the same fed batch from the same params and key
    gives the reference learner's params within 1e-5, and
    `params_fingerprint` is equal for the same weights;
  * snapshots load in both directions, and a JAX-written one hot-swaps
    into the port's server.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.learn import buffer as jbuffer
from cpr_tpu.learn import feed as jfeed
from cpr_tpu.learn import learner as jlearner
from cpr_tpu.serve import protocol as jwire
from cpr_tpu.train import driver as jdriver
from cpr_tpu.train import ppo as jppo
from cpr_tpu_torch import convert
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.learn import buffer
from cpr_tpu_torch.learn import feed
from cpr_tpu_torch.learn import learner as tlearner
from cpr_tpu_torch.params import make_params as tmake
from cpr_tpu_torch.serve import protocol as wire
from cpr_tpu_torch.serve.engine import ResidentEngine
from cpr_tpu_torch.train import driver as tdriver
from cpr_tpu_torch.train import ppo as tppo

MAX_STEPS = 16
N_LANES = 4
BURST = 8


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def jax_keys(n):
    return jax.vmap(jax.random.PRNGKey)(jnp.arange(n, dtype=jnp.uint32))


def port_keys(n):
    words = np.zeros((n, 2), np.uint32)
    words[:, 1] = np.arange(n)
    return torch.from_numpy(words.view(np.int32))


def flat_of(params):
    return convert.actor_critic_from_flax(jax.tree.map(np.asarray, params),
                                          "cpu")


def record_both(L, C, D, live_plan, seed):
    """The same numpy-seeded steps into both packages' rings."""
    jexp = jbuffer.init_buffer(jax.vmap(jbuffer.experience_stream)(
        jax_keys(L)), C, D)
    texp = buffer.init_buffer(buffer.experience_stream(port_keys(L)), C, D)
    rng = np.random.default_rng(seed)
    for s in range(live_plan.shape[0]):
        obs = rng.normal(size=(L, D)).astype(np.float32)
        action = rng.integers(0, 3, L).astype(np.int32)
        reward = rng.normal(size=L).astype(np.float32)
        done = rng.random(L) < 0.3
        era = rng.normal(size=L).astype(np.float32)
        erd = rng.normal(size=L).astype(np.float32)
        pol = rng.integers(0, 5, L).astype(np.int32)
        jexp = jbuffer.record(
            jexp, jnp.asarray(live_plan[s]), jnp.asarray(obs),
            jnp.asarray(action), jnp.asarray(reward), jnp.asarray(done),
            {"episode_reward_attacker": jnp.asarray(era),
             "episode_reward_defender": jnp.asarray(erd)},
            jnp.asarray(pol))
        t = {k: torch.from_numpy(v) for k, v in dict(
            obs=obs, action=action, reward=reward, done=done, era=era,
            erd=erd, pol=pol).items()}
        buffer.record(texp, torch.from_numpy(live_plan[s]), t["obs"],
                      t["action"], t["reward"], t["done"],
                      {"episode_reward_attacker": t["era"],
                       "episode_reward_defender": t["erd"]}, t["pol"])
    jhost = jax.device_get(jexp)
    thost = {k: v.numpy() for k, v in texp.items()}
    return jhost, thost


def assert_same_batch(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_record_and_consolidate_match_reference():
    L, C, D = 3, 4, 2
    n_steps = 2 * C + 1
    live_plan = np.ones((n_steps, L), bool)
    live_plan[C:, 2] = False  # lane 2 dies halfway: its ring freezes
    jhost, thost = record_both(L, C, D, live_plan, seed=0)
    for k in (*jbuffer.FIELDS, "cursor", "t"):
        np.testing.assert_array_equal(thost[k], np.asarray(jhost[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(thost["key"].view(np.uint32),
                                  np.asarray(jhost["key"]))
    np.testing.assert_array_equal(thost["cursor"], [n_steps, n_steps, C])
    last_obs = np.random.default_rng(1).normal(size=(L, D)).astype(
        np.float32)
    want = jbuffer.consolidate(jhost, last_obs)
    got = buffer.consolidate(thost, last_obs)
    np.testing.assert_array_equal(got["lanes"], [0, 1, 2])
    assert_same_batch(got, want)


@pytest.mark.parametrize("plan", ["partial", "mixed"])
def test_consolidate_partial_lanes_match_reference(plan):
    L, C, D = 5, 4, 3
    live_plan = np.zeros((C + 2, L), bool)
    if plan == "partial":
        live_plan[:C - 1, 0] = True
    else:
        live_plan[:, 0] = True       # wraps
        live_plan[:C, 1] = True      # exactly full
        live_plan[:2, 3] = True      # partial
    jhost, thost = record_both(L, C, D, live_plan, seed=3)
    last_obs = np.zeros((L, D), np.float32)
    want = jbuffer.consolidate(jhost, last_obs)
    got = buffer.consolidate(thost, last_obs)
    assert_same_batch(got, want)


def test_rings_cross_through_convert():
    """A JAX ring dict crosses into the port, records there, and crosses
    back equal to the reference's recording of the same step."""
    L, C, D = 3, 4, 2
    jexp = jbuffer.init_buffer(jax.vmap(jbuffer.experience_stream)(
        jax_keys(L)), C, D)
    texp = convert.exp_buffer_from_numpy(jax.device_get(jexp), "cpu")
    live = np.array([True, False, True])
    obs = np.arange(L * D, dtype=np.float32).reshape(L, D)
    info = {"episode_reward_attacker": np.ones(L, np.float32),
            "episode_reward_defender": np.full(L, 2.0, np.float32)}
    args = (live, obs, np.arange(L, dtype=np.int32),
            np.full(L, 0.5, np.float32), np.array([False, True, True]))
    jexp = jbuffer.record(jexp, *map(jnp.asarray, args),
                          {k: jnp.asarray(v) for k, v in info.items()},
                          jnp.full(L, 3, jnp.int32))
    buffer.record(texp, *map(torch.from_numpy, args),
                  {k: torch.from_numpy(v) for k, v in info.items()},
                  torch.full((L,), 3, dtype=torch.int32))
    got, want = convert.exp_buffer_to_numpy(texp), jax.device_get(jexp)
    for k, v in want.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_step_keys_and_stream_match_jax_fold_in():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 32, (64, 2), dtype=np.uint64).astype(
        np.uint32)
    t = rng.integers(0, 2 ** 31, 64).astype(np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(words),
                                                   jnp.asarray(t)))
    exp = {"key": torch.from_numpy(words.view(np.int32)),
           "t": torch.from_numpy(t)}
    got = buffer.step_keys(exp).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        buffer.experience_stream(port_keys(8)).numpy().view(np.uint32),
        np.asarray(jax.vmap(jbuffer.experience_stream)(jax_keys(8))))


@pytest.fixture(scope="module")
def drained():
    """A port engine's drained burst of `ppo#sample` and scripted lanes
    (an ActorCritic of hidden (8,) from JAX's init)."""
    jnet = jppo.ActorCritic(4, (8,))
    p = jax.device_get(jnet.init(jax.random.PRNGKey(42),
                                 jnp.zeros((1, 4))))
    env = tregistry.get_sized("nakamoto", MAX_STEPS)
    net = tppo.ActorCritic(4, 4, (8,), device="cpu")
    with torch.no_grad():
        net.flat.copy_(flat_of(p))
    eng = ResidentEngine(env, tmake(alpha=0.25, gamma=0.5,
                                    max_steps=MAX_STEPS),
                         n_lanes=N_LANES, burst=BURST,
                         swap_policies={"ppo": (net, net.flat.detach()
                                                .clone(), "fp0")},
                         sample_policies=("ppo",), experience=BURST,
                         device="cpu")
    eng.start()
    eng.splice({ln: 100 + ln for ln in range(N_LANES)})
    ids = {ln: eng.policy_ids["ppo#sample" if ln % 2 else "honest"]
           for ln in range(N_LANES)}
    eng.burst_run(ids, occupancy=1.0)
    batch = eng.drain_experience()
    assert batch is not None and batch["steps"] == N_LANES * BURST
    return batch


def test_feed_frames_equal_reference(drained):
    want = jwire.pack_frame(dict(jfeed.encode_batch(drained),
                                 op="learn.feed", fingerprint="fp0"))
    got = wire.pack_frame(dict(feed.encode_batch(drained),
                               op="learn.feed", fingerprint="fp0"))
    assert got == want
    back = feed.decode_batch(json.loads(got[4:]))
    assert_same_batch(back, jfeed.decode_batch(json.loads(want[4:])))


def learner_pair(tmp_path, n_envs=N_LANES):
    cfg_kw = dict(n_envs=n_envs, n_steps=BURST, lr=1e-3, update_epochs=2,
                  n_minibatches=2, hidden=(8,))
    jenv = jregistry.get_sized("nakamoto", MAX_STEPS)
    tenv = tregistry.get_sized("nakamoto", MAX_STEPS)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jl = jlearner.Learner(jenv, jppo.PPOConfig(**cfg_kw),
                          protocol="nakamoto",
                          publish_dir=str(tmp_path / "j"), seed=0)
    tl = tlearner.Learner(tenv, tppo.PPOConfig(**cfg_kw),
                          protocol="nakamoto",
                          publish_dir=str(tmp_path / "t"), seed=0,
                          device="cpu")
    # the same starting weights (the port draws flax's law, not its
    # numbers) and a fresh optimizer state, as the reference's
    tl.ts.replace_params(flat_of(jl.ts.params))
    tl.fingerprint = tlearner.params_fingerprint(tl.ts.net)
    return jl, tl


def test_learner_ingest_matches_reference(tmp_path, drained):
    jl, tl = learner_pair(tmp_path)
    want = jl.ingest(jfeed.decode_batch(jfeed.encode_batch(drained)))
    got = tl.ingest(feed.decode_batch(feed.encode_batch(drained)))
    assert got["updated"] == want["updated"] == 1
    assert got["pool"] == want["pool"] == 0
    assert tl.updates == jl.updates == 1 and tl.publishes == 1
    diff = (tl.ts.net.flat.detach() - flat_of(jl.ts.params)).abs().max()
    assert float(diff) <= 1e-5
    for k, v in jl.last_metrics.items():
        assert tl.last_metrics[k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    latest = json.loads((tmp_path / "t" / "latest.json").read_text())
    assert latest["seq"] == 0 and latest["fingerprint"] == tl.fingerprint


def test_fingerprint_equal_for_the_same_weights():
    """The sha256 of the serialized params, in jax's canonical tree
    order (what a tree after an update or a load has)."""
    jnet = jppo.ActorCritic(4, (16, 16))
    p = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(3),
                                           jnp.zeros((1, 4))))
    net = tppo.ActorCritic(4, 4, (16, 16), device="cpu")
    with torch.no_grad():
        net.flat.copy_(flat_of(p))
    assert tlearner.params_fingerprint(net) == \
        jlearner.params_fingerprint(p)
    with torch.no_grad():
        net.flat[0] += 1.0
    assert tlearner.params_fingerprint(net) != \
        jlearner.params_fingerprint(p)


def test_learner_refuses_mismatched_window(tmp_path):
    tenv = tregistry.get_sized("nakamoto", MAX_STEPS)
    lr = tlearner.Learner(tenv, tppo.PPOConfig(n_envs=N_LANES,
                                               n_steps=BURST, hidden=(8,)),
                          protocol="nakamoto", publish_dir=str(tmp_path),
                          device="cpu")
    D = tenv.observation_length
    bad = dict(lanes=np.zeros(1, np.int32),
               obs=np.zeros((1, BURST + 1, D), np.float32),
               action=np.zeros((1, BURST + 1), np.int32),
               reward=np.zeros((1, BURST + 1), np.float32),
               done=np.zeros((1, BURST + 1), bool),
               era=np.zeros((1, BURST + 1), np.float32),
               erd=np.zeros((1, BURST + 1), np.float32),
               policy=np.zeros((1, BURST + 1), np.int32),
               last_obs=np.zeros((1, D), np.float32),
               steps=BURST + 1, partial=0, dropped_steps=0)
    with pytest.raises(ValueError, match="window length"):
        lr.ingest(bad)


def test_snapshots_load_both_ways(tmp_path, drained):
    """The port learner's published snapshot loads in the reference; a
    snapshot the reference exports loads in the port and hot-swaps into
    the port's server."""
    _, tl = learner_pair(tmp_path)
    tl.ingest(feed.decode_batch(feed.encode_batch(drained)))
    latest = json.loads((tmp_path / "t" / "latest.json").read_text())
    _, jp, jmeta = jdriver.load_policy_network(latest["path"])
    assert jmeta["payload_sha256"] == latest["fingerprint"] \
        == tl.fingerprint
    np.testing.assert_array_equal(flat_of(jp).numpy(),
                                  tl.ts.net.flat.detach().numpy())

    jnet = jppo.ActorCritic(4, (8,))
    p = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(9),
                                           jnp.zeros((1, 4))))
    path = str(tmp_path / "jax-snapshot.msgpack")
    jdriver.export_policy_snapshot(path, p, protocol="nakamoto",
                                   n_actions=4, observation_length=4,
                                   hidden=[8])
    net, flat, meta = tdriver.load_policy_network(path, device="cpu")
    np.testing.assert_array_equal(flat.detach().numpy(),
                                  flat_of(p).numpy())
    assert meta["payload_sha256"] == jlearner.params_fingerprint(p)

    from cpr_tpu_torch.serve.server import ServeServer
    tenv = tregistry.get_sized("nakamoto", MAX_STEPS)
    base = tppo.ActorCritic(4, 4, (8,), device="cpu")
    eng = ResidentEngine(tenv, tmake(alpha=0.25, gamma=0.5,
                                     max_steps=MAX_STEPS),
                         n_lanes=N_LANES, burst=BURST, device="cpu",
                         swap_policies={"ppo": (base, base.flat.detach()
                                                .clone(), "fp0")})
    server = ServeServer(eng, protocol="nakamoto")
    out = server._swap_from_path(path)
    assert out["ok"] and out["swapped"]
    assert eng.policy_fingerprint() == meta["payload_sha256"]
    np.testing.assert_array_equal(
        eng._slots[eng._slot_of["ppo"]][1].numpy(), flat.detach().numpy())
    # a snapshot of another protocol is refused, the old weights serve on
    other = str(tmp_path / "bk.msgpack")
    jdriver.export_policy_snapshot(other, p, protocol="bk-8-constant",
                                   n_actions=4, observation_length=4,
                                   hidden=[8])
    out = server._swap_from_path(other)
    assert not out["ok"] and out["refused"]
    assert eng.policy_fingerprint() == meta["payload_sha256"]
