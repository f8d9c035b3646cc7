"""Port parity of the config-driven training driver and its formats
against cpr_tpu on the CPU.

  * every YAML under cpr_tpu/train/configs/ parses to the same
    TrainConfig (fields, lane alphas, eval alphas), and the validators
    refuse what the reference's refuse;
  * every `make_reward_transform` variant gives the reference's bits
    (the `exp` shaping within 1e-6: the two exps differ in the last bits);
  * `evaluate_per_alpha` gives the reference's rows from the same params;
  * the msgpack codec (`train.serialization`) reads flax's bytes and
    writes them byte for byte; checkpoints and policy snapshots written
    by either package load in the other, refusals included;
  * `train_from_config` from the same params equals the reference's run
    (history and eval rows) on a small config.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.train import config as jconfig
from cpr_tpu.train import driver as jdriver
from cpr_tpu.train.ppo import ActorCritic as JActorCritic
from cpr_tpu_torch import convert
from cpr_tpu_torch.integrity import IntegrityError
from cpr_tpu_torch.train import config as tconfig
from cpr_tpu_torch.train import driver as tdriver
from cpr_tpu_torch.train import serialization
from cpr_tpu_torch.train.ppo import ActorCritic

CONFIGS = sorted((Path(jconfig.__file__).parent / "configs").glob("*.yaml"))
SMALL = dict(protocol="nakamoto", alpha=dict(min=0.2, max=0.4), gamma=0.5,
             episode_len=16, n_envs=16, total_updates=3,
             ppo=dict(n_steps=16, n_minibatches=2, update_epochs=2,
                      layer_size=16),
             eval=dict(freq=1, start_at_iteration=0, alpha_step=0.1,
                       episodes_per_alpha=8))


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_yaml_configs_parse_as_the_reference(path):
    j = jconfig.TrainConfig.from_yaml(str(path))
    t = tconfig.TrainConfig.from_yaml(str(path))
    assert dataclasses.asdict(t) == j.model_dump()
    np.testing.assert_array_equal(t.lane_alphas(37), j.lane_alphas(37))
    np.testing.assert_array_equal(t.eval_alphas(), j.eval_alphas())
    assert t.alpha_is_scheduled() == j.alpha_is_scheduled()
    assert dataclasses.asdict(tdriver.ppo_config(t)) == \
        dataclasses.asdict(jdriver.ppo_config(j))


@pytest.mark.parametrize("bad,match", [
    (dict(gamma=1.0), "gamma must be in"),
    (dict(reward="dense_per_progress", shape="cut"), "per-step rewards"),
    (dict(reward="nosuch"), "reward"),
    (dict(alpha="x"), "alpha")])
def test_validators_refuse_as_the_reference(bad, match):
    with pytest.raises(Exception, match=match):
        jconfig.TrainConfig.model_validate(bad)
    with pytest.raises(ValueError, match=match):
        tconfig.TrainConfig.from_dict(bad)


def random_info(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 12, n).astype(np.float32)
    d = rng.integers(0, 12, n).astype(np.float32)
    a[:3] = d[:3] = 0  # s == 0 lanes
    p = (a + d - rng.integers(0, 3, n)).clip(0).astype(np.float32)
    return {"episode_reward_attacker": a, "episode_reward_defender": d,
            "episode_progress": p,
            "episode_n_activations": (p * rng.uniform(0.9, 1.3, n)).round()
            .astype(np.float32),
            "step_reward_attacker": rng.integers(0, 3, n).astype(np.float32)}


@pytest.mark.parametrize("reward,shape", [
    ("sparse_relative", "raw"), ("sparse_relative", "cut"),
    ("sparse_relative", "exp"), ("sparse_per_progress", "raw"),
    ("sparse_per_progress", "cut"), ("sparse_per_progress", "exp"),
    ("dense_per_progress", "raw")])
def test_reward_transforms(reward, shape):
    n = 256
    d = dict(reward=reward, shape=shape, episode_len=100)
    alphas = np.linspace(0.15, 0.45, n)
    jt = jdriver.make_reward_transform(
        jconfig.TrainConfig.model_validate(d), alphas)
    tt = tdriver.make_reward_transform(tconfig.TrainConfig.from_dict(d),
                                       alphas, "cpu")
    info = random_info(n, 1)
    done = np.random.default_rng(2).random(n) < 0.5
    reward0 = np.zeros(n, np.float32)
    want = np.asarray(jax.jit(jt)(reward0, info, done))
    got = tt(torch.from_numpy(reward0),
             {k: torch.from_numpy(v) for k, v in info.items()},
             torch.from_numpy(done))
    if shape == "exp":  # XLA's exp and torch's differ by an ULP or two
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def jax_params(cfg, env, seed=0):
    net = JActorCritic(env.n_actions, jdriver.ppo_config(cfg).hidden)
    return net.init(jax.random.PRNGKey(seed),
                    jnp.zeros((1, env.observation_length)))


def port_net_of(params, env, cfg):
    net = ActorCritic(env.observation_length, env.n_actions,
                      tdriver.ppo_config(cfg).hidden, device="cpu")
    with torch.no_grad():
        net.flat.copy_(convert.actor_critic_from_flax(
            jax.tree.map(np.asarray, params), "cpu"))
    return net


@pytest.mark.parametrize("reward", ["sparse_relative", "dense_per_progress"])
def test_evaluate_per_alpha_rows(reward):
    d = dict(SMALL, reward=reward)
    jc = jconfig.TrainConfig.model_validate(d)
    tc = tconfig.TrainConfig.from_dict(d)
    jenv, tenv = jdriver.build_env(jc), tdriver.build_env(tc, "cpu")
    assert tenv.observation_length == jenv.observation_length
    params = jax_params(jc, jenv, 3)
    want = jdriver.evaluate_per_alpha(jenv, jc, params)
    got = tdriver.evaluate_per_alpha(tenv, tc, port_net_of(params, tenv, tc))
    assert got == want


def test_msgpack_codec_is_flax_byte_for_byte():
    from flax import serialization as fser
    for hidden, obs_dim, n_actions in (((4, 4), 3, 2), ((64, 64), 6, 4),
                                       ((96, 96), 12, 24)):
        net = JActorCritic(n_actions, hidden)
        p = net.init(jax.random.PRNGKey(1), jnp.zeros((1, obs_dim)))
        for tree in (p, jax.tree.map(lambda x: x, p)):  # both key orders
            data = fser.to_bytes(tree)
            as_np = {"params": {k: {kk: np.asarray(vv) for kk, vv in
                                    v.items()}
                                for k, v in tree["params"].items()}}
            assert serialization.to_bytes(as_np) == data
            back = serialization.from_bytes(data)
            assert list(back["params"]) == list(tree["params"])
            assert jax.tree.all(jax.tree.map(np.array_equal, back, as_np))
        flat = convert.actor_critic_from_flax(jax.tree.map(np.asarray, p),
                                              "cpu")
        tree = convert.actor_critic_to_flax(flat, obs_dim, n_actions, hidden)
        assert serialization.to_bytes(tree) == \
            fser.to_bytes(jax.tree.map(lambda x: x, p))
    with pytest.raises(ValueError):
        serialization.from_bytes(b"\xc0")


def test_checkpoints_load_both_ways(tmp_path):
    jc = jconfig.TrainConfig.model_validate(SMALL)
    tc = tconfig.TrainConfig.from_dict(SMALL)
    jenv, tenv = jdriver.build_env(jc), tdriver.build_env(tc, "cpu")
    params = jax.tree.map(lambda x: x, jax_params(jc, jenv, 4))
    # flax -> port
    jpath = str(tmp_path / "j.msgpack")
    jdriver.save_checkpoint(jpath, params, {"update": 1})
    net = tdriver.load_checkpoint(jpath, tenv, tc, device="cpu")
    assert torch.equal(net.flat, port_net_of(params, tenv, tc).flat)
    # port -> flax, byte for byte the same file
    tpath = str(tmp_path / "t.msgpack")
    tdriver.save_checkpoint(tpath, net, {"update": 1})
    assert Path(tpath).read_bytes() == Path(jpath).read_bytes()
    assert json.loads(Path(tpath + ".json").read_text()) == \
        json.loads(Path(jpath + ".json").read_text())
    back = jdriver.load_checkpoint(tpath, jenv, jc)
    assert jax.tree.all(jax.tree.map(np.array_equal, back, params))


def test_policy_snapshots_load_both_ways(tmp_path):
    jc = jconfig.TrainConfig.model_validate(SMALL)
    tc = tconfig.TrainConfig.from_dict(SMALL)
    jenv, tenv = jdriver.build_env(jc), tdriver.build_env(tc, "cpu")
    params = jax.tree.map(lambda x: x, jax_params(jc, jenv, 5))
    meta = jdriver.serving_meta(jenv, jc)
    assert tdriver.serving_meta(tenv, tc) == meta
    obs = np.random.default_rng(3).random((64, jenv.observation_length),
                                          dtype=np.float32)
    jpath = str(tmp_path / "j.msgpack")
    jdriver.export_policy_snapshot(jpath, params, **meta)
    tpol, tmeta = tdriver.load_policy_snapshot(jpath, device="cpu")
    jpol, jmeta = jdriver.load_policy_snapshot(jpath)
    np.testing.assert_array_equal(tpol(torch.from_numpy(obs)).numpy(),
                                  np.asarray(jpol(obs)))
    assert tmeta == jmeta
    tpath = str(tmp_path / "t.msgpack")
    tdriver.export_policy_snapshot(tpath, tpol.net, **meta)
    jnet, jparams, _ = jdriver.load_policy_network(tpath)
    assert jax.tree.all(jax.tree.map(np.array_equal, jparams, params))
    # refusals: no sidecar, a torn pair
    Path(tpath + ".json").unlink()
    with pytest.raises(IntegrityError, match="sidecar"):
        tdriver.load_policy_network(tpath, device="cpu")
    side = json.loads(Path(jpath + ".json").read_text())
    side["payload_sha256"] = "0" * 64
    Path(jpath + ".json").write_text(json.dumps(side))
    with pytest.raises(IntegrityError, match="torn"):
        tdriver.load_policy_network(jpath, device="cpu")


def test_train_from_config_against_jax(tmp_path):
    """The whole config path on a small config from the same params: the
    history's metrics, the eval rows and the checkpoints as the
    reference's."""
    jc = jconfig.TrainConfig.model_validate(SMALL)
    tc = tconfig.TrainConfig.from_dict(SMALL)
    jenv = jdriver.build_env(jc)
    k_net = jax.random.split(jax.random.PRNGKey(jc.seed), 3)[1]
    p0 = JActorCritic(jenv.n_actions, (16, 16)).init(
        k_net, jnp.zeros((1, jenv.observation_length)))
    jnet, jhist, jrows = jdriver.train_from_config(jc,
                                                   out_dir=str(tmp_path / "j"))
    tnet, thist, trows = tdriver.train_from_config(
        tc, out_dir=str(tmp_path / "t"), device="cpu",
        init_params=convert.actor_critic_from_flax(
            jax.tree.map(np.asarray, p0), "cpu"))
    assert trows == jrows
    for jm, tm in zip(jhist, thist):
        for k in jm:
            if k in ("wall_s", "steps_per_sec"):
                continue
            assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]) + 1e-6, k
    assert float((tnet.flat.detach() - convert.actor_critic_from_flax(
        jax.tree.map(np.asarray, jnet), "cpu")).abs().max()) <= 1e-5
    for f in ("best-model.msgpack", "last-model.msgpack"):
        assert (tmp_path / "t" / f).exists()
        got = tdriver.load_policy_network(str(tmp_path / "t" / f),
                                          device="cpu")[2]
        assert got["protocol"] == "nakamoto" and got["hidden"] == [16, 16]
    lines = (tmp_path / "t" / "metrics.jsonl").read_text().splitlines()
    assert sum('"eval": true' in ln for ln in lines) == len(trows)


def test_driver_refuses_what_is_not_ported():
    tc = tconfig.TrainConfig.from_dict(SMALL)
    for kw, item in ((dict(resume=True), "item 6"),
                     (dict(snapshot_freq=5), "item 6"),
                     (dict(metrics_port=0), "item 12"),
                     (dict(mesh=object()), "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            tdriver.train_from_config(tc, device="cpu", **kw)


def test_build_env_windows_dag_envs_on_request():
    """build_env sizes a DAG env for the episodes (the reference's full
    mode) whatever the device, the card included, where K10-ts-full
    takes it; Nakamoto has no DAG."""
    d = dict(SMALL, protocol="tailstorm-8-discount-heuristic", alpha=0.3)
    tc = tconfig.TrainConfig.from_dict(d)
    full = tdriver.build_env(tc, "cpu")
    assert not full.ring and full.capacity >= 2 * 16 + 8
    card = tdriver.build_env(tc, "cuda")
    assert not card.ring and card.capacity == full.capacity
    card._check_kernel()
    nak = tdriver.build_env(tconfig.TrainConfig.from_dict(
        dict(SMALL, alpha=0.3)), "cuda")
    assert not hasattr(nak, "capacity")
    sched = tdriver.build_env(tconfig.TrainConfig.from_dict(SMALL), "cpu")
    assert sched.observation_length == 6
