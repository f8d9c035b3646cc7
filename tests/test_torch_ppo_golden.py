"""The committed JAX golden fixture for the port's PPO slice (K11).

`tests/fixtures/torch_port_ppo_golden.npz` holds one `make_train`
`train_step` of `cpr_tpu` (JAX on the CPU) for each of two cases:

  nak  Nakamoto under AssumptionEnv, per-lane alphas, train/driver.py's
       `sparse_relative` reward transform, KL stop on (target_kl 1e-4);
  ts   Tailstorm (k 8, discount, heuristic) in a 40-slot ring, scalar
       params, no transform, KL stop off;

both with max_steps 16 (episodes end inside the rollout), hidden (64, 64),
16 lanes x 32 steps, 2 epochs x 2 minibatches. Each case stores its
spec, JAX's initial params, the trajectory (actions, rewards, dones,
logp, value), the metrics and the updated params. `chip_smoke.py`
replays it through the CUDA kernels on a machine without jax; this test
recomputes the Nakamoto case live and replays both through the port's
plain versions on the CPU. `python tests/test_torch_ppo_golden.py`
rewrites the fixture (~25 s).

Tolerances: actions, rewards and dones exact; logp and value within
1e-5; metrics within 1e-5 relative with a 1e-6 floor (the loss terms are
means of unit-scale terms that cancel); params within 1e-5 after the
step (Adam moves each by about 3e-4 a minibatch).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_ppo_golden.npz")
LANES, STEPS, EPOCHS, MINIBATCHES, HIDDEN = 16, 32, 2, 2, 64
CASES = {
    "nak": dict(protocol="nakamoto", window=0, assumption=1, per_env=1,
                alpha_lo=0.15, alpha_hi=0.45, gamma=0.5, max_steps=16,
                transform="sparse_relative", target_kl=1e-4, seed=3),
    "ts": dict(protocol="tailstorm-8-discount-heuristic", window=40,
               assumption=0, per_env=0, alpha_lo=0.35, alpha_hi=0.35,
               gamma=0.5, max_steps=16, transform="", target_kl=0.0, seed=4),
}
TRAJ = ("action", "reward", "done", "logp", "value")


def spec_arrays(c: str) -> dict:
    return {f"{c}_{k}": np.asarray(v) for k, v in CASES[c].items()}


def jax_case(c: str) -> dict:
    """One train_step of cpr_tpu for case `c`: the fixture's arrays."""
    from cpr_tpu.envs.assumption import AssumptionEnv
    from cpr_tpu.envs.registry import get
    from cpr_tpu.params import make_params, stack_params
    from cpr_tpu.train import config as jconfig
    from cpr_tpu.train import driver, ppo
    from cpr_tpu_torch import convert

    s = CASES[c]
    env = (get(s["protocol"], window=s["window"]) if s["window"]
           else get(s["protocol"]))
    if s["assumption"]:
        env = AssumptionEnv(env)
    alphas = np.linspace(s["alpha_lo"], s["alpha_hi"], LANES)
    if s["per_env"]:
        params = stack_params([dict(alpha=float(a), gamma=s["gamma"],
                                    max_steps=s["max_steps"])
                               for a in alphas])
    else:
        params = make_params(alpha=s["alpha_lo"], gamma=s["gamma"],
                             max_steps=s["max_steps"])
    transform = None
    if s["transform"]:
        tc = jconfig.TrainConfig(reward=s["transform"],
                                 episode_len=s["max_steps"])
        transform = driver.make_reward_transform(tc, alphas)
    cfg = ppo.PPOConfig(n_envs=LANES, n_steps=STEPS, update_epochs=EPOCHS,
                        n_minibatches=MINIBATCHES, hidden=(HIDDEN, HIDDEN),
                        target_kl=s["target_kl"] or None)
    init_fn, train_step = ppo.make_train(env, params, cfg, transform,
                                         per_env_params=bool(s["per_env"]))

    carry = jax.jit(init_fn)(jax.random.PRNGKey(s["seed"]))
    flat = lambda p: convert.actor_critic_from_flax(  # noqa: E731
        jax.tree.map(np.asarray, p), "cpu").numpy()
    out = spec_arrays(c)
    out[f"{c}_params0"] = flat(carry[0].params)
    # the rollout alone, as train_step runs it, for the trajectory
    traj = _jax_rollout(env, params, cfg, transform, bool(s["per_env"]),
                        carry)
    carry2, metrics = jax.jit(train_step)(carry)
    for k in TRAJ:
        out[f"{c}_{k}"] = np.asarray(getattr(traj, k))
    out[f"{c}_params1"] = flat(carry2[0].params)
    for k, v in metrics.items():
        out[f"{c}_m_{k}"] = np.asarray(v, np.float32)
    return out


def _jax_rollout(env, params, cfg, transform, per_env, carry):
    """make_train's rollout half (ppo.py:339-365) on `carry`."""
    from cpr_tpu.train import ppo
    net = ppo.ActorCritic(env.n_actions, cfg.hidden)
    p_axis = 0 if per_env else None

    def env_step(c, _):
        ts, env_state, obs, key = c
        key, k_act = jax.random.split(key)
        logits, value = net.apply(ts.params, obs)
        action = jax.random.categorical(k_act, logits)
        logp = jax.nn.log_softmax(logits)[jnp.arange(cfg.n_envs), action]
        env_state, obs2, reward, done, info = jax.vmap(
            lambda s, a, p: env.step(s, a, p), in_axes=(0, 0, p_axis)
        )(env_state, action, params)
        if transform is not None:
            reward = transform(reward, info, done)
        reset_state, reset_obs = jax.vmap(
            lambda s, p: env.reset(s.key, p), in_axes=(0, p_axis)
        )(env_state, params)
        env_state = jax.tree.map(
            lambda a, b: jnp.where(
                done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b),
            reset_state, env_state)
        obs2 = jnp.where(done[:, None], reset_obs, obs2)
        t = ppo.Transition(obs=obs, action=action, logp=logp, value=value,
                           reward=reward, done=done, info=info)
        return (ts, env_state, obs2, key), t

    _, traj = jax.jit(lambda c: jax.lax.scan(env_step, c, None,
                                             length=cfg.n_steps))(carry)
    return traj


def port_case(fx: dict, c: str, device="cpu"):
    """The port's train_step on case `c` of the fixture, from its initial
    params: (trajectory, metrics, updated flat params)."""
    from cpr_tpu_torch import random
    from cpr_tpu_torch.envs.assumption import AssumptionEnv
    from cpr_tpu_torch.envs.base import map_state
    from cpr_tpu_torch.envs.registry import get
    from cpr_tpu_torch.params import make_params, stack_params
    from cpr_tpu_torch.train import config as tconfig
    from cpr_tpu_torch.train import driver, ppo

    s = {k: fx[f"{c}_{k}"].item() for k in CASES[c]}
    env = (get(s["protocol"], window=s["window"]) if s["window"]
           else get(s["protocol"]))
    if s["assumption"]:
        env = AssumptionEnv(env)
    alphas = np.linspace(s["alpha_lo"], s["alpha_hi"], LANES)
    if s["per_env"]:
        params = stack_params([dict(alpha=float(a), gamma=s["gamma"],
                                    max_steps=s["max_steps"])
                               for a in alphas])
    else:
        params = make_params(alpha=s["alpha_lo"], gamma=s["gamma"],
                             max_steps=s["max_steps"])
    transform = None
    if s["transform"]:
        tc = tconfig.TrainConfig(reward=s["transform"],
                                 episode_len=s["max_steps"])
        transform = driver.make_reward_transform(tc, alphas, device)
    cfg = ppo.PPOConfig(n_envs=LANES, n_steps=STEPS, update_epochs=EPOCHS,
                        n_minibatches=MINIBATCHES, hidden=(HIDDEN, HIDDEN),
                        target_kl=s["target_kl"] or None)
    init_fn, train_step = ppo.make_train(env, params, cfg, transform,
                                         per_env_params=bool(s["per_env"]),
                                         device=device)
    carry = init_fn(random.PRNGKey(s["seed"], device),
                    params=torch.from_numpy(fx[f"{c}_params0"]))
    # train_step's trajectory: the rollout from a copy of its carry
    ts, state, obs, key = carry
    _, traj = ppo.rollout(env, (map_state(torch.clone, state), obs.clone()),
                          params, ts.net, key, STEPS)
    if transform is not None:
        traj.reward = transform(traj.reward, traj.info, traj.done)
    carry, metrics = train_step(carry)
    return (traj, {k: float(v) for k, v in metrics.items()},
            carry[0].net.flat.detach().cpu().numpy())


def build_golden() -> dict:
    out = {}
    for c in CASES:
        out.update(jax_case(c))
    return out


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def check_metrics(got: dict, fx: dict, c: str):
    names = [k[len(f"{c}_m_"):] for k in fx if k.startswith(f"{c}_m_")]
    assert set(names) == set(got), (sorted(names), sorted(got))
    for k in names:
        want = float(fx[f"{c}_m_{k}"])
        assert abs(got[k] - want) <= 1e-5 * abs(want) + 1e-6, (c, k, got[k],
                                                               want)


def test_nakamoto_live_against_fixture(golden):
    """cpr_tpu recomputes the Nakamoto case: the trajectory's integers and
    the updated params as committed."""
    fresh = jax_case("nak")
    for k in ("action", "reward", "done"):
        np.testing.assert_array_equal(fresh[f"nak_{k}"], golden[f"nak_{k}"])
    for k in ("logp", "value", "params0", "params1"):
        np.testing.assert_allclose(fresh[f"nak_{k}"], golden[f"nak_{k}"],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_replays_fixture(golden, case):
    """The port's plain versions from JAX's params: the same actions,
    rewards and dones, logp and value within 1e-5, the metrics, and
    params within 1e-5 after the step."""
    traj, metrics, flat = port_case(golden, case)
    for k in ("action", "reward", "done"):
        np.testing.assert_array_equal(getattr(traj, k).numpy(),
                                      golden[f"{case}_{k}"])
    for k in ("logp", "value"):
        np.testing.assert_allclose(getattr(traj, k).numpy(),
                                   golden[f"{case}_{k}"], rtol=0, atol=1e-5)
    check_metrics(metrics, golden, case)
    np.testing.assert_allclose(flat, golden[f"{case}_params1"], rtol=0,
                               atol=1e-5)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    arrays = build_golden()
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({len(arrays)} arrays)")
