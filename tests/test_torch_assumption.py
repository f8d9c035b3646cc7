"""Port parity of `AssumptionEnv` and of two driver repairs against
cpr_tpu on the CPU.

  * AssumptionEnv (envs/assumption.py): the observation extended by each
    lane's (alpha, gamma) under per-lane params, its reset, step,
    rollout and stats driver, the stripped policies (scripted ones keep
    their kernel ids, `takes_state` survives the strip);
  * a policy with `takes_state = True` gets (state, obs) in `rollout`,
    the stats driver and `Core.policy`, as in the reference
    (cpr_tpu/envs/base.py:218-226, gym/envs.py:130-131);
  * `episode_stats` takes a single key [2] and returns 0-dim stats
    (cpr_tpu/envs/base.py:330-340).

Integer state, actions, rewards and dones bit-identical; unit
observations atol 1e-6; the time stats rtol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.envs.assumption import AssumptionEnv as JA
from cpr_tpu.params import make_params as jmake
from cpr_tpu.params import stack_params as jstack
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.envs.assumption import AssumptionEnv as TA
from cpr_tpu_torch.params import make_params as tmake
from cpr_tpu_torch.params import stack_params as tstack

L, T = 8, 40
ADOPT, OVERRIDE, WAIT = 0, 1, 3


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def lane_params(n=L, max_steps=12):
    kws = [dict(alpha=float(a), gamma=float(g), max_steps=max_steps)
           for a, g in zip(np.linspace(0.1, 0.45, n),
                           np.linspace(0.0, 0.9, n))]
    return jstack(kws), tstack(kws)


def keys(seed, n=L):
    return (jax.random.split(jax.random.PRNGKey(seed), n),
            rnd.split(rnd.PRNGKey(seed, device="cpu"), n))


def honest_from_state(state, obs):
    """A policy that reads the state (the fork lengths) instead of the
    observation: the honest policy's choices."""
    a, h = state.a, state.h
    xp = jnp if isinstance(a, jax.Array) else torch
    return xp.where(a > h, OVERRIDE, xp.where(a < h, ADOPT, WAIT))


honest_from_state.takes_state = True


def jax_rollout(env, jk, jp, policy, n):
    return jax.vmap(lambda k, p: env.rollout(k, p, policy, n))(jk, jp)


def assert_traj(t, j):
    obs, action, reward, done, info = t
    jobs, jaction, jreward, jdone, jinfo = j
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(action.numpy(), np.asarray(jaction))
    np.testing.assert_array_equal(reward.numpy(), np.asarray(jreward))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_reset_and_step_extend_the_observation():
    je, te = JA(jregistry.get("nakamoto")), TA(tregistry.get("nakamoto"))
    assert te.observation_length == je.observation_length == 6
    np.testing.assert_array_equal(te.low.numpy(), np.asarray(je.low))
    np.testing.assert_array_equal(te.high.numpy(), np.asarray(je.high))
    jp, tp = lane_params()
    jk, tk = keys(1)
    js, jo = jax.vmap(je.reset)(jk, jp)
    ts, to = te.reset(tk, tp)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(to[:, -2:].numpy(),
                                  np.stack([np.asarray(jp.alpha),
                                            np.asarray(jp.gamma)], 1))
    action = np.arange(L, dtype=np.int32) % 4
    js, jo, jr, jd, _ = jax.vmap(je.step)(js, action, jp)
    ts, to, tr, td, _ = te.step(ts, torch.from_numpy(action), tp)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("name", ["honest", "sapirshtein-2016-sm1"])
def test_rollout_and_stats_with_stripped_policies(name):
    je, te = JA(jregistry.get("nakamoto")), TA(tregistry.get("nakamoto"))
    jp, tp = lane_params()
    jk, tk = keys(2)
    assert te.scripted_policy_id(te.policies[name]) == \
        te.inner.scripted_policies.index(name)
    want = jax_rollout(je, jk, jp, je.policies[name], T)
    got = te.rollout(tk, tp, te.policies[name], T)
    assert_traj(got, want)
    # the stats driver on the extended env
    jstats = jax.vmap(lambda k, p: je.episode_stats(
        k, p, je.policies[name], T))(jk, jp)
    tstats = te.episode_stats(tk, tp, te.policies[name], T)
    for k, v in jstats.items():
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=0, err_msg=k)


def test_state_policy_in_rollout_stats_and_assumption():
    """Fault 3.1: a takes_state policy runs through `rollout`, the stats
    driver and AssumptionEnv's stripped policies, as in the reference."""
    jenv, tenv = jregistry.get("nakamoto"), tregistry.get("nakamoto")
    jp, tp = (jmake(alpha=0.35, gamma=0.5, max_steps=12),
              tmake(alpha=0.35, gamma=0.5, max_steps=12))
    jk, tk = keys(3)
    want = jax.vmap(lambda k: jenv.rollout(k, jp, honest_from_state, T))(jk)
    got = tenv.rollout(tk, tp, honest_from_state, T)
    assert_traj(got, want)
    # it is the honest policy, computed from the state
    honest = tenv.rollout(tk, tp, "honest", T)
    assert torch.equal(got[1], honest[1])
    jstats = jax.vmap(lambda k: jenv.episode_stats(
        k, jp, honest_from_state, T))(jk)
    tstats = tenv.make_episode_stats_fn(tp, honest_from_state, T, chunk=16)(
        tk)
    for k, v in jstats.items():
        np.testing.assert_allclose(tstats[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=0, err_msg=k)
    # through AssumptionEnv's strip
    ja, ta = JA(jenv), TA(tenv)
    jlp, tlp = lane_params()
    ja.policies["by-state"] = ja._strip(honest_from_state)
    jwant = jax_rollout(ja, jk, jlp, ja.policies["by-state"], T)
    stripped = ta._strip(honest_from_state, "by-state")
    assert stripped.takes_state
    assert_traj(ta.rollout(tk, tlp, stripped, T), jwant)


def test_state_policy_in_gym_core():
    gym = pytest.importorskip("cpr_tpu_torch.gym")
    core = gym.Core("nakamoto", max_steps=16, seed=4, device="cpu")
    core.torch_env.policies["by-state"] = honest_from_state
    try:
        obs, _ = core.reset()
        for _ in range(20):
            a = core.policy(obs, "by-state")
            assert a == core.policy(obs, "honest")
            obs, _, term, trunc, _ = core.step(a)
            if term or trunc:
                obs, _ = core.reset()
    finally:
        del core.torch_env.policies["by-state"]


def test_cuda_refuses_a_python_callable_naming_the_kernels():
    """On CUDA a Python callable still raises, naming what the kernels
    run; the stream's CUDA branch refuses it before touching the card
    (here reached with an object that only says it lies on CUDA)."""
    class OnCuda:
        device = torch.device("cuda", 0)

    env = tregistry.get("nakamoto")
    with pytest.raises(NotImplementedError, match="NetPolicy"):
        env._stream(None, OnCuda(), 1, 4,
                    tmake(alpha=0.3, gamma=0.5, max_steps=4),
                    lambda obs: obs[:, 0], False)


@pytest.mark.parametrize("key", ["nakamoto", "bk-2-constant"])
def test_episode_stats_single_key(key):
    """Fault 3.2: episode_stats(key [2]) gives 0-dim stats equal to the
    reference's."""
    kw = {} if key == "nakamoto" else {"window": 32}
    jenv, tenv = jregistry.get(key, **kw), tregistry.get(key, **kw)
    jp, tp = (jmake(alpha=0.35, gamma=0.5, max_steps=10),
              tmake(alpha=0.35, gamma=0.5, max_steps=10))
    name = tenv.scripted_policies[1]
    for seed in (0, 5):
        want = jenv.episode_stats(jax.random.PRNGKey(seed), jp,
                                  jenv.policies[name], 30)
        got = tenv.episode_stats(rnd.PRNGKey(seed, device="cpu"), tp,
                                 tenv.policies[name], 30)
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dim() == 0, k
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                       rtol=1e-5, atol=0, err_msg=k)
