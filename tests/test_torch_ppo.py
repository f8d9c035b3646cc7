"""Port parity of PPO (`cpr_tpu_torch.train.ppo`, the plain twins of the
K11 kernels) against cpr_tpu's `train/ppo.py` on the CPU.

The same params (JAX's, through `convert.actor_critic_from_flax`), keys
and inputs go through both packages:

  * `random.permutation` bit for bit with `jax.random.permutation` at
    sizes that take 1, 2 and 3 sort rounds, and `random.categorical` on
    2-d logits as ppo.py:343 draws;
  * the actor-critic's logits and value within 1e-5;
  * GAE, the loss head and its gradient, the optax chain and one
    `update_phase`, from the same inputs, within 1e-5 (relative for the
    metrics, with a 1e-6 floor: the loss terms are means of unit-scale
    terms that cancel; relative to the largest element for gradients);
  * one `make_train` `train_step` for Nakamoto (scalar params, and under
    AssumptionEnv with per-lane params) and Tailstorm in a 40-slot ring,
    max_steps 16, with and without the KL stop and the reward
    transforms: actions, rewards and dones bit-equal, logp and value
    within 1e-5, metrics as above, params within 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.envs.assumption import AssumptionEnv as JAssumption
from cpr_tpu.params import make_params as jmake
from cpr_tpu.params import stack_params as jstack
from cpr_tpu.train import config as jconfig
from cpr_tpu.train import driver as jdriver
from cpr_tpu.train import ppo as J
from cpr_tpu_torch import convert
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.envs.assumption import AssumptionEnv as TAssumption
from cpr_tpu_torch.params import make_params as tmake
from cpr_tpu_torch.params import stack_params as tstack
from cpr_tpu_torch.train import config as tconfig
from cpr_tpu_torch.train import driver as tdriver
from cpr_tpu_torch.train import optim
from cpr_tpu_torch.train import ppo as P


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def flat_of(params):
    return convert.actor_critic_from_flax(jax.tree.map(np.asarray, params),
                                          "cpu")


def jax_net(obs_dim, n_actions, hidden, seed):
    net = J.ActorCritic(n_actions, hidden)
    return net, net.init(jax.random.PRNGKey(seed), jnp.zeros((1, obs_dim)))


def port_net(params, obs_dim, n_actions, hidden):
    net = P.ActorCritic(obs_dim, n_actions, hidden, device="cpu")
    with torch.no_grad():
        net.flat.copy_(flat_of(params))
    return net


def close_metric(got, want, what):
    assert abs(got - want) <= 1e-5 * abs(want) + 1e-6, (what, got, want)


def closure(fn, name):
    """A nested function of the reference's (`gae`, `loss_fn`, ...), taken
    from the closure cells of `fn`, which calls it."""
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells[name].cell_contents


# -- random --------------------------------------------------------------------

@pytest.mark.parametrize("n,rounds", [(1000, 1), (100_000, 2),
                                      (2_700_000, 3)])
def test_permutation_bit_for_bit(n, rounds):
    assert int(np.ceil(3 * np.log(n) / np.log(2 ** 32 - 1))) == rounds
    for seed in (0, 9):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = rnd.permutation(rnd.PRNGKey(seed, device="cpu"), n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_2d_logits_is_ppo_draw():
    logits = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    for seed in range(4):
        key, k_act = jax.random.split(jax.random.PRNGKey(seed))
        want = np.asarray(jax.random.categorical(k_act, logits))
        pair = rnd.split(rnd.PRNGKey(seed, device="cpu"))
        got = rnd.categorical(pair[1], torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(rnd.to_numpy_words(pair[0]),
                                      np.asarray(key))


# -- the net, GAE, the loss head, the optimizer ---------------------------------

@pytest.mark.parametrize("hidden,obs_dim,n_actions", [((64, 64), 6, 4),
                                                      ((96, 96), 10, 8),
                                                      ((16, 16), 12, 24)])
def test_actor_critic_forward(hidden, obs_dim, n_actions):
    jn, jp = jax_net(obs_dim, n_actions, hidden, 1)
    tn = port_net(jp, obs_dim, n_actions, hidden)
    obs = np.random.default_rng(1).random((128, obs_dim), dtype=np.float32)
    jl, jv = jn.apply(jp, obs)
    with torch.no_grad():
        tl, tv = tn(torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    # the lossless crossing back
    tree = convert.actor_critic_to_flax(tn.flat, obs_dim, n_actions, hidden)
    assert jax.tree.all(jax.tree.map(np.array_equal, tree,
                                     jax.tree.map(np.asarray, jp)))


def test_port_init_law():
    """The port's own init: lecun-normal kernels (truncated at 2 sigma,
    variance 1/fan_in), zero biases, the same numbers from the same key."""
    net = P.ActorCritic(10, 8, (64, 64), device="cpu")
    net.init(rnd.PRNGKey(3, device="cpu"))
    again = P.ActorCritic(10, 8, (64, 64), device="cpu")
    again.init(rnd.PRNGKey(3, device="cpu"))
    assert torch.equal(net.flat, again.flat)
    for name, (w, b) in net.layers().items():
        assert bool((b == 0).all())
        std = float(w.detach().std())
        fan_in = w.shape[0]
        assert 0.7 < std * np.sqrt(fan_in) < 1.3, (name, std)
        assert float(w.detach().abs().max()) <= \
            2.0 / np.sqrt(fan_in) / 0.8796 + 1e-6


def traj_inputs(T, N, seed):
    rng = np.random.default_rng(seed)
    reward = np.where(rng.random((T, N)) < 0.1, rng.random((T, N)),
                      0).astype(np.float32)
    value = rng.normal(size=(T, N)).astype(np.float32)
    done = rng.random((T, N)) < 0.08
    last = rng.normal(size=N).astype(np.float32)
    return reward, value, done, last


def test_gae_against_jax():
    cfg = J.PPOConfig()
    update = J.make_update_phase(J.ActorCritic(4, (8, 8)), cfg)
    jgae = closure(update, "gae")
    reward, value, done, last = traj_inputs(64, 32, 2)
    traj = J.Transition(obs=None, action=None, logp=None, value=value,
                        reward=reward, done=done, info=None)
    ja, jt = jax.jit(jgae)(traj, last)
    ta, tt = P.gae(*(torch.from_numpy(x) for x in (reward, value, done,
                                                   last)),
                   cfg.gamma, cfg.gae_lambda)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)


def minibatch(obs_dim, n_actions, B, seed):
    rng = np.random.default_rng(seed)
    obs = rng.random((B, obs_dim), dtype=np.float32)
    action = rng.integers(0, n_actions, B).astype(np.int32)
    logp = np.log(rng.uniform(0.05, 0.6, B)).astype(np.float32)
    value = rng.normal(size=B).astype(np.float32)
    adv = rng.normal(0.2, 1.3, B).astype(np.float32)
    target = (value + adv).astype(np.float32)
    return obs, action, logp, value, adv, target


def test_loss_and_gradient_against_jax():
    cfg = J.PPOConfig()
    jn, jp = jax_net(10, 8, (64, 64), 4)
    update = J.make_update_phase(jn, cfg)
    jloss = closure(closure(update, "update_minibatch"), "loss_fn")
    obs, action, logp, value, adv, target = minibatch(10, 8, 256, 5)
    batch = J.Transition(obs=obs, action=action, logp=logp, value=value,
                         reward=None, done=None, info=None)
    (jtotal, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jp, batch, adv, target)
    tn = port_net(jp, 10, 8, (64, 64))
    logits, v = tn(torch.from_numpy(obs))
    ttotal, tm = P.loss_plain(logits, v, *(torch.from_numpy(x) for x in (
        action, logp, value, adv, target)), cfg.clip_eps, cfg.vf_coef,
        cfg.entropy_coef)
    (tgrad,) = torch.autograd.grad(ttotal, tn.flat)
    close_metric(float(ttotal.detach()), float(jtotal), "total")
    for j, k in enumerate(P.LOSS_METRICS):
        close_metric(float(tm[j]), float(jm[k]), k)
    jg = flat_of(jgrad)
    assert float((tgrad - jg).abs().max()) <= 1e-5 * float(jg.abs().max())


@pytest.mark.parametrize("anneal", [False, True])
def test_clip_adam_against_optax(anneal):
    cfg = J.PPOConfig(anneal_lr=anneal, total_updates=3, update_epochs=2,
                      n_minibatches=2)
    n_per = cfg.total_updates * cfg.update_epochs * cfg.n_minibatches

    def lr_schedule(count):
        if not cfg.anneal_lr:
            return cfg.lr
        frac = 1.0 - count / n_per
        return cfg.lr * jnp.maximum(frac, 0.0)

    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(lr_schedule, eps=1e-5))
    rng = np.random.default_rng(6)
    p = {"w": rng.normal(0, 0.1, 500).astype(np.float32)}
    state = tx.init(p)

    def port_lr(count):
        if not cfg.anneal_lr:
            return cfg.lr
        f32 = np.float32
        return f32(cfg.lr) * max(f32(1.0) - f32(count) / f32(n_per),
                                 f32(0.0))

    ptx = optim.ClipAdam(port_lr, max_grad_norm=cfg.max_grad_norm)
    flat = torch.from_numpy(p["w"].copy())
    pstate = ptx.init(flat)
    jp = p
    for i in range(16):  # past the schedule's end when annealed
        g = {"w": rng.normal(0, 0.05 if i % 2 else 0.005,
                             500).astype(np.float32)}
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        ptx.step(flat, torch.from_numpy(g["w"]), pstate)
        np.testing.assert_allclose(flat.numpy(), np.asarray(jp["w"]),
                                   rtol=0, atol=1e-6)
    assert pstate.count == 16


def test_update_phase_against_jax():
    """One update_phase from the same trajectory, params and key, the KL
    stop on and off."""
    T, N, F, A = 16, 8, 6, 4
    rng = np.random.default_rng(7)
    obs = rng.random((T, N, F), dtype=np.float32)
    action = rng.integers(0, A, (T, N)).astype(np.int32)
    reward, value, done, last = traj_inputs(T, N, 8)
    jn, jp = jax_net(F, A, (16, 16), 9)
    logits, _ = jn.apply(jp, obs)
    logp = np.asarray(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                          action[..., None], -1)[..., 0])
    info = {"episode_reward_attacker": reward * 3,
            "episode_reward_defender": reward * 5}
    for target_kl in (None, 1e-3):
        cfg = J.PPOConfig(update_epochs=3, n_minibatches=2, hidden=(16, 16),
                          target_kl=target_kl)
        update = J.make_update_phase(jn, cfg)
        tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                         optax.adam(cfg.lr, eps=1e-5))
        from flax.training.train_state import TrainState
        ts = TrainState.create(apply_fn=jn.apply, params=jp, tx=tx)
        traj = J.Transition(obs=obs, action=action, logp=logp, value=value,
                            reward=reward, done=done, info=info)
        jts, jkey, jm = jax.jit(update)(ts, traj, last,
                                        jax.random.PRNGKey(10))
        tn = port_net(jp, F, A, (16, 16))
        pcfg = P.PPOConfig(update_epochs=3, n_minibatches=2, hidden=(16, 16),
                           target_kl=target_kl)
        ptx = optim.ClipAdam(pcfg.lr, max_grad_norm=pcfg.max_grad_norm)
        tts = P.TrainState(tn, ptx, ptx.init(tn.flat.data))
        t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
        ttraj = P.Transition(obs=t(obs), action=t(action), logp=t(logp),
                             value=t(value), reward=t(reward), done=t(done),
                             info={k: t(v) for k, v in info.items()})
        tts, tkey, tm = P.make_update_phase(pcfg)(
            tts, ttraj, t(last), rnd.PRNGKey(10, device="cpu"))
        assert set(tm) == set(jm)
        for k in jm:
            close_metric(float(tm[k]), float(jm[k]), k)
        np.testing.assert_array_equal(rnd.to_numpy_words(tkey),
                                      np.asarray(jkey))
        assert tts.step == int(jts.step)
        jflat = flat_of(jts.params)
        assert float((tts.net.flat.detach() - jflat).abs().max()) <= 1e-5


# -- one train_step --------------------------------------------------------------

LANES, STEPS = 16, 32
STEP_CASES = {
    # name: (protocol, window, assumption + per-lane params, reward
    #        transform (TrainConfig reward, shape) or "relative", target_kl)
    "nakamoto": ("nakamoto", None, False, "relative", 2e-3),
    "nakamoto-dense": ("nakamoto", None, True,
                       ("dense_per_progress", "raw"), None),
    "nakamoto-cut": ("nakamoto", None, True, ("sparse_per_progress", "cut"),
                     None),
    "nakamoto-exp": ("nakamoto", None, True, ("sparse_relative", "exp"),
                     1e-3),
    "tailstorm": ("tailstorm-8-discount-heuristic", 40, False,
                  ("sparse_per_progress", "raw"), None),
}


def both_envs(protocol, window, assumption):
    kw = {"window": window} if window else {}
    je, te = jregistry.get(protocol, **kw), tregistry.get(protocol, **kw)
    if assumption:
        je, te = JAssumption(je), TAssumption(te)
    return je, te


def rollout_of(env, params, carry, n_steps, transform):
    """The trajectory `train_step(carry)` collects, from a copy of the
    carry: `ppo.rollout` from its key, then the reward transform."""
    from cpr_tpu_torch.envs.base import map_state
    ts, state, obs, key = carry
    _, traj = P.rollout(env, (map_state(torch.clone, state), obs.clone()),
                        params, ts.net, key, n_steps)
    if transform is not None:
        traj.reward = transform(traj.reward, traj.info, traj.done)
    return traj


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_against_jax(case, capsys):
    protocol, window, assumption, reward, target_kl = STEP_CASES[case]
    je, te = both_envs(protocol, window, assumption)
    alphas = np.linspace(0.15, 0.45, LANES)
    if assumption:
        kws = [dict(alpha=float(a), gamma=0.5, max_steps=16) for a in alphas]
        jp, tp = jstack(kws), tstack(kws)
    else:
        jp, tp = (jmake(alpha=0.35, gamma=0.5, max_steps=16),
                  tmake(alpha=0.35, gamma=0.5, max_steps=16))
        alphas = np.full(LANES, 0.35)
    if reward == "relative":
        jt, tt = J.relative_reward_on_done, P.relative_reward_on_done
    else:
        d = dict(reward=reward[0], shape=reward[1], episode_len=16)
        jt = jdriver.make_reward_transform(
            jconfig.TrainConfig.model_validate(d), alphas)
        tt = tdriver.make_reward_transform(tconfig.TrainConfig.from_dict(d),
                                           alphas, "cpu")
    kw = dict(n_envs=LANES, n_steps=STEPS, update_epochs=2, n_minibatches=2,
              hidden=(64, 64), target_kl=target_kl)
    jinit, jstep = J.make_train(je, jp, J.PPOConfig(**kw), jt,
                                per_env_params=assumption)
    tinit, tstep = P.make_train(te, tp, P.PPOConfig(**kw), tt,
                                per_env_params=assumption, device="cpu")
    jc = jax.jit(jinit)(jax.random.PRNGKey(11))
    tc = tinit(rnd.PRNGKey(11, device="cpu"), params=flat_of(jc[0].params))
    np.testing.assert_array_equal(tc[2].numpy(), np.asarray(jc[2]))
    # the reference's rollout, for its trajectory: the golden test's
    from test_torch_ppo_golden import _jax_rollout
    jtraj = _jax_rollout(je, jp, J.PPOConfig(**kw), jt, assumption, jc)
    flat0 = flat_of(jc[0].params)
    jc2, jm = jax.jit(jstep)(jc)
    # train_step's trajectory: the rollout from a copy of its carry
    ttraj = rollout_of(te, tp, tc, STEPS, tt)
    tc2, tm = tstep(tc)
    for k in ("action", "reward", "done"):
        np.testing.assert_array_equal(getattr(ttraj, k).numpy(),
                                      np.asarray(getattr(jtraj, k)), err_msg=k)
    for k in ("logp", "value"):
        np.testing.assert_allclose(getattr(ttraj, k).numpy(),
                                   np.asarray(getattr(jtraj, k)), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert set(tm) == set(jm)
    for k in jm:
        close_metric(float(tm[k]), float(jm[k]), k)
    jflat = flat_of(jc2[0].params)
    assert float((tc2[0].net.flat.detach() - jflat).abs().max()) <= 1e-5
    np.testing.assert_array_equal(rnd.to_numpy_words(tc2[3]),
                                  np.asarray(jc2[3]))
    # the smallest Gumbel margin of the rollout's draws: how close a draw
    # came to another action (the kernel's tolerance is 1e-5)
    margins = []
    key = rnd.split(rnd.PRNGKey(11, device="cpu"), 3)[0]
    for t in range(STEPS):
        pair = rnd.split(key)
        key = pair[0]
        with torch.no_grad():
            logits, _ = tc2[0].net(ttraj.obs[t], flat0)
        z = logits + rnd.gumbel(pair[1], tuple(logits.shape))
        top = torch.topk(z, 2, -1).values
        margins.append(float((top[:, 0] - top[:, 1]).min()))
    with capsys.disabled():
        print(f"\n[{case}] min Gumbel margin {min(margins):.3g}, "
              f"episodes {int(jm['n_episodes'])}")
    assert int(jm["n_episodes"]) > 0


def test_not_ported_surfaces_name_their_items():
    env = tregistry.get("nakamoto")
    params = tmake(alpha=0.35, gamma=0.5, max_steps=8)
    cfg = P.PPOConfig(n_envs=4)
    with pytest.raises(NotImplementedError, match="item 12"):
        P.make_lane_rollout(env, params, cfg)
    with pytest.raises(NotImplementedError, match="item 12"):
        P.make_train(env, params, cfg, rollout_phase=lambda c: c,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        P.shardings(None)
    with pytest.raises(NotImplementedError, match="item 13"):
        P.train(env, params, cfg, n_updates=1, mesh=object(), device="cpu")


def test_experience_update_against_jax():
    """The learner half over fed experience (ppo.py:450-500)."""
    T, N, F, A = 8, 8, 6, 4
    rng = np.random.default_rng(13)
    batch = {"obs": rng.random((T, N, F), dtype=np.float32),
             "action": rng.integers(0, A, (T, N)).astype(np.int32),
             "reward": rng.random((T, N), dtype=np.float32),
             "era": rng.random((T, N), dtype=np.float32),
             "erd": rng.random((T, N), dtype=np.float32),
             "done": rng.random((T, N)) < 0.2,
             "last_obs": rng.random((N, F), dtype=np.float32)}
    cfg = J.PPOConfig(update_epochs=2, n_minibatches=2, hidden=(16, 16))
    jnet, jinit, jupdate, _ = J.make_experience_update(A, F, cfg)
    jts = jinit(jax.random.PRNGKey(1))
    flat0 = flat_of(jts.params)
    jts2, jkey, jm = jupdate(jts, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jax.random.PRNGKey(2))
    pcfg = P.PPOConfig(update_epochs=2, n_minibatches=2, hidden=(16, 16))
    _, tinit, tupdate, _ = P.make_experience_update(A, F, pcfg,
                                                    device="cpu")
    tts = tinit(rnd.PRNGKey(1, device="cpu"), params=flat0)
    tts, tkey, tm = tupdate(tts, {k: torch.from_numpy(np.asarray(v))
                                  for k, v in batch.items()},
                            rnd.PRNGKey(2, device="cpu"))
    for k in jm:
        close_metric(float(tm[k]), float(jm[k]), k)
    assert float((tts.net.flat.detach() - flat_of(jts2.params)).abs().max()
                 ) <= 1e-5
