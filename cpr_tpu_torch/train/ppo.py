"""PPO over the port's lane-batched attack environments (port of
cpr_tpu/train/ppo.py).

One `train_step` is the reference's: a rollout of `cfg.n_steps` steps of
`cfg.n_envs` auto-resetting lanes under the policy net, GAE, then
`update_epochs x n_minibatches` clipped-surrogate minibatch updates. The
JAX package runs it as one XLA program; here it is a host loop over the
K11 kernels and PyTorch's matrix products:

  * the rollout is one K2 (Nakamoto) or K10 (DAG envs) stream launch
    with the actor-critic inside (K11-act, csrc/actor.cuh): every lane
    encodes its observation, runs both MLPs from the weights in shared
    memory, draws its action from the carry key's per-step split and
    stores logp and value beside the trajectory;
  * GAE is K11-gae (csrc/gae.cu);
  * a minibatch is a torch gather, the MLPs' forward and backward are
    `torch.matmul` under autograd, the loss head and its gradient are
    K11-loss (csrc/ppo_loss.cu, a `torch.autograd.Function`) and the
    optimizer step is K11-adam (csrc/adam.cu, `optim.ClipAdam`);
  * keys (K1) and the minibatch permutation (`random.permutation`: K1's
    bits under a stable `torch.sort`).

On CPU tensors every piece runs its plain twin, and those twins are what
the parity tests hold against `cpr_tpu`. Where the JAX package returns a
new carry, the port updates the carry's tensors (the env state, the
parameter vector and the optimizer moments) in place and returns it.

Parameters live in one flat float32 vector (`ActorCritic.flat`), layer
by layer in the order pi_0 .. pi_head, vf_0 .. vf_head, each as flax's
`Dense` keeps it: the kernel [in, out] row-major, then the bias. K11-act
reads that vector as it is and K11-adam updates it in one pass;
`convert.actor_critic_from_flax` / `_to_flax` cross to flax's tree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from cpr_tpu_torch import _device, random
from cpr_tpu_torch.learn.buffer import EXPERIENCE_STREAM, experience_stream
from cpr_tpu_torch.train import optim

__all__ = [
    "PPOConfig", "ActorCritic", "NetPolicy", "Transition", "TrainState",
    "EXPERIENCE_STREAM", "experience_stream", "shardings", "gae",
    "gae_plain", "loss_plain", "loss_head", "make_update_phase",
    "make_train", "make_lane_rollout", "make_experience_update",
    "maybe_checkify", "relative_reward_on_done", "train",
]


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 64
    n_steps: int = 128  # rollout length per update
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    update_epochs: int = 4
    n_minibatches: int = 4
    hidden: tuple[int, ...] = (64, 64)  # sb3 MlpPolicy default net_arch
    anneal_lr: bool = False
    total_updates: int = 1000  # for lr annealing
    # KL-adaptive early stop (sb3 target_kl): once a minibatch's
    # approximate KL exceeds 1.5 * target_kl, it and the remaining
    # minibatch updates of this train_step are skipped. None = off.
    target_kl: float | None = None


def layer_shapes(obs_dim: int, n_actions: int, hidden) -> list:
    """(name, in, out) of every Dense, in the flat vector's order."""
    out = []
    for prefix, head in (("pi", n_actions), ("vf", 1)):
        d = obs_dim
        for i, h in enumerate(hidden):
            out.append((f"{prefix}_{i}", d, int(h)))
            d = int(h)
        out.append((f"{prefix}_head", d, head))
    return out


def _key_seed(key: torch.Tensor) -> int:
    w = random.words(key.detach().cpu().reshape(2))
    return (int(w[0]) << 32) | int(w[1])


class ActorCritic(torch.nn.Module):
    """MLP actor-critic, the sb3 "MlpPolicy" shape (ppo.py:86-102): two
    tanh MLPs of `hidden` widths on the observation, a linear policy
    head (logits) and a linear value head.

    The parameters are one flat vector (`flat`, see the module doc);
    `layers()` views it as (kernel [in, out], bias) per Dense. `init`
    draws flax's default law, lecun-normal kernels (a normal truncated
    at two standard deviations, scaled to variance 1/fan_in) and zero
    biases, from a `torch.Generator` seeded from the key: the law, not
    flax's numbers; parity runs start from JAX's params through
    `convert`."""

    def __init__(self, obs_dim: int, n_actions: int, hidden=(64, 64),
                 device=None):
        super().__init__()
        self.obs_dim, self.n_actions = int(obs_dim), int(n_actions)
        self.hidden = tuple(int(h) for h in hidden)
        self.shapes = layer_shapes(self.obs_dim, self.n_actions, self.hidden)
        n = sum(i * o + o for _, i, o in self.shapes)
        self.flat = torch.nn.Parameter(torch.zeros(
            n, dtype=torch.float32, device=_device.resolve(device)))

    @property
    def n_params(self) -> int:
        return self.flat.numel()

    def layers(self, flat: torch.Tensor | None = None) -> dict:
        flat = self.flat if flat is None else flat
        out, off = {}, 0
        for name, i, o in self.shapes:
            w = flat[off:off + i * o].view(i, o)
            off += i * o
            out[name] = (w, flat[off:off + o])
            off += o
        return out

    @torch.no_grad()
    def init(self, key: torch.Tensor) -> "ActorCritic":
        g = torch.Generator(device="cpu")
        g.manual_seed(_key_seed(key))
        # flax's truncated normal: unit variance after truncation at +-2
        std_of_trunc = 0.87962566103423978
        for name, (w, b) in self.layers().items():
            std = math.sqrt(1.0 / w.shape[0]) / std_of_trunc
            t = torch.empty(w.shape, dtype=torch.float32)
            torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                        generator=g)
            w.copy_(t)
            b.zero_()
        return self

    def forward(self, obs: torch.Tensor, flat: torch.Tensor | None = None):
        L = self.layers(flat)
        n = len(self.hidden)
        x = obs
        for i in range(n):
            w, b = L[f"pi_{i}"]
            x = torch.tanh(x @ w + b)
        w, b = L["pi_head"]
        logits = x @ w + b
        v = obs
        for i in range(n):
            w, b = L[f"vf_{i}"]
            v = torch.tanh(v @ w + b)
        w, b = L["vf_head"]
        return logits, (v @ w + b)[..., 0]


class NetPolicy:
    """The actor-critic as a policy of the env drivers: `greedy` takes
    the argmax of the logits (first index among equals), else actions
    are drawn as `jax.random.categorical` from the carry `key`, split
    once per step (ppo.py:341-343). On a CUDA carry the stream kernels
    run it (K11-act); on the CPU `act` is the greedy plain version (the
    sampling rollout's plain twin is `rollout_plain`)."""

    is_net_policy = True

    def __init__(self, net: ActorCritic, greedy: bool = True,
                 key: torch.Tensor | None = None):
        if not greedy and key is None:
            raise ValueError("a sampling NetPolicy needs the carry key")
        self.net, self.greedy, self.key = net, greedy, key

    @torch.no_grad()
    def act(self, obs: torch.Tensor) -> torch.Tensor:
        if not self.greedy:
            raise NotImplementedError(
                "sampling on the CPU runs in ppo.rollout_plain, which "
                "stores logp and value")
        logits, _ = self.net(obs)
        return torch.argmax(logits, dim=-1)

    __call__ = act


@dataclasses.dataclass
class Transition:
    """A trajectory, time-major: obs [T, N, F], action int32 [T, N],
    logp/value/reward float32 [T, N], done bool [T, N], info
    {INFO_KEYS: [T, N]}."""

    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    info: dict


@dataclasses.dataclass
class TrainState:
    """flax's TrainState: the net (its flat vector is the params), the
    optimizer, its state, and `step`, the count of applied updates."""

    net: ActorCritic
    tx: optim.ClipAdam
    opt_state: optim.AdamState
    step: int = 0

    @property
    def params(self) -> torch.Tensor:
        return self.net.flat

    def apply_gradients(self, grad: torch.Tensor) -> "TrainState":
        with torch.no_grad():
            self.tx.step(self.net.flat.data, grad, self.opt_state)
        self.step += 1
        return self

    def replace_params(self, flat: torch.Tensor) -> "TrainState":
        """These params with a fresh optimizer state (the revert)."""
        with torch.no_grad():
            self.net.flat.data.copy_(flat)
        self.opt_state = self.tx.init(self.net.flat.data)
        return self


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to cpr_tpu_torch yet (ROADMAP item {item})")


def shardings(mesh, dp_axis: str = "dp", tp_axis: str = "tp"):
    raise _not_ported("mesh sharding of the train state", 13)


# -- GAE: K11-gae and its plain twin -----------------------------------------

def gae_plain(reward, value, done, last_value, gamma: float, lam: float):
    """Plain twin of K11-gae: the reverse scan of ppo.py:154-164 over
    [T, N], in float32 in the reference's order. Returns (adv, target)."""
    # gamma and gamma * lam (a host product, as Python forms it there)
    # round to float32 before they meet the arrays
    g = torch.tensor(gamma, dtype=torch.float32, device=reward.device)
    gl = torch.tensor(gamma * lam, dtype=torch.float32, device=reward.device)
    adv_next = torch.zeros_like(last_value)
    v_next = last_value
    advs = torch.empty_like(reward)
    for t in range(reward.shape[0] - 1, -1, -1):
        nonterm = 1.0 - done[t].to(torch.float32)
        delta = reward[t] + g * v_next * nonterm - value[t]
        adv = delta + gl * nonterm * adv_next
        advs[t] = adv
        adv_next, v_next = adv, value[t]
    return advs, advs + value


def gae(reward, value, done, last_value, gamma: float, lam: float):
    """GAE: K11-gae on CUDA tensors, the plain twin on CPU ones."""
    if reward.is_cuda:
        from cpr_tpu_torch import kernels
        return kernels.gae(reward, value, done, last_value, gamma, lam)
    return gae_plain(reward, value, done, last_value, gamma, lam)


# -- the loss head: K11-loss and its plain twin ------------------------------

LOSS_METRICS = ("pg_loss", "v_loss", "entropy", "approx_kl")


def loss_plain(logits, value, action, old_logp, old_value, adv, target,
               clip_eps: float, vf_coef: float, ent_coef: float):
    """Plain twin of K11-loss: ppo.py:166-185 from the logits [B, A] and
    value [B] of the minibatch on. Returns (total, metrics [4]: pg_loss,
    v_loss, entropy, approx_kl), differentiable through autograd."""
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, 1, action.long()[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv_n
    pg_loss = -torch.minimum(pg1, pg2).mean()
    v_clipped = old_value + torch.clamp(value - old_value, -clip_eps,
                                        clip_eps)
    v_loss = 0.5 * torch.maximum((value - target) ** 2,
                                 (v_clipped - target) ** 2).mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pg_loss + vf_coef * v_loss - ent_coef * entropy
    logratio = logp - old_logp
    approx_kl = ((torch.exp(logratio) - 1.0) - logratio).mean()
    return total, torch.stack([pg_loss, v_loss, entropy,
                               approx_kl]).detach()


class _KernelLoss(torch.autograd.Function):
    """K11-loss: the forward kernel gives the total and the metrics, the
    backward kernel dlogits and dvalue."""

    @staticmethod
    def forward(ctx, logits, value, action, old_logp, old_value, adv,
                target, coefs):
        from cpr_tpu_torch import kernels
        out, stats = kernels.ppo_loss_fwd(logits, value, action, old_logp,
                                          old_value, adv, target, *coefs)
        ctx.save_for_backward(logits, value, action, old_logp, old_value,
                              adv, target, stats)
        ctx.coefs = coefs
        ctx.mark_non_differentiable(out[1:])
        return out[0], out[1:]

    @staticmethod
    def backward(ctx, g_total, g_metrics):
        from cpr_tpu_torch import kernels
        dlogits, dvalue = kernels.ppo_loss_bwd(*ctx.saved_tensors, g_total,
                                               *ctx.coefs)
        return dlogits, dvalue, None, None, None, None, None, None


def loss_head(logits, value, action, old_logp, old_value, adv, target,
              cfg: PPOConfig):
    """(total, metrics [4]): K11-loss on CUDA tensors, `loss_plain` on CPU
    ones."""
    coefs = (float(cfg.clip_eps), float(cfg.vf_coef),
             float(cfg.entropy_coef))
    if logits.is_cuda:
        total, metrics = _KernelLoss.apply(
            logits.contiguous(), value.contiguous(), action, old_logp,
            old_value, adv, target, coefs)
        return total, metrics.detach()
    return loss_plain(logits, value, action, old_logp, old_value, adv,
                      target, *coefs)


# -- the update half -----------------------------------------------------------

def make_minibatch_epochs(cfg: PPOConfig):
    """The update half after GAE (ppo.py:187-285): epochs of minibatch
    updates over ONE trajectory, (T, N) from its shapes, and the step's
    metrics.

    Returns epochs(ts, traj, advs, targets, key) -> (ts, key, metrics),
    `ts` updated in place, metrics 0-dim tensors."""
    kl_limit = (None if cfg.target_kl is None
                else float(np.float32(1.5 * cfg.target_kl)))

    def epochs(ts: TrainState, traj: Transition, advs, targets, key):
        n_steps, n_envs = traj.action.shape
        n = n_steps * n_envs
        obs_f = traj.obs.reshape(n, -1)
        act_f = traj.action.reshape(n)
        logp_f = traj.logp.reshape(n)
        value_f = traj.value.reshape(n)
        adv_f = advs.reshape(n)
        target_f = targets.reshape(n)
        mb_size = n // cfg.n_minibatches
        rows, applied, cont = [], [], True
        for _ in range(cfg.update_epochs):
            pair = random.split(key)
            key, k_perm = pair[0], pair[1]
            perm = random.permutation(k_perm, n)[:cfg.n_minibatches
                                                 * mb_size]
            for idx in perm.reshape(cfg.n_minibatches, mb_size):
                flat = ts.net.flat
                logits, value = ts.net(obs_f[idx])
                total, m = loss_head(logits, value, act_f[idx], logp_f[idx],
                                     value_f[idx], adv_f[idx],
                                     target_f[idx], cfg)
                if kl_limit is not None:
                    cont = cont and float(m[3]) <= kl_limit
                    applied.append(cont)
                if kl_limit is None or cont:
                    (grad,) = torch.autograd.grad(total, flat)
                    ts.apply_gradients(grad)
                rows.append(m)
        stacked = torch.stack(rows)  # [epochs * n_mb, 4]
        if kl_limit is None:
            metrics = {k: stacked[:, j].mean()
                       for j, k in enumerate(LOSS_METRICS)}
        else:
            # gated means weighted by `applied` (ppo.py:258-270)
            w = torch.tensor(applied, dtype=torch.float32,
                             device=stacked.device)
            nw = torch.clamp(w.sum(), min=1.0)
            metrics = {}
            for j, k in enumerate(LOSS_METRICS):
                col = stacked[:, j]
                metrics[k] = ((col * w).sum() / nw
                              if k in ("pg_loss", "v_loss", "approx_kl")
                              else col.mean())
            metrics["kl_stop"] = (1.0 - w).mean()
        done = traj.done
        n_done = done.sum()
        nd = torch.clamp(n_done, min=1).to(torch.float32)
        zero = torch.zeros_like(traj.reward)
        metrics["mean_step_reward"] = traj.reward.mean()
        for k in ("episode_reward_attacker", "episode_reward_defender"):
            metrics[k] = torch.where(done, traj.info[k], zero).sum() / nd
        metrics["n_episodes"] = n_done.to(torch.int32)
        return ts, key, metrics

    return epochs


def make_update_phase(cfg: PPOConfig):
    """The update half of a PPO step (ppo.py:139-285): GAE, then
    `make_minibatch_epochs`' epochs. Returns update_phase(ts, traj,
    last_value, key) -> (ts, key, metrics)."""
    epochs = make_minibatch_epochs(cfg)

    def update_phase(ts: TrainState, traj: Transition, last_value, key):
        advs, targets = gae(traj.reward, traj.value, traj.done, last_value,
                            cfg.gamma, cfg.gae_lambda)
        return epochs(ts, traj, advs, targets, key)

    return update_phase


# -- the rollout: K2/K10 with K11-act, and its plain twin ---------------------

def rollout_plain(env, state, obs, params, net: ActorCritic, key, n_steps):
    """Plain twin of the net-policy stream (ppo.py:339-361): per step
    split the carry key, run the net, draw the action, step and
    auto-reset every lane. Returns (state, obs, key, Transition) with
    the carry's new tensors."""
    from cpr_tpu_torch.envs.base import INFO_KEYS
    cols = {k: [] for k in ("obs", "action", "logp", "value", "reward",
                            "done")}
    infos = {k: [] for k in INFO_KEYS}
    n = obs.shape[0]
    for _ in range(n_steps):
        pair = random.split(key)
        key, k_act = pair[0], pair[1]
        with torch.no_grad():
            logits, value = net(obs)
        action = random.categorical(k_act, logits).to(torch.int32)
        logp = torch.log_softmax(logits, dim=-1)[torch.arange(n), action]
        state, obs_next, _, reward, done, info = env._lane_step(
            state, action, params)
        for k, v in (("obs", obs), ("action", action), ("logp", logp),
                     ("value", value), ("reward", reward), ("done", done)):
            cols[k].append(v)
        for k in INFO_KEYS:
            infos[k].append(info[k])
        obs = obs_next
    traj = Transition(**{k: torch.stack(v) for k, v in cols.items()},
                      info={k: torch.stack(v) for k, v in infos.items()})
    return state, obs, key, traj


def rollout(env, carry, params, net: ActorCritic, key, n_steps):
    """The rollout half: the env's stream kernel with the net (K2 or K10
    with K11-act) on a CUDA carry, `rollout_plain` on a CPU one. The
    carry (state, obs) is updated in place; returns (key, Transition)."""
    from cpr_tpu_torch.envs.base import INFO_KEYS, copy_state_
    state, obs = carry
    if obs.is_cuda:
        _, _, tr = env._kernel_stream(
            carry, None, 0, n_steps, params, 0, False, True,
            net=NetPolicy(net, greedy=False, key=key))
        t_obs, action, reward, done, info, logp, value, key = tr
        traj = Transition(obs=t_obs, action=action, logp=logp, value=value,
                          reward=reward, done=done,
                          info={k: info[i] for i, k in enumerate(INFO_KEYS)})
        return key, traj
    s, o, key, traj = rollout_plain(env, state, obs, params, net, key,
                                    n_steps)
    copy_state_(state, s)
    obs.copy_(o)
    return key, traj


def make_train(env, env_params, cfg: PPOConfig,
               reward_transform: Callable | None = None,
               per_env_params: bool = False,
               rollout_phase: Callable | None = None, *, device=None):
    """Build (init_fn, train_step) (ppo.py:288-377).

    reward_transform(reward, info, done) -> shaped reward, applied to the
    stored trajectory (it is elementwise and does not feed back into the
    rollout). per_env_params: `env_params` fields carry a leading
    (n_envs,) axis. `device`: where the carry lives (the card unless
    the caller passes "cpu").

    init_fn(key, params=None) -> carry (ts, env_state, obs, key): the
    key splits in three (net, envs); `params` (a flat vector, e.g. from
    `convert.actor_critic_from_flax`) replaces the port's own init.
    train_step(carry) -> (carry, metrics), the carry updated in place:
    `rollout` from the carry's key, the transform, then `update_phase`."""
    if rollout_phase is not None:
        raise _not_ported("make_train(rollout_phase=...), the resident "
                          "lane rollout", 12)
    dev = _device.resolve(device)
    if per_env_params:
        n = env_params.alpha.shape[0] if env_params.alpha.dim() else None
        if n != cfg.n_envs:
            raise ValueError(f"per_env_params: params for {n} lanes, "
                             f"cfg.n_envs is {cfg.n_envs}")
    update_phase = make_update_phase(cfg)
    n_per = cfg.total_updates * cfg.update_epochs * cfg.n_minibatches

    def lr_schedule(count):
        if not cfg.anneal_lr:
            return cfg.lr
        f32 = np.float32
        frac = f32(1.0) - f32(count) / f32(n_per)
        return f32(cfg.lr) * max(frac, f32(0.0))

    tx = optim.ClipAdam(lr_schedule, max_grad_norm=cfg.max_grad_norm)

    def init_fn(key, params: torch.Tensor | None = None):
        key = key.to(dev)
        keys = random.split(key, 3)
        key, k_net, k_env = keys[0], keys[1], keys[2]
        net = ActorCritic(env.observation_length, env.n_actions, cfg.hidden,
                          device=dev)
        if params is None:
            net.init(k_net)
        else:
            with torch.no_grad():
                net.flat.copy_(params.to(dev))
        ts = TrainState(net, tx, tx.init(net.flat.data))
        env_keys = random.split(k_env, cfg.n_envs)
        env_state, obs = env.reset_lanes(env_keys, env_params)
        return ts, env_state, obs, key

    def train_step(carry):
        ts, env_state, obs, key = carry
        key, traj = rollout(env, (env_state, obs), env_params, ts.net, key,
                            cfg.n_steps)
        if reward_transform is not None:
            traj.reward = reward_transform(traj.reward, traj.info, traj.done)
        with torch.no_grad():
            _, last_value = ts.net(obs)
        ts, key, metrics = update_phase(ts, traj, last_value, key)
        return (ts, env_state, obs, key), metrics

    return init_fn, train_step


def make_lane_rollout(env, env_params, cfg: PPOConfig, **kw):
    """The resident lane rollout (ppo.py:380-447) and its per-lane
    `categorical` draws come with the serve engine."""
    raise _not_ported("make_lane_rollout", 12)


def make_experience_update(n_actions: int, obs_dim: int, cfg: PPOConfig, *,
                           reward_transform: Callable | None = None,
                           device=None):
    """The learner half over fed experience (ppo.py:450-500): logp and
    value recomputed under the current params, then `update_phase`.

    Returns (net, init_fn, update): init_fn(key, params=None) ->
    TrainState; update(ts, batch, key) -> (ts, key, metrics), `ts`
    updated in place. Batch (time-major): obs [T, N, obs_dim] float32,
    action [T, N] int32, reward/era/erd [T, N] float32, done [T, N]
    bool, last_obs [N, obs_dim]."""
    dev = _device.resolve(device)
    update_phase = make_update_phase(cfg)
    tx = optim.ClipAdam(cfg.lr, max_grad_norm=cfg.max_grad_norm)
    net = ActorCritic(obs_dim, n_actions, cfg.hidden, device=dev)

    def init_fn(key, params: torch.Tensor | None = None):
        if params is None:
            net.init(key)
        else:
            with torch.no_grad():
                net.flat.copy_(params.to(dev))
        return TrainState(net, tx, tx.init(net.flat.data))

    def update(ts, batch, key):
        obs, action, done = batch["obs"], batch["action"], batch["done"]
        with torch.no_grad():
            logits, value = ts.net(obs)
            logp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                action.long()[..., None])[..., 0]
            _, last_value = ts.net(batch["last_obs"])
        info = {"episode_reward_attacker": batch["era"],
                "episode_reward_defender": batch["erd"]}
        reward = batch["reward"]
        if reward_transform is not None:
            reward = reward_transform(reward, info, done)
        traj = Transition(obs=obs, action=action, logp=logp, value=value,
                          reward=reward, done=done, info=info)
        return update_phase(ts, traj, last_value, key)

    return net, init_fn, update


def maybe_checkify(step_fn):
    """The reference's opt-in checkify float checks (CPR_CHECKIFY=1)
    are device metrics' sibling: ROADMAP item 14. Without them the step
    runs as it is."""
    import os
    if os.environ.get("CPR_CHECKIFY") == "1":
        raise _not_ported("CPR_CHECKIFY float checks", 14)
    return step_fn


def relative_reward_on_done(reward, info, done):
    """Sparse relative reward shaping (wrappers.py:8-26): at episode end
    the attacker's share of total reward; zero elsewhere."""
    a = info["episode_reward_attacker"]
    d = info["episode_reward_defender"]
    s = a + d
    rel = torch.where(s != 0, a / torch.where(s != 0, s, torch.ones_like(s)),
                      torch.zeros_like(s))
    return torch.where(done, rel, torch.zeros_like(rel))


def train(env, env_params, cfg: PPOConfig, *, n_updates: int, seed: int = 0,
          reward_transform=relative_reward_on_done, mesh=None,
          progress: Callable | None = None, device=None):
    """Run PPO for n_updates; returns (train_state, metrics history)."""
    import time
    if mesh is not None:
        raise _not_ported("train(mesh=...)", 13)
    dev = _device.resolve(device)
    init_fn, train_step = make_train(env, env_params, cfg, reward_transform,
                                     device=dev)
    carry = init_fn(random.PRNGKey(seed, dev))
    history = []
    steps_per_update = cfg.n_envs * cfg.n_steps
    for i in range(n_updates):
        t0 = time.perf_counter()
        carry, metrics = train_step(carry)
        m = {k: float(v) for k, v in metrics.items()}
        dur = time.perf_counter() - t0
        m["wall_s"] = round(dur, 6)
        if dur > 0:
            m["steps_per_sec"] = round(steps_per_update / dur)
        if progress is not None:
            progress(i, m)
        history.append(m)
    return carry[0], history
