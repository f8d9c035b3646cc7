"""gymnasium adapter over the port's environments (port of
cpr_tpu/gym/envs.py).

Reference counterpart: gym/ocaml/cpr_gym/envs.py — `Core(gym.Env)` over
the OCaml engine (:9-93) and the registered ids (:96,166-192).

Both adapters drive the env's resident lane API (`step_lanes`: kernel
K3 on CUDA for Nakamoto, K10-bk or K10-eth for the DAG envs) with
constant masks, over carries made by `reset_lanes`,
with the JAX package's key schedule: the same seed gives the same
stream. `device` picks where the lanes live; it defaults to the CUDA
device and raises where there is none.
"""

from __future__ import annotations

import gymnasium
import numpy as np
import torch

from cpr_tpu_torch import _device
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry
from cpr_tpu_torch.envs.base import TorchEnv
from cpr_tpu_torch.params import ParameterError, make_params


class Core(gymnasium.Env):
    """Single gymnasium env over a TorchEnv.

    `proto` is a TorchEnv instance or a registry/protocol key
    ("nakamoto", ...); construction kwargs mirror the reference Core
    (envs.py:12-53): alpha, gamma, activation_delay, defenders, and at
    least one of max_steps / max_progress / max_time.
    """

    metadata = {"render_modes": ["ascii"]}

    def __init__(self, proto: TorchEnv | str = "nakamoto", *, alpha=0.25,
                 gamma=0.5, activation_delay=1.0, defenders=None,
                 max_steps=None, max_progress=None, max_time=None,
                 seed: int = 0, device=None, **proto_kwargs):
        if max_steps is None and max_progress is None and max_time is None:
            raise ParameterError(
                "set at least one of max_steps, max_progress, max_time")
        self.device = _device.resolve(device)
        if isinstance(proto, str):
            if max_steps is not None and "max_steps_hint" not in proto_kwargs:
                proto = registry.get_sized(proto, int(max_steps),
                                           **proto_kwargs)
            else:
                proto = registry.get(proto, **proto_kwargs)
        self.torch_env: TorchEnv = proto
        # mutable parameter record, re-read on every reset — wrappers
        # reconfigure assumptions by writing here (the reference's
        # core_kwargs contract, envs.py:20-24, wrappers.py:227-235)
        self.core_kwargs = dict(
            alpha=alpha, gamma=gamma, activation_delay=activation_delay,
            defenders=defenders, max_steps=max_steps,
            max_progress=max_progress, max_time=max_time)

        self._key = rnd.PRNGKey(seed, self.device)
        # width-1 resident lane block: (state, obs) carry + constant masks
        self._carry = None
        self._fresh = None
        self._no_admit = torch.zeros(1, dtype=torch.bool, device=self.device)
        self._step_all = torch.ones(1, dtype=torch.bool, device=self.device)
        self.params = None

        self.action_space = gymnasium.spaces.Discrete(proto.n_actions)
        self.observation_space = gymnasium.spaces.Box(
            np.asarray(proto.low, np.float64),
            np.asarray(proto.high, np.float64), dtype=np.float64)

    # -- gymnasium API ---------------------------------------------------

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        if seed is not None:
            self._key = rnd.PRNGKey(seed, self.device)
        self.params = make_params(**self.core_kwargs)
        self._key, k = rnd.split(self._key)
        # two carries: the fresh template and the carry that step_lanes
        # updates in place never share tensors
        self._fresh = self.torch_env.reset_lanes(k[None], self.params)
        self._carry = self.torch_env.reset_lanes(k[None], self.params)
        return self._carry[1][0].cpu().numpy().astype(np.float64), {}

    def step(self, action):
        actions = torch.tensor([int(action)], dtype=torch.int32,
                               device=self.device)
        _, (obs, reward, done, info) = self.torch_env.step_lanes(
            self._carry, actions, self._no_admit, self._fresh,
            self._step_all, self.params)
        info = {k: float(v[0]) for k, v in info.items()}
        return (obs[0].cpu().numpy().astype(np.float64), float(reward[0]),
                bool(done[0]), False, info)

    def render(self):
        fields = getattr(self.torch_env, "fields", ())
        if self._carry is None or not fields:
            print(f"<{type(self.torch_env).__name__}: not reset>")
            return
        vals = self.torch_env.decode_obs(self._carry[1][0].cpu())
        print(", ".join(f"{f.name}={int(v)}"
                        for f, v in zip(fields, vals)))

    # -- reference surface beyond gymnasium ------------------------------

    def policies(self):
        return self.torch_env.policies.keys()

    def policy(self, obs, name="honest"):
        try:
            fn = self.torch_env.policies[name]
        except KeyError:
            raise ValueError(
                f"{name} is not a valid policy; choose from "
                + ", ".join(self.policies()))
        obs = torch.as_tensor(np.asarray(obs), dtype=torch.float32)
        if getattr(fn, "takes_state", False):
            # the width-1 lane block's state, as the reference's _state0
            return int(fn(self._carry[0], obs[None])[0])
        return int(fn(obs))


class BatchedCore(gymnasium.Env):
    """Batched variant: actions/observations/rewards carry a leading
    `n_envs` axis and episodes auto-reset per lane — one K3 launch per
    step on CUDA."""

    metadata = {"render_modes": []}

    def __init__(self, proto: TorchEnv | str = "nakamoto", *,
                 n_envs: int = 128, seed: int = 0, device=None, **kwargs):
        self._single = Core(proto, seed=seed, device=device, **kwargs)
        env = self._single.torch_env
        self.torch_env = env
        self.device = self._single.device
        self.core_kwargs = self._single.core_kwargs
        self.n_envs = n_envs
        self._key = rnd.PRNGKey(seed, self.device)
        self._carry = None
        self._fresh = None
        self._no_admit = torch.zeros(n_envs, dtype=torch.bool,
                                     device=self.device)
        self._step_all = torch.ones(n_envs, dtype=torch.bool,
                                    device=self.device)
        self.params = None
        self.action_space = gymnasium.spaces.MultiDiscrete(
            np.full(n_envs, env.n_actions))
        low = np.tile(np.asarray(env.low, np.float64), (n_envs, 1))
        high = np.tile(np.asarray(env.high, np.float64), (n_envs, 1))
        self.observation_space = gymnasium.spaces.Box(low, high,
                                                      dtype=np.float64)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._key = rnd.PRNGKey(seed, self.device)
        self.params = make_params(**self.core_kwargs)
        self._key, k = rnd.split(self._key)
        keys = rnd.split(k, self.n_envs)
        # the template is never spliced (constant-false admit), so it
        # draws its own folded stream instead of replaying `keys`
        self._fresh = self.torch_env.reset_lanes(
            rnd.split(rnd.fold_in(k, 1), self.n_envs), self.params)
        self._carry = self.torch_env.reset_lanes(keys, self.params)
        return self._carry[1].cpu().numpy().astype(np.float64), {}

    def step(self, actions):
        actions = torch.as_tensor(np.asarray(actions),
                                  dtype=torch.int32).to(self.device)
        _, (_, reward, done, info) = self.torch_env.step_lanes(
            self._carry, actions, self._no_admit, self._fresh,
            self._step_all, self.params)
        obs = self._carry[1]  # continuation obs: post-reset at done
        np_done = done.cpu().numpy()
        info = {k: v.cpu().numpy() for k, v in info.items()}
        return (obs.cpu().numpy().astype(np.float64), reward.cpu().numpy(),
                np_done, np.zeros_like(np_done), info)
