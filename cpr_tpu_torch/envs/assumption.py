"""Assumption-aware env wrapper (port of cpr_tpu/envs/assumption.py).

Reference counterpart: AssumptionScheduleWrapper
(gym/ocaml/cpr_gym/wrappers.py:172-242): the observation is extended by
the lane's (alpha, gamma), so one policy can generalize over them. The
schedule lives in the batch: each lane carries its own EnvParams.

On CUDA the wrapper runs the inner env's kernels (K2/K3 or the env's
K10) with `extend_obs`, which appends the lane's two params to the
encoded observation, in the net's input and in the stored trajectory
alike; the plain twins extend the inner env's observation here.
"""

from __future__ import annotations

import torch

from cpr_tpu_torch.envs.base import TorchEnv


class AssumptionEnv(TorchEnv):
    def __init__(self, inner: TorchEnv):
        self.inner = inner
        self.n_actions = inner.n_actions
        self.observation_length = inner.observation_length + 2
        self.unit_observation = inner.unit_observation
        self.low = torch.cat([torch.as_tensor(inner.low, dtype=torch.float32),
                              torch.zeros(2)])
        self.high = torch.cat([torch.as_tensor(inner.high,
                                               dtype=torch.float32),
                               torch.ones(2)])
        self.scripted_policies = inner.scripted_policies
        self.reset_dag_rows = inner.reset_dag_rows
        self.kernel_item = inner.kernel_item
        self.policies = {name: self._strip(fn, name)
                         for name, fn in inner.policies.items()}

    def _strip(self, fn, name):
        if getattr(fn, "takes_state", False):
            def wrapped(state, obs):
                return fn(state, obs[..., :-2])
            wrapped.takes_state = True
        else:
            def wrapped(obs):
                return fn(obs[..., :-2])
        if getattr(fn, "policy_owner", None) is type(self.inner):
            wrapped.policy_owner = type(self)
            wrapped.policy_name = fn.policy_name
        return wrapped

    @staticmethod
    def _extend(obs, params):
        """obs [L, F] -> [L, F + 2] with each lane's (alpha, gamma)."""
        n = obs.shape[0]
        ag = torch.stack([
            torch.broadcast_to(params.alpha.to(obs.device, torch.float32),
                               (n,)),
            torch.broadcast_to(params.gamma.to(obs.device, torch.float32),
                               (n,))], dim=1)
        return torch.cat([obs, ag.to(obs.dtype)], dim=1)

    def reset(self, keys, params):
        state, obs = self.inner.reset(keys, params)
        return state, self._extend(obs, params)

    def step(self, state, action, params):
        state, obs, reward, done, info = self.inner.step(state, action,
                                                         params)
        return state, self._extend(obs, params), reward, done, info

    def policy_from_ints(self, policy_id: int, state):
        return self.inner.policy_from_ints(policy_id, state)

    # -- kernel hooks: the inner env's kernels with extend_obs -------------

    def _empty_carry(self, n: int, device):
        state, _ = self.inner._empty_carry(n, device)
        return state, torch.empty((n, self.observation_length),
                                  dtype=torch.float32, device=device)

    def _kernel_stream(self, carry, keys, init_mode, length, params,
                       policy_id, with_sums, store_traj, net=None):
        return self.inner._kernel_stream(
            carry, keys, init_mode, length, params, policy_id, with_sums,
            store_traj, net=net, extend_obs=True)

    def _kernel_step_lanes(self, carry, actions, admit_mask, fresh_states,
                           step_mask, params):
        return self.inner._kernel_step_lanes(
            carry, actions, admit_mask, fresh_states, step_mask, params,
            extend_obs=True)
