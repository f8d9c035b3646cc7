"""Reward/observation/schedule wrappers for the gymnasium adapter (a copy
of cpr_tpu/gym/wrappers.py, which is host code over gymnasium only).

Reference counterpart: gym/ocaml/cpr_gym/wrappers.py:8-289, ported to the
gymnasium 5-tuple step API (terminated/truncated).  Episode end means
`terminated or truncated` throughout.
"""

from __future__ import annotations

import collections
import itertools
import warnings

import gymnasium
import numpy as np


class CprWrapper(gymnasium.Wrapper):
    """Shared base: forwards the `policy` dispatch the reference Core
    exposes (envs.py:58-66) through wrapper stacks — gymnasium 1.x no
    longer auto-forwards attributes."""

    def policy(self, obs, name="honest"):
        return self.env.policy(obs, name)


class SparseRelativeRewardWrapper(CprWrapper):
    """Zero reward until episode end, then attacker/(attacker+defender)
    (wrappers.py:8-26)."""

    def step(self, action):
        obs, _r, term, trunc, info = self.env.step(action)
        reward = 0.0
        if term or trunc:
            a = info["episode_reward_attacker"]
            d = info["episode_reward_defender"]
            reward = a / (a + d) if (a + d) != 0 else 0.0
        return obs, reward, term, trunc, info


class SparseRewardPerProgressWrapper(CprWrapper):
    """Zero reward until episode end, then attacker/progress
    (wrappers.py:29-51) — the right objective for protocols with dynamic
    rewards (Ethereum, Tailstorm discount)."""

    def step(self, action):
        obs, _r, term, trunc, info = self.env.step(action)
        reward = 0.0
        if term or trunc:
            p = info["episode_progress"]
            reward = info["episode_reward_attacker"] / p if p != 0 else 0.0
        return obs, reward, term, trunc, info


class DenseRewardPerProgressWrapper(CprWrapper):
    """Dense per-step attacker reward normalized by a progress target;
    episodes end at that target so the divisor is known upfront, and the
    end-of-episode mismatch is corrected (wrappers.py:54-113)."""

    def __init__(self, env, episode_len: int):
        super().__init__(env)
        self.drpb_max_progress = episode_len
        self.drpb_factor = 1.0 / episode_len
        ck = self.env.unwrapped.core_kwargs
        want = {"max_time": None, "max_steps": episode_len * 100,
                "max_progress": episode_len}
        for k, v in want.items():
            if ck.get(k) is not None and ck[k] != v:
                warnings.warn(
                    f"DenseRewardPerProgressWrapper overwrites '{k}'")
            ck[k] = v

    def reset(self, **kwargs):
        self.drpb_acc = 0.0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        reward = info["step_reward_attacker"] * self.drpb_factor
        self.drpb_acc += reward
        if term or trunc:
            got = info["episode_progress"]
            want = self.drpb_max_progress
            if got < want:
                warnings.warn(f"observed too little progress: {got}/{want}")
            if got > want * 1.1:
                warnings.warn(f"observed too much progress: {got}/{want}")
            if got != want and got != 0:
                reward += (want - got) * self.drpb_acc / got
        return obs, reward, term, trunc, info


class ExtendObservationWrapper(CprWrapper):
    """Append info-derived fields to the observation (wrappers.py:116-153).
    `fields` is a list of (fn(wrapper, info), low, high, default)."""

    def __init__(self, env, fields):
        super().__init__(env)
        if not fields:
            raise ValueError("ExtendObservationWrapper: fields is empty")
        self.eow_fields = fields
        self.eow_n = len(fields)
        low = np.append(self.observation_space.low,
                        [f[1] for f in fields])
        high = np.append(self.observation_space.high,
                         [f[2] for f in fields])
        self.observation_space = gymnasium.spaces.Box(
            low, high, dtype=np.float64)

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        ext = [f[3] for f in self.eow_fields]
        return np.append(obs, ext), info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        ext = [f[0](self, info) for f in self.eow_fields]
        return np.append(obs, ext), reward, term, trunc, info

    def policy(self, obs, name="honest"):
        return self.env.policy(obs[: -self.eow_n], name)


class MapRewardWrapper(CprWrapper):
    """reward <- fn(reward, info) (wrappers.py:156-169)."""

    def __init__(self, env, fn):
        super().__init__(env)
        self.mrw_fn = fn

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        return obs, self.mrw_fn(reward, info), term, trunc, info


class AssumptionScheduleWrapper(CprWrapper):
    """Re-draw alpha/gamma on each reset (constant, iterable cycle, or
    callable schedule), append the assumptions to the observation, report
    them in info; optionally show the agent different ("pretend") values
    (wrappers.py:172-242).  This is what trains assumption-generic
    policies."""

    def __init__(self, env, alpha=None, gamma=None, pretend_alpha=None,
                 pretend_gamma=None):
        super().__init__(env)
        self.asw_alpha_fn = self._scheduler(alpha)
        self.asw_gamma_fn = self._scheduler(gamma)
        self.asw_pretend_alpha = pretend_alpha
        self.asw_pretend_gamma = pretend_gamma
        self.asw_alpha = None
        self.asw_gamma = None
        low = np.append(self.observation_space.low, [0.0, 0.0])
        high = np.append(self.observation_space.high, [1.0, 1.0])
        self.observation_space = gymnasium.spaces.Box(
            low, high, dtype=np.float64)

    @staticmethod
    def _scheduler(x):
        if callable(x):
            return x
        try:
            it = itertools.cycle(x)
            return lambda: next(it)
        except TypeError:
            return lambda: x

    def _observation(self, obs):
        a = (self.asw_alpha if self.asw_pretend_alpha is None
             else float(self.asw_pretend_alpha))
        g = (self.asw_gamma if self.asw_pretend_gamma is None
             else float(self.asw_pretend_gamma))
        return np.append(obs, [a, g])

    def policy(self, obs, name="honest"):
        return self.env.policy(obs[:-2], name)

    def reset(self, **kwargs):
        ck = self.env.unwrapped.core_kwargs
        # None schedule = keep the wrapped env's assumption unchanged
        self.asw_alpha = self.asw_alpha_fn()
        if self.asw_alpha is None:
            self.asw_alpha = ck["alpha"]
        else:
            ck["alpha"] = self.asw_alpha
        self.asw_gamma = self.asw_gamma_fn()
        if self.asw_gamma is None:
            self.asw_gamma = ck["gamma"]
        else:
            ck["gamma"] = self.asw_gamma
        obs, info = self.env.reset(**kwargs)
        return AssumptionScheduleWrapper._observation(self, obs), info

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        info["alpha"] = self.asw_alpha
        info["gamma"] = self.asw_gamma
        obs = AssumptionScheduleWrapper._observation(self, obs)
        return obs, reward, term, trunc, info


class EpisodeRecorderWrapper(CprWrapper):
    """Ring buffer of the last n episodes' rewards + chosen info keys
    (wrappers.py:245-266); feeds per-alpha evaluation aggregation."""

    def __init__(self, env, n: int = 42, info_keys=()):
        super().__init__(env)
        self.erw_info_keys = tuple(info_keys)
        self.erw_history = collections.deque([], maxlen=n)
        self.erw_episode_reward = 0.0

    def reset(self, **kwargs):
        self.erw_episode_reward = 0.0
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self.erw_episode_reward += reward
        if term or trunc:
            entry = {k: info[k] for k in self.erw_info_keys}
            entry["episode_reward"] = self.erw_episode_reward
            self.erw_history.append(entry)
        return obs, reward, term, trunc, info


class ClearInfoWrapper(CprWrapper):
    """Keep only `keep_keys` in info — cuts IPC cost before
    vectorization (wrappers.py:269-289)."""

    def __init__(self, env, keep_keys=()):
        super().__init__(env)
        self.ciw_keys = tuple(keep_keys)

    def step(self, action):
        obs, reward, term, trunc, was_info = self.env.step(action)
        info = {k: was_info[k] for k in self.ciw_keys if k in was_info}
        return obs, reward, term, trunc, info
