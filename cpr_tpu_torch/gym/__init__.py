"""gymnasium plugin boundary of the port: env ids + composed env factory
(port of cpr_tpu/gym/__init__.py).

Reference counterpart: gym/ocaml/cpr_gym/envs.py:96-192. Importing this
module registers `core-torch-v0`, `cpr-torch-v0`, `cpr-nakamoto-torch-v0`
and `cpr-tailstorm-torch-v0`. The ids differ from the JAX package's
(`core-v0`, `cpr-v0`, `cpr-nakamoto-v0`, `cpr-tailstorm-v0`): gymnasium
keeps the first registration of an id, so in a process that imports both
packages a shared id would silently resolve to whichever registered
first. The FC16 and generic ids (`FC16SSZwPT-v0`, `cpr-generic-v0`) wait
for `gym/generic_env.py` (ROADMAP item 7c).
"""

from __future__ import annotations

import gymnasium

from cpr_tpu_torch.gym import wrappers
from cpr_tpu_torch.gym.envs import BatchedCore, Core


def env_fn(protocol="nakamoto", protocol_args=None,
           _protocol_args=None, episode_len=128, alpha=0.45,
           gamma=0.5, pretend_alpha=None, pretend_gamma=None,
           defenders=None, reward="sparse_relative",
           normalize_reward=True, seed=0, device=None):
    """Composed environment (reference env_fn, envs.py:99-163):
    Core + assumption schedule + reward shaping + normalization."""
    protocol_args = {**(_protocol_args or {}), **(protocol_args or {})}

    rewards = {
        "sparse_relative": (
            wrappers.SparseRelativeRewardWrapper,
            dict(max_steps=episode_len)),
        "sparse_per_progress": (
            wrappers.SparseRewardPerProgressWrapper,
            dict(max_steps=episode_len)),
        # same bounds the wrapper will install, so it overwrites nothing
        "dense_per_progress": (
            lambda env: wrappers.DenseRewardPerProgressWrapper(
                env, episode_len=episode_len),
            dict(max_steps=episode_len * 100, max_progress=episode_len)),
    }
    try:
        reward_wrapper, env_args = rewards[reward]
    except KeyError:
        raise ValueError(
            f"unknown reward '{reward}'; choose from {sorted(rewards)}")

    env = Core(protocol, alpha=0.25, gamma=0.0, defenders=defenders,
               seed=seed, device=device, **env_args, **protocol_args)
    env = wrappers.AssumptionScheduleWrapper(
        env, alpha=alpha, gamma=gamma,
        pretend_alpha=pretend_alpha, pretend_gamma=pretend_gamma)
    env.reset()  # apply the schedule's first alpha/gamma draw
    env = reward_wrapper(env)
    if normalize_reward:
        env = wrappers.MapRewardWrapper(env, lambda r, i: r / i["alpha"])
    return env


ENV_IDS = ("core-torch-v0", "cpr-torch-v0", "cpr-nakamoto-torch-v0",
           "cpr-tailstorm-torch-v0")


def _register():
    specs = [
        dict(id="core-torch-v0", entry_point=Core),
        dict(id="cpr-torch-v0", entry_point=env_fn),
        dict(id="cpr-nakamoto-torch-v0", entry_point=env_fn,
             kwargs=dict(protocol="nakamoto", reward="sparse_relative")),
        dict(id="cpr-tailstorm-torch-v0", entry_point=env_fn,
             kwargs=dict(protocol="tailstorm",
                         _protocol_args=dict(
                             k=8, incentive_scheme="discount",
                             subblock_selection="heuristic"),
                         reward="sparse_per_progress")),
    ]
    for spec in specs:  # per-id guard: re-import must be idempotent
        if spec["id"] not in gymnasium.envs.registry:
            gymnasium.register(**spec)


_register()

__all__ = ["Core", "BatchedCore", "env_fn", "wrappers", "ENV_IDS"]
