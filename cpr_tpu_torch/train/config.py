"""Training configuration (port of cpr_tpu/train/config.py).

Reference counterpart: experiments/train/cfg_model/__init__.py:12-137 —
the protocol key, the alpha schedule (fixed, list or range), the env,
PPO and eval blocks, parsed from YAML (cpr_tpu/train/configs/*.yaml).

The JAX package's models are pydantic's; here they are dataclasses with
the same fields, defaults, validators and messages, built from a plain
dict by `from_dict` (pydantic and yaml are absent on the card's
machine). `from_yaml` imports yaml only when it is called. Values are
coerced as the reference's lax pydantic mode does for these fields:
numbers to float or int, a {min, max} map to `Range`, a list to floats;
unknown keys are ignored.
"""

from __future__ import annotations

import dataclasses
from typing import List, Union

import numpy as np

REWARDS = ("sparse_relative", "sparse_per_progress", "dense_per_progress")
SHAPES = ("raw", "cut", "exp")


def _coerce(cls, d: dict, where: str):
    if not isinstance(d, dict):
        raise ValueError(f"{where}: expected a mapping, got "
                         f"{type(d).__name__}")
    out = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = f.type
        try:
            if t in ("float", float):
                v = float(v)
            elif t in ("int", int):
                if isinstance(v, float) and not v.is_integer():
                    raise ValueError(f"{v} is not an integer")
                v = int(v)
            elif t in ("bool", bool):
                if not isinstance(v, (bool, int)):
                    raise ValueError(f"{v!r} is not a bool")
                v = bool(v)
            elif t == "float | None":
                v = None if v is None else float(v)
        except (TypeError, ValueError) as e:
            raise ValueError(f"{where}.{f.name}: {e}") from None
        out[f.name] = v
    return out


@dataclasses.dataclass(frozen=True)
class Range:
    min: float
    max: float

    @classmethod
    def from_dict(cls, d: dict) -> "Range":
        missing = [k for k in ("min", "max") if k not in d]
        if missing:
            raise ValueError(f"alpha range: missing {missing}")
        return cls(**_coerce(cls, d, "alpha"))


Alpha = Union[float, List[float], Range]


@dataclasses.dataclass(frozen=True)
class PPOBlock:
    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    n_steps: int = 128
    n_minibatches: int = 4
    update_epochs: int = 4
    n_layers: int = 2
    layer_size: int = 64
    anneal_lr: bool = False
    # KL-adaptive early stop (sb3 target_kl): skip remaining minibatch
    # updates once approx KL > 1.5 * target_kl.  None = off.
    target_kl: float | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "PPOBlock":
        return cls(**_coerce(cls, d, "ppo"))


@dataclasses.dataclass(frozen=True)
class EvalBlock:
    # evaluate every `freq` updates, skipping the first
    # `start_at_iteration` (cfg_model/__init__.py:80-105)
    freq: int = 10
    start_at_iteration: int = 1
    alpha_step: float = 0.025
    episodes_per_alpha: int = 64

    @classmethod
    def from_dict(cls, d: dict) -> "EvalBlock":
        return cls(**_coerce(cls, d, "eval"))


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    protocol: str = "nakamoto"
    alpha: Alpha = 0.33
    gamma: float = 0.5
    episode_len: int = 128
    # dense_per_progress mirrors the reference's DenseRewardPerProgress
    # wrapper (gym/ocaml/cpr_gym/wrappers.py:54-113)
    reward: str = "sparse_relative"
    shape: str = "raw"
    n_envs: int = 256
    total_updates: int = 200
    seed: int = 0
    # best-checkpoint revert-on-collapse: after an eval scoring below
    # `revert_frac` x the best score so far, training restarts from the
    # best checkpoint (fresh optimizer state).  None = off.
    revert_frac: float | None = None
    ppo: PPOBlock = PPOBlock()
    eval: EvalBlock = EvalBlock()

    def __post_init__(self):
        if not 0.0 <= self.gamma < 1.0:
            raise ValueError("gamma must be in [0, 1)")
        if self.reward not in REWARDS:
            raise ValueError(f"reward must be one of {REWARDS}, got "
                             f"{self.reward!r}")
        if self.shape not in SHAPES:
            raise ValueError(f"shape must be one of {SHAPES}, got "
                             f"{self.shape!r}")
        if self.reward == "dense_per_progress" and self.shape != "raw":
            raise ValueError(
                "dense_per_progress emits per-step rewards; the sparse "
                "end-of-episode shapings (cut/exp) do not apply")

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        """Validate a dict as the reference's `TrainConfig.model_validate`
        does (the YAML files' content)."""
        if not isinstance(d, dict):
            raise ValueError("a train config is a mapping")
        kw = _coerce(cls, {k: v for k, v in d.items()
                           if k not in ("alpha", "ppo", "eval")}, "config")
        if "protocol" in d:
            kw["protocol"] = str(d["protocol"])
        for k in ("reward", "shape"):
            if k in d:
                kw[k] = d[k]
        if "alpha" in d:
            kw["alpha"] = _alpha(d["alpha"])
        if "ppo" in d:
            kw["ppo"] = PPOBlock.from_dict(d["ppo"])
        if "eval" in d:
            kw["eval"] = EvalBlock.from_dict(d["eval"])
        return cls(**kw)

    @classmethod
    def from_yaml(cls, path: str) -> "TrainConfig":
        import yaml
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    # -- schedule helpers ------------------------------------------------

    def alpha_is_scheduled(self) -> bool:
        return not isinstance(self.alpha, float)

    def lane_alphas(self, n: int) -> np.ndarray:
        """Per-env-lane alphas covering the schedule."""
        if isinstance(self.alpha, float):
            return np.full(n, self.alpha)
        if isinstance(self.alpha, Range):
            return np.linspace(self.alpha.min, self.alpha.max, n)
        return np.asarray(
            [self.alpha[i % len(self.alpha)] for i in range(n)])

    def eval_alphas(self) -> np.ndarray:
        if isinstance(self.alpha, float):
            return np.asarray([self.alpha])
        if isinstance(self.alpha, Range):
            n = max(2, int(round(
                (self.alpha.max - self.alpha.min) / self.eval.alpha_step)) + 1)
            return np.linspace(self.alpha.min, self.alpha.max, n)
        return np.asarray(sorted(set(self.alpha)))


def _alpha(v) -> Alpha:
    if isinstance(v, dict):
        return Range.from_dict(v)
    if isinstance(v, (list, tuple)):
        return [float(x) for x in v]
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(f"alpha: expected a number, a list or a "
                         f"{{min, max}} range, got {v!r}")
    return float(v)
