"""Environment parameters (port of cpr_tpu/params.py).

Mirror of the reference gym parameter record and its validation
(reference: simulator/gym/engine.ml:5-52) plus the defender-count
derivation from gamma (reference: gym/ocaml/cpr_gym/envs.py:70-82).

The fields are 0-dim float32/int32 tensors on the host, the dtypes the
JAX package uses: alpha and gamma stay float32, so the Bernoulli draws
compare `uniform < alpha` in float32 on every path. A kernel reads them
as scalars at launch; the plain versions combine them with tensors on
any device. `stack_params` gives them a leading axis for per-lane sweeps
in the plain versions.
"""

from __future__ import annotations

import dataclasses
import math

import torch


class ParameterError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Selfish-mining environment parameters.

    alpha: attacker share of compute, 0 <= alpha <= 1.
    gamma: attacker network advantage, 0 <= gamma < 1. When the attacker
        matches a freshly arrived defender block, a `gamma` fraction of
        defender compute mines on the attacker's release.
    defenders: number of defender nodes the reference would instantiate;
        kept for parity of the derived quantities, the collapsed engine
        models the defenders as one cloud.
    activation_delay: mean time between puzzle solutions (difficulty).
    max_steps / max_progress / max_time: episode termination criteria
        (reference: simulator/gym/engine.ml:209-214).
    """

    alpha: torch.Tensor  # float32
    gamma: torch.Tensor  # float32
    defenders: torch.Tensor  # int32
    activation_delay: torch.Tensor  # float32
    max_steps: torch.Tensor  # int32
    max_progress: torch.Tensor  # float32
    max_time: torch.Tensor  # float32

    def replace(self, **kwargs) -> "EnvParams":
        return dataclasses.replace(self, **kwargs)


FIELDS = tuple(f.name for f in dataclasses.fields(EnvParams))
INT_FIELDS = ("defenders", "max_steps")


def make_params(
    *,
    alpha: float,
    gamma: float,
    defenders: int | None = None,
    activation_delay: float = 1.0,
    max_steps: int | None = None,
    max_progress: float | None = None,
    max_time: float | None = None,
) -> EnvParams:
    """Validate and build EnvParams.

    Validation mirrors reference simulator/gym/engine.ml:37-51; the
    defenders-from-gamma rule mirrors gym/ocaml/cpr_gym/envs.py:70-82.
    """
    if math.isnan(activation_delay):
        raise ParameterError("activation_delay cannot be NaN")
    if math.isnan(alpha):
        raise ParameterError("alpha cannot be NaN")
    if math.isnan(gamma):
        raise ParameterError("gamma cannot be NaN")
    if alpha < 0.0 or alpha > 1.0:
        raise ParameterError("alpha < 0 || alpha > 1")
    if gamma < 0.0 or gamma > 1.0:
        raise ParameterError("gamma < 0 || gamma > 1")
    if activation_delay <= 0.0:
        raise ParameterError("activation_delay <= 0")
    if max_steps is None and max_progress is None and max_time is None:
        raise ParameterError(
            "set at least one of max_steps, max_progress, max_time"
        )
    if defenders is None:
        if gamma >= 1.0:
            raise ParameterError("gamma must be smaller than 1")
        defenders = max(2, int(math.ceil(1.0 / (1.0 - gamma))))
    if defenders < 1:
        raise ParameterError("defenders < 1")
    max_steps = max_steps if max_steps is not None else (1 << 30)
    max_progress = max_progress if max_progress is not None else float("inf")
    max_time = max_time if max_time is not None else float("inf")
    if max_steps <= 0:
        raise ParameterError("max_steps <= 0")
    if max_progress <= 0.0:
        raise ParameterError("max_progress <= 0")
    if max_time <= 0.0:
        raise ParameterError("max_time <= 0")
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    return EnvParams(
        alpha=f32(alpha),
        gamma=f32(gamma),
        defenders=i32(defenders),
        activation_delay=f32(activation_delay),
        max_steps=i32(max_steps),
        max_progress=f32(max_progress),
        max_time=f32(max_time),
    )


def stack_params(kwargs_list) -> EnvParams:
    """Stack many make_params(**kwargs) into one EnvParams whose fields
    carry a leading axis — the batched form for per-lane sweeps."""
    ps = [make_params(**kw) for kw in kwargs_list]
    return EnvParams(**{f: torch.stack([getattr(p, f) for p in ps])
                        for f in FIELDS})
