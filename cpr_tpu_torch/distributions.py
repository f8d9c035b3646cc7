"""Distribution samplers + string round-trip (port of
cpr_tpu/distributions.py).

Reference counterpart: simulator/lib/distributions.ml — constant /
uniform / exponential / geometric samplers, the Vose alias method for
weighted discrete draws (:12-98), and the string grammar used by
GraphML-driven network configs (`constant 1`, `uniform 0 2`,
`exponential 1.2`; :100-153).

Two faces per distribution: `sample(rng)` for host-side simulation
(the C++ oracle and the network sims), and `sample_torch(key)`, the
JAX package's `sample_jax(key)` over `cpr_tpu_torch.random`: the same
float32 draws from the same key, bit for bit where no log is involved
(log and log1p may differ from XLA's by an ULP).
"""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from cpr_tpu_torch import random as rnd

# Shared tail clamp for the geometric inverse-CDF on both faces: the
# host sampler used 1e-300 while the JAX face used 1e-12, so the two
# engines had different support ceilings for the same declaration
# (ceil(log u / log(1-p)) at the clamp).  One constant keeps
# sample(rng) and sample_torch(key) — and netsim's dense delay sampler —
# on the same bound; tests/test_distributions.py asserts the faces
# agree on support and mean for every kind.
GEOM_TAIL_CLAMP = 1e-12


@dataclass(frozen=True)
class Distribution:
    kind: str  # constant | uniform | exponential | geometric | discrete
    params: tuple

    def sample(self, rng: random.Random) -> float:
        k, p = self.kind, self.params
        if k == "constant":
            return p[0]
        if k == "uniform":
            return rng.uniform(p[0], p[1])
        if k == "exponential":
            return rng.expovariate(1.0 / p[0])  # p[0] = expected value
        if k == "geometric":
            # trials until first success at probability p[0]; >= 1
            if p[0] >= 1.0:
                return 1.0
            return max(1.0, float(int(np.ceil(
                np.log(max(rng.random(), GEOM_TAIL_CLAMP))
                / np.log(1.0 - p[0])))))
        if k == "discrete":
            return float(rng.choices(range(len(p)), weights=p)[0])
        raise ValueError(k)

    def sample_torch(self, key):
        """One float32 draw from `key` (an int32 key [2]), as
        `cpr_tpu.distributions.Distribution.sample_jax` draws it."""
        k, p = self.kind, self.params

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=key.device)

        if k == "constant":
            return f32(p[0])
        if k == "uniform":
            return rnd.uniform(key, (), p[0], p[1])
        if k == "exponential":
            return rnd.exponential(key) * f32(p[0])
        if k == "geometric":
            if p[0] >= 1.0:
                return f32(1.0)
            u = rnd.uniform(key, (), GEOM_TAIL_CLAMP, 1.0)
            return torch.clamp(torch.ceil(torch.log(u)
                                          / torch.log(f32(1.0 - p[0]))),
                               min=1.0)
        if k == "discrete":
            w = torch.tensor(p, dtype=torch.float32, device=key.device)
            return rnd.categorical(key, torch.log(w)).to(torch.float32)
        raise ValueError(k)

    @property
    def ev(self) -> float:
        """Expected value (the R generator's `distance` semantics:
        every delay distribution is parameterized so its mean is the
        link distance, create-networks.R:20-33)."""
        k, p = self.kind, self.params
        if k == "constant":
            return float(p[0])
        if k == "uniform":
            return (p[0] + p[1]) / 2.0
        if k == "exponential":
            return float(p[0])
        if k == "geometric":
            return 1.0 / p[0] if p[0] > 0 else float("inf")
        if k == "discrete":
            t = sum(p)
            return sum(i * w for i, w in enumerate(p)) / t if t else 0.0
        raise ValueError(k)

    def to_string(self) -> str:
        fmt = " ".join(_fmt_float(x) for x in self.params)
        return f"{self.kind} {fmt}"


def _fmt_float(x: float) -> str:
    return str(int(x)) if float(x).is_integer() else repr(float(x))


def constant(value: float) -> Distribution:
    return Distribution("constant", (float(value),))


def uniform(lower: float, upper: float) -> Distribution:
    assert lower <= upper
    return Distribution("uniform", (float(lower), float(upper)))


def exponential(ev: float) -> Distribution:
    assert ev > 0
    return Distribution("exponential", (float(ev),))


def geometric(p: float) -> Distribution:
    assert 0.0 < p <= 1.0
    return Distribution("geometric", (float(p),))


def discrete(weights) -> Distribution:
    ws = tuple(float(w) for w in weights)
    assert ws and all(w >= 0 for w in ws) and sum(ws) > 0
    return Distribution("discrete", ws)


def of_string(s: str) -> Distribution:
    """Parse the reference grammar (distributions.ml:100-141):
    `constant X`, `uniform LO HI`, `exponential EV`, plus `geometric P`
    and `discrete W...`; round-trips with to_string."""
    parts = s.split()
    if not parts:
        raise ValueError("empty distribution string")
    kind, args = parts[0], parts[1:]
    try:
        vals = [float(a) for a in args]
    except ValueError:
        raise ValueError(f"cannot parse distribution '{s}'")
    arity = {"constant": 1, "uniform": 2, "exponential": 1,
             "geometric": 1}
    if kind == "discrete":
        if not vals:
            raise ValueError(f"cannot parse distribution '{s}'")
        return discrete(vals)
    if kind not in arity:
        raise ValueError(f"unknown distribution '{kind}'")
    if len(vals) != arity[kind]:
        raise ValueError(
            f"'{kind}' takes {arity[kind]} parameter(s), got {len(vals)}")
    return {"constant": constant, "uniform": lambda a, b: uniform(a, b),
            "exponential": exponential,
            "geometric": geometric}[kind](*vals)
