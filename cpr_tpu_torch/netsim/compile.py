"""Compile a `network.Network` into dense planes (port of
cpr_tpu/netsim/compile.py).

The row-major (src * n + dst) link encoding of the oracle's custom
topology API (kind/p0/p1 triples, kind -1 for "no link"), kept as numpy
planes; the engines move them to the card. `sample_delay_matrix` is the
plain version of the per-link delay draw the kernels make
(`csrc/netsim.cuh` `link_delay`): the same float64 draws from the same
key as the JAX package's.

Link delays are constant, uniform, exponential or geometric; `discrete`
is rejected at compile time, before any device work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.distributions import GEOM_TAIL_CLAMP
from cpr_tpu_torch.network import Network

# link-delay kinds the delay sampler implements (csrc/netsim.cuh)
NETSIM_KINDS = {"constant": 0, "uniform": 1, "exponential": 2,
                "geometric": 3}


@dataclass(frozen=True)
class CompiledNet:
    """Dense topology: per-node compute weights plus row-major per-edge
    (kind, p0, p1) delay planes, kind -1 = no link."""
    n: int
    compute: np.ndarray        # (N,) f32, normalized to sum 1
    kind: np.ndarray           # (N, N) i32, NETSIM_KINDS or -1
    p0: np.ndarray             # (N, N) f64
    p1: np.ndarray             # (N, N) f64
    activation_delay: float
    flooding: bool


def compile_network(net: Network) -> CompiledNet:
    if net.dissemination not in ("simple", "flooding"):
        raise ValueError(f"unknown dissemination '{net.dissemination}'")
    n = len(net.nodes)
    if n < 2:
        raise ValueError("netsim needs at least 2 nodes")
    compute = np.array([nd.compute for nd in net.nodes], np.float64)
    total = compute.sum()
    if not (total > 0):
        raise ValueError("total compute must be positive")
    kind = np.full((n, n), -1, np.int32)
    p0 = np.zeros((n, n), np.float64)
    p1 = np.zeros((n, n), np.float64)
    for i, nd in enumerate(net.nodes):
        for link in nd.links:
            d = link.delay
            if d.kind not in NETSIM_KINDS:
                raise ValueError(
                    f"netsim supports constant/uniform/exponential/"
                    f"geometric link delays, not '{d.kind}'")
            kind[i, link.dest] = NETSIM_KINDS[d.kind]
            p0[i, link.dest] = d.params[0]
            p1[i, link.dest] = d.params[1] if len(d.params) > 1 else 0.0
    return CompiledNet(
        n=n, compute=(compute / total).astype(np.float32), kind=kind,
        p0=p0, p1=p1, activation_delay=float(net.activation_delay),
        flooding=net.dissemination == "flooding")


def sample_delay_matrix(key, kind, p0, p1):
    """One float64 draw of every link's delay in the planes: for keys
    `key` [..., 2] and planes of shape [..., R, N] (or [R, N]), the
    uniform and exponential draws of element (r, n) sit at flat index
    r * N + n of the two halves of `split(key)`, as in the JAX package.
    Returns [..., R, N]; unlinked entries hold garbage that callers mask
    by kind >= 0."""
    shape = tuple(kind.shape[-2:])
    ks = rnd.split(key)
    u = rnd.uniform(ks[..., 0, :], shape, GEOM_TAIL_CLAMP, 1.0,
                    dtype=torch.float64)
    e = rnd.exponential(ks[..., 1, :], shape, dtype=torch.float64)
    return delay_of_draws(kind, p0, p1, u, e)


def clamp_uniform(u: torch.Tensor) -> torch.Tensor:
    """A float64 uniform on [0, 1) -> jax.random.uniform's on
    [GEOM_TAIL_CLAMP, 1): max(lo, u * (hi - lo) + lo)."""
    lo = GEOM_TAIL_CLAMP
    return torch.clamp(u * (1.0 - lo) + lo, min=lo)


def delay_of_draws(kind, p0, p1, u, e):
    """The delays of `sample_delay_matrix` from its uniform draws u (on
    [GEOM_TAIL_CLAMP, 1)) and exponential draws e."""
    unif = p0 + u * (p1 - p0)
    expo = e * p0
    # geometric: trials to first success at prob p0, >= 1; p0 >= 1 is 1
    log1mp = torch.log(torch.clamp(1.0 - p0, 1e-300, 1.0))
    geom = torch.where(p0 >= 1.0, 1.0,
                       torch.clamp(torch.ceil(torch.log(u) / log1mp),
                                   min=1.0))
    return torch.where(kind == 0, p0,
                       torch.where(kind == 1, unif,
                                   torch.where(kind == 2, expo, geom)))
