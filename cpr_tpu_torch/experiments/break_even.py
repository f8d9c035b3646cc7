"""Break-even search: the smallest alpha where an attack beats honesty.

Reference counterpart: `cpr_tpu/experiments/break_even.py`, its exact
half: `exact_revenue_curve` and `break_even_exact` read the optimal
attack's revenue over an alpha grid from one cached grid solve of the
exact MDP (`cpr_tpu_torch.mdp.grid.solve_grid_cached`: one parametric
compile, one grid VI on kernel K7, a sealed disk cache keyed by content
fingerprint), and `_cached` memoizes any JSON-safe result in the same
sealed format. The Monte-Carlo half (`revenue`, `break_even`) needs the
DAG protocol environments and the experiments of ROADMAP item 9, and
raises.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

import cpr_tpu_torch
from cpr_tpu_torch import integrity, resilience

# override with CPR_TPU_CACHE; delete the directory to empty the cache
_CACHE_DIR = os.environ.get(
    "CPR_TPU_CACHE",
    os.path.join(os.path.expanduser("~"), ".cache", "cpr_tpu",
                 "break_even"))

MONTE_CARLO_QUEUED = (
    "the Monte-Carlo break-even (revenue, break_even) needs the "
    "experiments of ROADMAP item 9, not ported yet; use break_even_exact")


def _cached(key: dict, compute):
    """`compute()` memoized on disk as a sealed JSON entry keyed by `key`
    (salted with the package version). A damaged entry is a miss: it is
    quarantined with a typed `integrity` event and recomputed."""
    os.makedirs(_CACHE_DIR, exist_ok=True)
    key = dict(key, _version=cpr_tpu_torch.__version__)
    h = hashlib.sha256(
        json.dumps(key, sort_keys=True).encode()).hexdigest()[:24]
    path = os.path.join(_CACHE_DIR, h + ".json")
    if os.path.exists(path):
        try:
            data, _ = resilience.sealed_read_json(
                path, kind="break_even_cache", action="regenerated")
            return data["value"]
        except resilience.IntegrityError:
            pass
        except (OSError, KeyError, TypeError):
            integrity.quarantine(path, kind="break_even_cache",
                                 reason="truncated", action="regenerated")
    value = compute()
    resilience.sealed_write_json(path, {"key": key, "value": value},
                                 site="cache")
    return value


def revenue(*args, **kwargs):
    raise NotImplementedError(MONTE_CARLO_QUEUED)


def break_even(*args, **kwargs):
    raise NotImplementedError(MONTE_CARLO_QUEUED)


def exact_revenue_curve(protocol: str, *, gamma: float, cutoff: int,
                        alphas, horizon: int = 100,
                        stop_delta: float = 1e-6, native: bool = False,
                        k: int = 2, mesh=None, full: bool = False,
                        device=None):
    """Optimal-attack revenue over `alphas` at fixed gamma from one
    cached grid solve of the exact MDP (solve_grid_cached). `full=True`
    returns a dict with `revenue`, `alphas`, `cached` (a disk-cache hit)
    and the ParamMDP content `fingerprint`."""
    from cpr_tpu_torch.mdp.grid import solve_grid_cached

    out = solve_grid_cached(protocol, cutoff=cutoff, alphas=alphas,
                            gammas=(gamma,), horizon=horizon,
                            stop_delta=stop_delta, native=native, k=k,
                            mesh=mesh, device=device)
    rev = [float(r) for r in out["revenue"]]
    if full:
        return dict(revenue=rev, alphas=[float(a) for a in out["alphas"]],
                    cached=bool(out["cached"]),
                    fingerprint=out["fingerprint"])
    return rev


def break_even_exact(protocol: str, *, gamma: float, cutoff: int,
                     support=(0.1, 0.5), grid: int = 17,
                     horizon: int = 100, stop_delta: float = 1e-6,
                     native: bool = False, k: int = 2,
                     mesh=None, full: bool = False, device=None):
    """Exact-MDP break-even alpha: the root of revenue(alpha)/alpha - 1
    for the optimal attack, from one cached grid solve over `grid`
    evenly spaced alphas in `support`, located by sign change and refined
    by linear interpolation between the bracketing points; clipped to
    the support where the attack is never/always profitable there.
    `full=True` adds the solve-cache provenance (`cached`,
    `fingerprint`)."""
    lo, hi = support
    alphas = list(np.linspace(lo, hi, grid))
    out = exact_revenue_curve(protocol, gamma=gamma, cutoff=cutoff,
                              alphas=alphas, horizon=horizon,
                              stop_delta=stop_delta, native=native,
                              k=k, mesh=mesh, full=True, device=device)
    rev = out["revenue"]
    excess = [r / a - 1.0 for r, a in zip(rev, alphas)]

    def wrap(alpha):
        if full:
            return dict(alpha=float(alpha), cached=out["cached"],
                        fingerprint=out["fingerprint"])
        return float(alpha)

    if excess[0] > 0:
        return wrap(lo)
    if excess[-1] < 0:
        return wrap(hi)
    for i in range(1, len(alphas)):
        if excess[i] > 0:
            a0, a1 = alphas[i - 1], alphas[i]
            e0, e1 = excess[i - 1], excess[i]
            if e1 == e0:
                return wrap(0.5 * (a0 + a1))
            return wrap(a0 + (a1 - a0) * (0.0 - e0) / (e1 - e0))
    return wrap(hi)
