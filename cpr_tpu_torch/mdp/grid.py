"""Parametric MDP compile + grid-batched value iteration.

Reference counterpart: `cpr_tpu/mdp/grid.py`. For a fixed protocol and
cutoff the transition structure (src, act, dst, reward, progress) is the
same at every (alpha, gamma); only the probability column changes, and
each entry is a monomial in alpha, 1-alpha, gamma, 1-gamma. So:

* **Parametric compile.** The implicit models run with a monomial
  tracer (`Param`) bound to alpha and gamma, and one BFS (the frontier
  compiler) yields a `ParamMDP`: the compiled columns at a probe point
  plus per-row exponents and coefficients, so `revalue(alpha, gamma)`
  gives any point's probability column without a recompile. The native
  compiler's tables are parametrised by matching each emitted
  probability against its closed key set (`parametric_compile_native`).
* **Grid solve.** `grid_value_iteration` revalues every point into a
  [G, T] plane and runs the chunked VI of all points at once
  (`cpr_tpu_torch.parallel.make_grid_chunk_step`: kernel K7 on the card,
  its plain twin on the CPU), freezing each point at the chunk boundary
  where it converged. A point's fixpoint, policy and sweep count are bit
  for bit a solo `vi_chunked(accel_m=0)` solve of its revalued table.

`check_revalue_parity` guards the tracer against fresh compiles;
`solve_grid_cached` keeps whole solved grids in a sealed JSON cache
keyed by the ParamMDP's content fingerprint.

Not ported: the Python generic model (`compile_protocol("bitcoin" |
"ghostdag", native=False)` raises; ROADMAP slice 3, item 7c), grid
checkpoints (ROADMAP item 6) and the `mesh=`/`state_axis=` sharded
solves (K16, ROADMAP item 13).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from cpr_tpu_torch.mdp.compiler import Compiler
from cpr_tpu_torch.mdp.explicit import MDP, ptmdp
from cpr_tpu_torch.telemetry import now

# interior probe values for the tracer / exponent recovery; exponent
# recovery needs the 9 native monomial keys pairwise distinct (asserted
# at compile time), which these values give with a wide margin
PROBE_ALPHA = 0.3137557218
PROBE_GAMMA = 0.7243031127

_ONE = (0, 0, 0, 0)
# 1 - x on a coefficient-1 single-variable monomial flips it to the
# complementary variable: 1 - a = (1-a), 1 - (1-a) = a, same for g
_COMPLEMENT = {
    (1, 0, 0, 0): (0, 1, 0, 0),
    (0, 1, 0, 0): (1, 0, 0, 0),
    (0, 0, 1, 0): (0, 0, 0, 1),
    (0, 0, 0, 1): (0, 0, 1, 0),
}

PYTHON_GENERIC_QUEUED = (
    "the Python generic model (mdp/generic/{model,dag,canon,sim}.py and "
    "protocols/) is not ported yet: ROADMAP item 7c; use native=True")


class ParamError(TypeError):
    """An implicit model used alpha/gamma outside the monomial algebra
    the parametric compile supports (products and 1-x only)."""


class Param:
    """Monomial tracer: `coef * alpha^i (1-alpha)^j gamma^k (1-gamma)^l`.

    Supports the algebra the implicit models use on their parameters —
    multiplication (by numbers and other monomials) and the complement
    `1 - x` of a bare variable — plus float(), comparisons and
    addition, which exits to plain probe-value floats (the compiler only
    sums probabilities to check them). Anything else raises ParamError."""

    __slots__ = ("coef", "expo", "value")

    def __init__(self, coef: float, expo: tuple, value: float):
        self.coef = float(coef)
        self.expo = tuple(int(e) for e in expo)
        self.value = float(value)

    def __repr__(self):
        i, j, k, l = self.expo
        return (f"Param({self.coef:g} * a^{i} (1-a)^{j} g^{k} (1-g)^{l}"
                f" = {self.value:g})")

    def _mul(self, other):
        if isinstance(other, Param):
            return Param(self.coef * other.coef,
                         tuple(a + b for a, b in zip(self.expo,
                                                     other.expo)),
                         self.value * other.value)
        if isinstance(other, (int, float)):
            return Param(self.coef * other, self.expo,
                         self.value * other)
        return NotImplemented

    __mul__ = _mul
    __rmul__ = _mul

    def __rsub__(self, other):
        comp = _COMPLEMENT.get(self.expo)
        if (isinstance(other, (int, float)) and float(other) == 1.0
                and self.coef == 1.0 and comp is not None):
            return Param(1.0, comp, 1.0 - self.value)
        raise ParamError(
            f"parametric compile only supports 1 - x on a bare "
            f"alpha/gamma monomial, got {other!r} - {self!r}")

    def __sub__(self, other):
        raise ParamError(
            f"parametric compile does not support {self!r} - {other!r}")

    # addition exits the parametric domain: probabilities are only ever
    # summed to validate them
    def _add(self, other):
        return self.value + float(other)

    __add__ = _add
    __radd__ = _add

    def __float__(self):
        return self.value

    def __bool__(self):
        return self.value != 0.0

    def __eq__(self, other):
        if isinstance(other, Param):
            return (self.coef, self.expo) == (other.coef, other.expo)
        if isinstance(other, (int, float)):
            return self.value == float(other)
        return NotImplemented

    def __hash__(self):
        return hash((self.coef, self.expo))

    def __lt__(self, other):
        return self.value < float(other)

    def __le__(self, other):
        return self.value <= float(other)

    def __gt__(self, other):
        return self.value > float(other)

    def __ge__(self, other):
        return self.value >= float(other)


def param_pair(probe_alpha: float = PROBE_ALPHA,
               probe_gamma: float = PROBE_GAMMA):
    """(alpha, gamma) tracer pair to bind into an implicit model."""
    assert 0.0 < probe_alpha < 0.5 and 0.0 < probe_gamma < 1.0
    return (Param(1.0, (1, 0, 0, 0), probe_alpha),
            Param(1.0, (0, 0, 1, 0), probe_gamma))


@dataclass(frozen=True)
class ParamMDP:
    """A compiled MDP whose probability column is symbolic in
    (alpha, gamma): `mdp` holds the shared structure with the probe
    point's probabilities, and `prob[t] = coef[t] * alpha^expo[t,0]
    (1-alpha)^expo[t,1] gamma^expo[t,2] (1-gamma)^expo[t,3]` at any
    point. The start distribution is parametric too."""

    mdp: MDP
    coef: np.ndarray          # [T] float64
    expo: np.ndarray          # [T, 4] int16
    start_ids: np.ndarray     # [n_start] int32
    start_coef: np.ndarray    # [n_start] float64
    start_expo: np.ndarray    # [n_start, 4] int16
    probe_alpha: float
    probe_gamma: float
    meta: dict = field(default_factory=dict)

    @property
    def n_states(self) -> int:
        return self.mdp.n_states

    @property
    def n_transitions(self) -> int:
        return self.mdp.n_transitions

    def __repr__(self):
        return (f"ParamMDP({self.mdp!r}, probe=({self.probe_alpha:g}, "
                f"{self.probe_gamma:g}), meta={self.meta})")

    @staticmethod
    def _monomial(coef, expo, alpha: float, gamma: float) -> np.ndarray:
        a, g = float(alpha), float(gamma)
        e = expo
        return (coef * a ** e[:, 0] * (1.0 - a) ** e[:, 1]
                * g ** e[:, 2] * (1.0 - g) ** e[:, 3])

    def revalue(self, alpha: float, gamma: float) -> np.ndarray:
        """The [T] float64 probability column at (alpha, gamma), in the
        compiled row order."""
        return self._monomial(self.coef, self.expo, alpha, gamma)

    def start_vector(self, alpha: float, gamma: float) -> np.ndarray:
        """The [S] float64 start distribution at (alpha, gamma)."""
        s = np.zeros(self.n_states, np.float64)
        s[self.start_ids] = self._monomial(self.start_coef,
                                           self.start_expo, alpha, gamma)
        return s

    def fingerprint(self) -> str:
        """Content hash of the parametric compile (the solve-cache
        key): compiles whose structure, exponents or coefficients differ
        in any way never share a cached solve."""
        src, act, dst, _, reward, progress = self.mdp.arrays()
        h = hashlib.sha256()
        h.update(repr((self.mdp.n_states, self.mdp.n_actions,
                       self.probe_alpha, self.probe_gamma,
                       sorted(self.meta.items()))).encode())
        for arr in (src, act, dst, reward, progress, self.coef,
                    self.expo, self.start_ids, self.start_coef,
                    self.start_expo):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()[:24]


def _extract_param(p, what: str):
    """(coef, expo) of one traced probability; plain floats are
    constant monomials."""
    if isinstance(p, Param):
        return p.coef, p.expo
    if isinstance(p, (int, float)):
        return float(p), _ONE
    raise ParamError(f"{what} is {type(p).__name__}, expected a "
                     f"Param monomial or a plain number")


def parametric_compile(factory, *, probe_alpha: float = PROBE_ALPHA,
                       probe_gamma: float = PROBE_GAMMA,
                       meta: dict | None = None,
                       n_workers: int | None = None,
                       checkpoint_path: str | None = None) -> ParamMDP:
    """One frontier-batched compile of `factory(alpha=<tracer>,
    gamma=<tracer>)` -> ParamMDP. The model runs unmodified in the
    tracer's domain, so BFS order, state ids and transition order are
    those of a fresh compile at the probe point."""
    from cpr_tpu_torch.mdp.frontier import FrontierCompiler

    a, g = param_pair(probe_alpha, probe_gamma)
    model = factory(alpha=a, gamma=g)
    meta = dict(meta or {})
    fc = FrontierCompiler(model, n_workers=n_workers,
                          checkpoint_path=checkpoint_path,
                          trace_params=True,
                          protocol=meta.get("protocol"),
                          cutoff=meta.get("cutoff"))
    return fc.param_mdp(probe_alpha=probe_alpha,
                        probe_gamma=probe_gamma, meta=meta)


def _native_keys(a: float, g: float):
    """The closed set of probability values the native generic compiler
    emits at probe point (a, g), with their exponents: alpha/gamma enter
    only at the Continue action (`pc[ci] * pm[mi]`, pc = {g, 1-g},
    pm = {a, 1-a}), Release/Consider are deterministic, loop_honest
    starts are {a, 1-a}, and same-destination rows are never merged
    (cpr_tpu_torch/native/src/generic_compiler.cpp)."""
    return [
        (1.0, _ONE),
        (a, (1, 0, 0, 0)),
        (1.0 - a, (0, 1, 0, 0)),
        (g, (0, 0, 1, 0)),
        (1.0 - g, (0, 0, 0, 1)),
        (g * a, (1, 0, 1, 0)),
        (g * (1.0 - a), (0, 1, 1, 0)),
        ((1.0 - g) * a, (1, 0, 0, 1)),
        ((1.0 - g) * (1.0 - a), (0, 1, 0, 1)),
    ]


def parametric_compile_native(proto: str, *, k: int = 0,
                              probe_alpha: float = PROBE_ALPHA,
                              probe_gamma: float = PROBE_GAMMA,
                              meta: dict | None = None,
                              **kw) -> ParamMDP:
    """ParamMDP from one native (C++) compile at the probe point; the
    exponent columns come from matching each emitted probability
    against `_native_keys`. A probability outside the key set raises
    ParamError."""
    from cpr_tpu_torch.mdp.generic.native import compile_native

    mdp = compile_native(proto, k=k, alpha=probe_alpha,
                         gamma=probe_gamma, **kw)
    keys = _native_keys(probe_alpha, probe_gamma)
    vals = np.asarray([v for v, _ in keys])
    expos = np.asarray([e for _, e in keys], np.int16)
    assert len(np.unique(vals)) == len(vals), \
        "probe point produced colliding native keys; pick another"

    def match(col, what):
        col = np.asarray(col, np.float64)
        idx = np.abs(col[:, None] - vals[None, :]).argmin(axis=1)
        bad = ~np.isclose(col, vals[idx], rtol=1e-12, atol=0.0)
        if bad.any():
            t = int(np.flatnonzero(bad)[0])
            raise ParamError(
                f"native {what} {t} has probability {col[t]!r} outside "
                f"the known monomial key set — the native compiler's "
                f"probability algebra changed; update _native_keys")
        return idx

    prob = np.asarray(mdp.prob, np.float64)
    idx = match(prob, "transition")
    # the key table is coefficient-1: the emitted value is the monomial
    coef = np.ones(len(prob), np.float64)
    expo = expos[idx]
    start_ids = np.asarray(sorted(mdp.start), np.int32)
    start_vals = np.asarray([mdp.start[int(s)] for s in start_ids])
    sidx = match(start_vals, "start entry")
    base = MDP(n_states=mdp.n_states, n_actions=mdp.n_actions,
               start={int(s): float(p)
                      for s, p in zip(start_ids, start_vals)},
               src=mdp.src, act=mdp.act, dst=mdp.dst, prob=mdp.prob,
               reward=mdp.reward, progress=mdp.progress)
    m = dict(meta or {}, proto=proto, k=k)
    return ParamMDP(mdp=base, coef=coef, expo=expo,
                    start_ids=start_ids,
                    start_coef=np.ones(len(start_ids), np.float64),
                    start_expo=expos[sidx], probe_alpha=probe_alpha,
                    probe_gamma=probe_gamma, meta=m)


def param_ptmdp(pm: ParamMDP, *, horizon: int) -> ParamMDP:
    """Parametric twin of `ptmdp`: the continue probability
    `keep = (1 - 1/horizon)^progress` is a constant per row, so the
    transform scales coefficients (continue rows by keep, the appended
    terminal rows by 1 - keep) and carries the exponents; the base MDP
    goes through `ptmdp` itself, so row order matches."""
    base = ptmdp(pm.mdp, horizon=horizon)
    _, _, _, _, _, progress = pm.mdp.arrays()
    keep = (1.0 - 1.0 / horizon) ** progress
    hp = progress != 0.0
    coef = np.concatenate([np.where(hp, pm.coef * keep, pm.coef),
                           (pm.coef * (1.0 - keep))[hp]])
    expo = np.concatenate([pm.expo, pm.expo[hp]])
    return ParamMDP(mdp=base, coef=coef, expo=expo,
                    start_ids=pm.start_ids, start_coef=pm.start_coef,
                    start_expo=pm.start_expo,
                    probe_alpha=pm.probe_alpha,
                    probe_gamma=pm.probe_gamma,
                    meta=dict(pm.meta, horizon=horizon))


def check_revalue_parity(pm: ParamMDP, fresh, points, *,
                         rtol: float = 1e-9) -> int:
    """For each (alpha, gamma), a fresh compile `fresh(alpha, gamma)`
    (an MDP or an implicit model) must have the same state and row
    counts and a probability column allclose (rtol, atol 0) to
    `pm.revalue(alpha, gamma)`, and the same start distribution.
    Returns the number of points checked. Probe interior points: at
    gamma in {0, 1} fresh compiles skip zero-probability branches."""
    n = 0
    for alpha, gamma in points:
        m = fresh(alpha, gamma)
        if not isinstance(m, MDP):
            m = Compiler(m).mdp()
        if (m.n_states, m.n_transitions) != (pm.n_states,
                                             pm.n_transitions):
            raise AssertionError(
                f"parametric compile diverges from fresh compile at "
                f"({alpha}, {gamma}): {pm.n_states}/{pm.n_transitions} "
                f"vs {m.n_states}/{m.n_transitions} states/transitions")
        got = pm.revalue(alpha, gamma)
        want = m.arrays()[3]
        if not np.allclose(got, want, rtol=rtol, atol=0.0):
            worst = int(np.abs(got - want).argmax())
            raise AssertionError(
                f"revalued probability column diverges at "
                f"({alpha}, {gamma}), transition {worst}: "
                f"{got[worst]!r} vs fresh {want[worst]!r}")
        sv = pm.start_vector(alpha, gamma)
        for sid, p in m.start.items():
            if not np.isclose(sv[sid], float(p), rtol=rtol, atol=0.0):
                raise AssertionError(
                    f"start prob of state {sid} diverges at "
                    f"({alpha}, {gamma}): {sv[sid]!r} vs {float(p)!r}")
        n += 1
    return n


# -- the grid solver ---------------------------------------------------------


def grid_points(alphas, gammas):
    """The row-major (alpha-major) point list the solver and its
    callers index by."""
    alphas = [float(a) for a in np.atleast_1d(alphas)]
    gammas = [float(g) for g in np.atleast_1d(gammas)]
    return alphas, gammas, [(a, g) for a in alphas for g in gammas]


def grid_value_iteration(pm: ParamMDP, alphas, gammas, *,
                         discount: float = 1.0, eps: float | None = None,
                         stop_delta: float | None = None,
                         max_iter: int = 0, chunk: int = 64,
                         dtype=None, mesh=None, axis: str = "d",
                         state_axis: str | None = None,
                         checkpoint_path: str | None = None,
                         protocol: str | None = None,
                         cutoff: int | None = None, device=None) -> dict:
    """Solve the whole (alphas x gammas) grid as one chunked VI over
    `pm`'s shared structure, on `device` (default: the card; K7) or the
    CPU (`device="cpu"`, the plain twin).

    Per point the result is `TensorMDP.value_iteration(impl="chunked")`
    of the revalued table bit for bit: the same chunk schedule and the
    stop rule at chunk granularity; a converged point is frozen (value,
    progress, policy untouched) while the rest keep sweeping.

    Emits one `mdp_solve` event; returns a dict of grid-major numpy
    arrays (`grid_value`, `grid_progress`, `grid_policy`, `grid_start`,
    `grid_revenue`, `grid_delta`, `grid_iter`, `grid_converged`) plus
    `vi_iter`, `vi_stop_delta`, `vi_residuals` [G, it] and `vi_time`."""
    from cpr_tpu_torch import telemetry
    from cpr_tpu_torch.mdp.explicit import run_grid_chunk_driver
    from cpr_tpu_torch.parallel.grid import make_grid_chunk_step

    if mesh is not None or state_axis is not None:
        raise NotImplementedError(
            "mesh-sharded grid solves (mesh=, state_axis=) are not ported "
            "yet: they need K16, ROADMAP item 13")
    if checkpoint_path is not None:
        raise NotImplementedError(
            "grid VI checkpoints (checkpoint_path=) are not ported yet: "
            "they need the resilience checkpoints, ROADMAP item 6")
    dtype = torch.float32 if dtype is None else dtype
    alphas, gammas, points = grid_points(alphas, gammas)
    G = len(points)
    assert G > 0, "empty grid"
    tm = pm.mdp.tensor(dtype, device=device)
    stop_delta = tm.resolve_stop_delta(discount=discount, eps=eps,
                                       stop_delta=stop_delta,
                                       max_iter=max_iter)
    tm._check_segment_width()
    t0 = now()
    probs = np.stack([pm.revalue(a, g) for a, g in points])
    starts = np.stack([pm.start_vector(a, g) for a, g in points])
    chunk_step, place = make_grid_chunk_step(tm, G, discount=discount)
    probs_dev = tm.sort_rows(torch.from_numpy(probs).to(dtype))

    def step(carry, frozen, steps):
        return chunk_step(carry, probs_dev, frozen, steps)

    value, prog, policy, delta, conv_it, converged, it, resid = \
        run_grid_chunk_driver(
            step, place, G, pm.n_states, dtype, stop_delta,
            max_iter if max_iter > 0 else (1 << 30), chunk=chunk,
            device=tm.device)
    vi_time = now() - t0
    # per-point revenue from the point's own start distribution
    num = (starts * value).sum(axis=1)
    den = (starts * prog).sum(axis=1)
    revenue = np.divide(num, den, out=np.zeros_like(num),
                        where=den != 0.0)
    telemetry.current().event(
        "mdp_solve", protocol=protocol, cutoff=cutoff,
        grid=[len(alphas), len(gammas)], sweeps=int(it),
        converged=int(converged.sum()), points=G,
        n_states=pm.n_states, n_transitions=pm.n_transitions,
        n_devices=1, state_shards=1, halo_bytes=0,
        solve_s=round(vi_time, 6),
        points_per_sec=round(G / vi_time, 3) if vi_time > 0 else None,
        states_per_sec=(round(pm.n_states * int(it) / vi_time, 3)
                        if vi_time > 0 else None))
    return dict(
        grid_alphas=alphas, grid_gammas=gammas, grid_points=points,
        grid_value=value, grid_progress=prog, grid_policy=policy,
        grid_start=starts, grid_revenue=revenue, grid_delta=delta,
        grid_iter=conv_it, grid_converged=converged,
        vi_iter=int(it), vi_stop_delta=float(stop_delta),
        vi_residuals=resid, vi_time=vi_time,
    )


# -- protocol registry + cached solves ---------------------------------------


def compile_protocol(protocol: str, *, cutoff: int, k: int = 2,
                     native: bool = False,
                     probe_alpha: float = PROBE_ALPHA,
                     probe_gamma: float = PROBE_GAMMA,
                     n_workers: int | None = None,
                     checkpoint_path: str | None = None) -> ParamMDP:
    """Parametric compile of one battery protocol family: "fc16" /
    "aft20" (maximum_fork_length=cutoff, the frontier compiler with
    `n_workers` processes) or "bitcoin" / "ghostdag" (the native
    compiler, dag_size_cutoff=cutoff; `native=True` is required until
    the Python generic model is ported)."""
    meta = dict(protocol=protocol, cutoff=int(cutoff))
    if protocol in ("fc16", "aft20"):
        from cpr_tpu_torch.mdp.models import Aft20BitcoinSM, Fc16BitcoinSM

        cls = Fc16BitcoinSM if protocol == "fc16" else Aft20BitcoinSM
        return parametric_compile(
            lambda alpha, gamma: cls(alpha=alpha, gamma=gamma,
                                     maximum_fork_length=cutoff),
            probe_alpha=probe_alpha, probe_gamma=probe_gamma, meta=meta,
            n_workers=n_workers, checkpoint_path=checkpoint_path)
    if protocol in ("bitcoin", "ghostdag"):
        if not native:
            raise NotImplementedError(PYTHON_GENERIC_QUEUED)
        if checkpoint_path is not None:
            raise NotImplementedError(
                "compile checkpoints (checkpoint_path=) are not ported "
                "yet: ROADMAP item 6")
        return parametric_compile_native(
            protocol, k=k if protocol == "ghostdag" else 0,
            probe_alpha=probe_alpha, probe_gamma=probe_gamma,
            collect_garbage="simple", dag_size_cutoff=cutoff, meta=meta)
    raise ValueError(f"unknown protocol {protocol!r}; expected fc16, "
                     f"aft20, bitcoin, or ghostdag")


def _cache_dir() -> str:
    """Solve-cache directory: CPR_MDP_CACHE > <CPR_TPU_CACHE>/mdp_grid
    > ~/.cache/cpr_tpu/mdp_grid (delete it to empty the cache)."""
    d = os.environ.get("CPR_MDP_CACHE")
    if d:
        return d
    base = os.environ.get("CPR_TPU_CACHE")
    if base:
        return os.path.join(base, "mdp_grid")
    return os.path.join(os.path.expanduser("~"), ".cache", "cpr_tpu",
                        "mdp_grid")


def solve_grid_cached(protocol: str, *, cutoff: int, alphas, gammas,
                      horizon: int = 100, stop_delta: float = 1e-6,
                      discount: float = 1.0, k: int = 2,
                      native: bool = False, include_policy: bool = False,
                      cache: bool = True, mesh=None, device=None) -> dict:
    """Parametric compile + grid solve, with the solve cached on disk
    (a sealed JSON entry) under the ParamMDP's content fingerprint and
    the solve knobs: the compile runs on every call, and anything that
    changes its output invalidates the cached solve. A damaged entry is
    a miss: it is quarantined (typed `integrity` event, action
    "regenerated") and solved again. Returns a JSON-safe dict."""
    import cpr_tpu_torch
    from cpr_tpu_torch import integrity, resilience

    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded grid solves are not ported yet: K16, ROADMAP "
            "item 13")
    alphas, gammas, points = grid_points(alphas, gammas)
    pm = param_ptmdp(
        compile_protocol(protocol, cutoff=cutoff, k=k, native=native),
        horizon=horizon)
    fp = pm.fingerprint()
    key = dict(kind="mdp_grid", fingerprint=fp, alphas=alphas,
               gammas=gammas, horizon=horizon, stop_delta=stop_delta,
               discount=discount, include_policy=bool(include_policy),
               _version=cpr_tpu_torch.__version__)
    h = hashlib.sha256(
        json.dumps(key, sort_keys=True).encode()).hexdigest()[:24]
    path = os.path.join(_cache_dir(), h + ".json")
    if cache and os.path.exists(path):
        try:
            data, tag = resilience.sealed_read_json(
                path, kind="mdp_grid_cache", action="regenerated")
            return dict(data["value"], cached=True, integrity=tag)
        except resilience.IntegrityError:
            pass
        except (OSError, KeyError, TypeError):
            integrity.quarantine(path, kind="mdp_grid_cache",
                                 reason="truncated", action="regenerated")
    vi = grid_value_iteration(pm, alphas, gammas, discount=discount,
                              stop_delta=stop_delta, protocol=protocol,
                              cutoff=cutoff, device=device)
    value = dict(
        protocol=protocol, cutoff=int(cutoff), horizon=int(horizon),
        stop_delta=float(stop_delta), discount=float(discount),
        fingerprint=fp, n_states=pm.n_states,
        n_transitions=pm.n_transitions, alphas=alphas, gammas=gammas,
        points=[list(p) for p in points],
        revenue=[round(float(r), 12) for r in vi["grid_revenue"]],
        converged=[bool(c) for c in vi["grid_converged"]],
        sweeps=int(vi["vi_iter"]),
        conv_iter=[int(i) for i in vi["grid_iter"]],
        solve_s=round(float(vi["vi_time"]), 6), cached=False,
    )
    if include_policy:
        value["policy"] = [[int(x) for x in row]
                           for row in vi["grid_policy"]]
    if cache:
        resilience.sealed_write_json(path, {"key": key, "value": value},
                                     site="cache")
    return value
