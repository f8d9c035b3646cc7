"""MDP solve-time measurement sweep.

Reference counterpart: cpr_tpu/experiments/measure_mdp.py (after
mdp/sprint-0-explicit-mdps/measure-ours.py) — compile a battery of
attack models, solve each with value iteration, and record sizes +
wall-times (models over 1M transitions are skipped, as there).

One row per (model, alpha, gamma): state/transition counts, compile and
solve wall-times, optimal revenue. The solve runs on the card (K4, or K7
for `measure_rows_grid`) unless `device="cpu"` is given.
"""

from __future__ import annotations

from cpr_tpu_torch import _device
from cpr_tpu_torch.mdp import Compiler, ptmdp
from cpr_tpu_torch.mdp.explicit import MDP
from cpr_tpu_torch.mdp.models import Aft20BitcoinSM, Fc16BitcoinSM
from cpr_tpu_torch.telemetry import now


def model_battery(alphas=(0.25, 0.33, 0.4), gamma=0.5, *, native=True,
                  generic_cutoff=7, mfl=20):
    """(name, factory) pairs covering the literature + generic models.

    Factories return an implicit model (compiled through the Python BFS)
    or a ready MDP; the generic entries use the native C++ compiler
    (`native=False`, the Python generic model, is not ported yet:
    ROADMAP item 7c)."""
    if not native:
        from cpr_tpu_torch.mdp.grid import PYTHON_GENERIC_QUEUED
        raise NotImplementedError(PYTHON_GENERIC_QUEUED)
    battery = []
    for a in alphas:
        battery.append((f"fc16-{a}", lambda a=a: Fc16BitcoinSM(
            alpha=a, gamma=gamma, maximum_fork_length=mfl)))
        battery.append((f"aft20-{a}", lambda a=a: Aft20BitcoinSM(
            alpha=a, gamma=gamma, maximum_fork_length=mfl)))
        for proto, k in (("bitcoin", 0), ("ghostdag", 2)):
            def fac(a=a, proto=proto, k=k):
                from cpr_tpu_torch.mdp.generic import compile_native
                return compile_native(
                    proto, k=k, alpha=a, gamma=gamma,
                    collect_garbage="simple",
                    dag_size_cutoff=generic_cutoff)
            battery.append((f"generic-{proto}-{a}", fac))
    return battery


def measure_rows(battery=None, *, horizon=100, stop_delta=1e-6,
                 max_transitions=1_000_000, mesh=None, device=None):
    """Compile + solve each model; skip those over `max_transitions`
    (measure-ours.py:14-21 filter)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded solves are not ported yet: ROADMAP item 13")
    dev = _device.resolve(device)
    rows = []
    if battery is None:
        battery = model_battery()
    for name, factory in battery:
        t0 = now()
        made = factory()
        table = made if isinstance(made, MDP) else Compiler(made).mdp()
        mdp = ptmdp(table, horizon=horizon)
        compile_s = now() - t0
        row = {"model": name, "n_states": mdp.n_states,
               "n_transitions": mdp.n_transitions,
               "compile_s": compile_s}
        if mdp.n_transitions > max_transitions:
            row["skipped"] = "transition cap"
            rows.append(row)
            continue
        tm = mdp.tensor(device=dev)
        t0 = now()
        vi = tm.value_iteration(stop_delta=stop_delta)
        row["vi_s"] = now() - t0
        row["vi_iter"] = int(vi["vi_iter"])
        prog = tm.start_value(vi["vi_progress"])
        row["revenue"] = (float(tm.start_value(vi["vi_value"]) / prog)
                          if prog else 0.0)
        rows.append(row)
    return rows


def battery_groups(*, native=True, generic_cutoff=7, mfl=20):
    """The model_battery regrouped by (protocol, cutoff): each group
    shares one transition structure across every (alpha, gamma) point.
    Entries are (protocol, cutoff, kwargs-for-compile_protocol,
    serial-name-stem); the stems reproduce measure_rows' `model` labels
    ("fc16-{alpha}", "generic-bitcoin-{alpha}", ...)."""
    return [
        ("fc16", mfl, {}, "fc16"),
        ("aft20", mfl, {}, "aft20"),
        ("bitcoin", generic_cutoff, {"native": native},
         "generic-bitcoin"),
        ("ghostdag", generic_cutoff, {"native": native, "k": 2},
         "generic-ghostdag"),
    ]


def measure_rows_grid(groups=None, *, alphas=(0.25, 0.33, 0.4),
                      gamma=0.5, horizon=100, stop_delta=1e-6,
                      max_transitions=1_000_000, mesh=None, device=None):
    """Grid-batched twin of measure_rows: per (protocol, cutoff) group,
    one parametric compile and one grid solve over every alpha
    (cpr_tpu_torch.mdp.grid; K7 on the card) instead of a compile and a
    solve per point. The rows keep measure_rows' schema (`model` matches
    the serial labels; compile_s/vi_s are the group totals spread over
    its points, with the totals alongside). Each point's revenue is that
    of a solo chunked solve of its revalued table, bit for bit."""
    from cpr_tpu_torch.mdp.grid import (compile_protocol,
                                        grid_value_iteration, param_ptmdp)

    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded solves are not ported yet: ROADMAP item 13")
    dev = _device.resolve(device)
    if groups is None:
        groups = battery_groups()
    rows = []
    gammas = (gamma,)
    for protocol, cutoff, kw, stem in groups:
        t0 = now()
        pm = param_ptmdp(compile_protocol(protocol, cutoff=cutoff, **kw),
                         horizon=horizon)
        compile_s = now() - t0
        shared = {"n_states": pm.n_states,
                  "n_transitions": pm.n_transitions}
        if pm.n_transitions > max_transitions:
            rows.extend([dict(model=f"{stem}-{a}", compile_s=compile_s,
                              skipped="transition cap", **shared)
                         for a in alphas])
            continue
        vi = grid_value_iteration(pm, alphas, gammas,
                                  stop_delta=stop_delta, protocol=protocol,
                                  cutoff=cutoff, device=dev)
        n = len(vi["grid_points"])
        for i, (a, _) in enumerate(vi["grid_points"]):
            rows.append(dict(
                model=f"{stem}-{a}", compile_s=compile_s / n,
                vi_s=vi["vi_time"] / n, vi_iter=int(vi["grid_iter"][i]),
                revenue=float(vi["grid_revenue"][i]),
                group_compile_s=compile_s,
                group_vi_s=vi["vi_time"], group_points=n, **shared))
    return rows
