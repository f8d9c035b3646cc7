"""RTDP measurement sweep: sampled solvers against exact value iteration.

Reference counterpart: `cpr_tpu/experiments/measure_rtdp.py` (after
mdp/sprint-2-rtdp/measure-rtdp.py): run the host RTDP on a battery of
attack models with a step budget, record explored-state counts and
start-value estimates, and compare with the exact VI solve of the same
(truncated) model; with `device_rtdp`, also the device walkers
(`TensorMDP.rtdp`, kernel K6 on the card) at the same sampled-step
counts. The exact solve and the device walkers run on the card unless
`device="cpu"` is given.

One row per (model, step budget): explored states, RTDP revenue, exact
VI revenue, absolute error, wall-times.
"""

from __future__ import annotations

from cpr_tpu_torch import _device
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.mdp import Compiler, ptmdp
from cpr_tpu_torch.mdp.implicit import PTOWrapper
from cpr_tpu_torch.mdp.models import Aft20BitcoinSM, Fc16BitcoinSM
from cpr_tpu_torch.mdp.rtdp import RTDP
from cpr_tpu_torch.telemetry import now


def rtdp_battery(alphas=(0.25, 0.33, 0.4), gamma=0.5, fork_len=12):
    battery = []
    for a in alphas:
        battery.append((f"fc16-{a}", lambda a=a: Fc16BitcoinSM(
            alpha=a, gamma=gamma, maximum_fork_length=fork_len)))
        battery.append((f"aft20-{a}", lambda a=a: Aft20BitcoinSM(
            alpha=a, gamma=gamma, maximum_fork_length=fork_len)))
    return battery


def measure_rtdp_rows(battery=None, *, horizon=30, step_budgets=(50_000,),
                      eps=0.2, eps_honest=0.05, es=0.1, seed=0,
                      stop_delta=1e-6, device_rtdp=True,
                      device_batch=128, device_eps=0.4, device=None):
    """For each model: the exact VI revenue once, then one host-RTDP run
    per step budget (continuing the same run between budgets, so rows
    show convergence over the schedule), plus — when `device_rtdp` — the
    device walkers continued from their own table at the same budgets
    (budget // device_batch steps of `device_batch` walkers)."""
    dev = _device.resolve(device)
    rows = []
    if battery is None:
        battery = rtdp_battery()
    for name, factory in battery:
        model = factory()  # stateless: RTDP and exact VI share it
        t0 = now()
        tm = ptmdp(Compiler(model).mdp(), horizon=horizon).tensor(
            device=dev)
        vi = tm.value_iteration(stop_delta=stop_delta)
        prog = tm.start_value(vi["vi_progress"])
        exact = float(tm.start_value(vi["vi_value"]) / prog) if prog else 0.0
        vi_s = now() - t0

        solver = RTDP(ptmdp_model(model, horizon), eps=eps,
                      eps_honest=eps_honest, es=es, seed=seed)
        done, rtdp_s = 0, 0.0
        dev_v = dev_p = None
        dev_done, dev_s = 0, 0.0
        for budget in sorted(step_budgets):
            t0 = now()
            solver.run(budget - done)
            rtdp_s += now() - t0  # cumulative, like `steps`
            done = budget
            v, g = solver.start_value_and_progress()
            est = v / g if g else 0.0
            row = {
                "model": name, "steps": budget,
                "n_states": solver.n_states,
                "rtdp_revenue": est, "vi_revenue": exact,
                "abs_error": abs(est - exact),
                "rtdp_s": rtdp_s, "vi_s": vi_s,
            }
            if device_rtdp:
                # batched lanes: budget counts total sampled steps
                dev_steps = max(1, (budget - dev_done) // device_batch)
                # a fresh stream per continuation segment: the same key
                # would replay the previous segment's draws
                seg_key = rnd.fold_in(rnd.PRNGKey(seed, device="cpu"),
                                      budget)
                r = tm.rtdp(seg_key, steps=dev_steps,
                            batch=device_batch, eps=device_eps,
                            value0=dev_v, progress0=dev_p)
                dev_v, dev_p = r["rtdp_value"], r["rtdp_progress"]
                dev_s += r["rtdp_time"]
                dev_done = budget
                dg = tm.start_value(dev_p)
                dest = tm.start_value(dev_v) / dg if dg else 0.0
                row["device_rtdp_revenue"] = dest
                row["device_rtdp_s"] = dev_s
            rows.append(row)
    return rows


def ptmdp_model(model, horizon):
    """The PTO wrapper as an implicit model (what RTDP samples from)."""
    return PTOWrapper(model, horizon=horizon, terminal_state="terminal")
