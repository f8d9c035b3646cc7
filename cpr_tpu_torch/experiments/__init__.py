"""Experiments of the port.

Reference counterpart: `cpr_tpu/experiments/`. Ported so far: the TSV
writer and the per-task error rows (`sweep.write_tsv`, `sweep.run_task`),
the honest-network sweep on the batch netsim
(`honest_net.honest_net_rows(engine="jax")`), the MDP solve-time sweeps
(`measure_mdp`: `model_battery`, `measure_rows`, `measure_rows_grid`,
`battery_groups`), the RTDP sweep (`measure_rtdp.measure_rtdp_rows`) and
the exact half of the break-even search (`break_even.exact_revenue_curve`,
`break_even_exact`). The other experiments are queued in ROADMAP item 9.
"""

from cpr_tpu_torch.experiments.sweep import run_task, write_tsv
from cpr_tpu_torch.experiments.honest_net import honest_net_rows
from cpr_tpu_torch.experiments.measure_mdp import (
    battery_groups, measure_rows, measure_rows_grid, model_battery)

__all__ = ["write_tsv", "run_task", "honest_net_rows", "battery_groups",
           "measure_rows", "measure_rows_grid", "model_battery"]
