"""Experiments of the port.

Reference counterpart: `cpr_tpu/experiments/`. Ported so far: the MDP
solve-time sweeps (`measure_mdp`: `model_battery`, `measure_rows`,
`measure_rows_grid`, `battery_groups`), the RTDP sweep
(`measure_rtdp.measure_rtdp_rows`) and the exact half of the break-even
search (`break_even.exact_revenue_curve`, `break_even_exact`). The other
experiments are queued in ROADMAP item 9.
"""

from cpr_tpu_torch.experiments.measure_mdp import (
    battery_groups, measure_rows, measure_rows_grid, model_battery)

__all__ = ["battery_groups", "measure_rows", "measure_rows_grid",
           "model_battery"]
