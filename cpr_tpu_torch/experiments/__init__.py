"""Experiments of the port.

Reference counterpart: `cpr_tpu/experiments/`. Ported so far: the MDP
solve-time sweep (`measure_mdp`: `model_battery`, `measure_rows`,
`battery_groups`). The other experiments are queued in ROADMAP item 9.
"""

from cpr_tpu_torch.experiments.measure_mdp import (
    battery_groups, measure_rows, model_battery)

__all__ = ["battery_groups", "measure_rows", "model_battery"]
