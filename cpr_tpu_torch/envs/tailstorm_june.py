"""Tailstorm/ll (June '22) attack environment (port of
cpr_tpu/envs/tailstorm_june.py).

Reference counterpart: simulator/protocols/tailstorm_june.ml and
tailstorm_june_ssz.ml. The protocol is Stree's structure with
Tailstorm's reward menu plus a `block` scheme paying the whole k to the
summary's miner (tailstorm_june.ml:176-205), the selection fixed to the
heuristic quorum (282-350). As in the reference it takes no window: it
runs in full mode only, which has no CUDA kernel yet (ROADMAP item 8c);
the plain version runs it on the CPU.
"""

from __future__ import annotations

import torch

from cpr_tpu_torch.core import dag as D
from cpr_tpu_torch.envs.stree import StreeSSZ

INCENTIVE_SCHEMES = ("block", "constant", "discount", "punish", "hybrid")


class TailstormJuneSSZ(StreeSSZ):
    def __init__(self, k: int = 8, incentive_scheme: str = "constant",
                 unit_observation: bool = True, max_steps_hint: int = 256,
                 release_scan: int = 128):
        assert incentive_scheme in INCENTIVE_SCHEMES
        super().__init__(
            k=k,
            incentive_scheme=("constant" if incentive_scheme == "block"
                              else incentive_scheme),
            subblock_selection="heuristic",
            unit_observation=unit_observation,
            max_steps_hint=max_steps_hint,
            release_scan=release_scan)
        self.incentive_scheme = incentive_scheme

    def block_reward(self, dag, leaves_row, miner):
        """`block`: the summary's miner collects the whole k
        (tailstorm_june.ml:177); the other schemes are Stree's."""
        if self.incentive_scheme != "block":
            return super().block_reward(dag, leaves_row, miner)
        k = torch.full(miner.shape, float(self.k), dtype=torch.float32,
                       device=miner.device)
        zero = torch.zeros_like(k)
        return (torch.where(miner == D.ATTACKER, k, zero),
                torch.where(miner == D.DEFENDER, k, zero))
