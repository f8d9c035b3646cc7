"""Implicit MDP models.

Reference counterpart: mdp/lib/implicit_mdp.py:29-77 (`Model` with
start/actions/apply/shutdown/honest and `Transition{probability, state,
reward, progress, effect}`) and the probabilistic-termination wrapper
(mdp/lib/implicit_mdp.py:80-172) implementing the Bar-Zur et al. AFT'20
PTO horizon: each progress-making transition is split into a continue
branch with probability (1 - 1/H)^progress and a terminal branch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Hashable, Optional


@dataclass(frozen=True)
class Effect:
    """Optional per-transition bookkeeping (mdp/lib/implicit_mdp.py:9-17)."""

    blocks_mined: float = 0.0
    common_atk_reward: float = 0.0
    common_def_reward: float = 0.0
    common_progress: float = 0.0
    defender_rewrite_length: float = 0.0
    defender_rewrite_progress: float = 0.0
    defender_progress: float = 0.0


@dataclass(frozen=True)
class Transition:
    probability: float
    state: Hashable
    reward: float
    progress: float
    effect: Optional[Effect] = None


class Model:
    """Implicit (generative) MDP: states are hashable, transitions lazy."""

    def start(self) -> list[tuple[Hashable, float]]:
        raise NotImplementedError

    def actions(self, state) -> list[Any]:
        raise NotImplementedError

    def apply(self, action, state) -> list[Transition]:
        raise NotImplementedError

    def shutdown(self, state) -> list[Transition]:
        """Fair-shutdown mechanism called at episode end (forces release of
        withheld blocks so probabilistic termination doesn't punish
        risk-taking)."""
        raise NotImplementedError

    def honest(self, state):
        raise NotImplementedError


class PTOWrapper(Model):
    """Probabilistic termination (Bar-Zur et al. AFT'20).

    Progress-making transitions gain a terminal branch with probability
    1 - (1 - 1/horizon)^progress (mdp/lib/implicit_mdp.py:99-132).
    """

    def __init__(self, model: Model, *, horizon: int, terminal_state):
        assert horizon > 0
        assert isinstance(model, Model)
        assert not isinstance(model, PTOWrapper)
        self.unwrapped = model
        self.horizon = horizon
        self.terminal = terminal_state

    def start(self):
        return self.unwrapped.start()

    def actions(self, state):
        if state is self.terminal or state == self.terminal:
            return []
        return self.unwrapped.actions(state)

    def continue_probability(self, progress: float) -> float:
        return (1.0 - 1.0 / self.horizon) ** progress

    def apply(self, action, state):
        out = []
        for t in self.unwrapped.apply(action, state):
            if t.progress == 0.0:
                out.append(t)
                continue
            keep = self.continue_probability(t.progress)
            assert 0.0 < keep < 1.0
            out.append(
                Transition(
                    probability=t.probability * keep,
                    state=t.state,
                    reward=t.reward,
                    progress=t.progress,
                    effect=t.effect,
                )
            )
            out.append(
                Transition(
                    probability=t.probability * (1.0 - keep),
                    state=self.terminal,
                    reward=0.0,
                    progress=0.0,
                )
            )
        return out

    def shutdown(self, state):
        if state is self.terminal or state == self.terminal:
            return []
        out = []
        for t in self.unwrapped.shutdown(state):
            keep = self.continue_probability(t.progress)
            out.append(
                Transition(
                    probability=t.probability * keep,
                    state=t.state,
                    reward=t.reward,
                    progress=t.progress,
                    effect=t.effect,
                )
            )
            out.append(
                Transition(
                    probability=t.probability * (1.0 - keep),
                    state=self.terminal,
                    reward=t.reward,
                    progress=t.progress,
                    effect=t.effect,
                )
            )
        return out

    def honest(self, state):
        return self.unwrapped.honest(state)
