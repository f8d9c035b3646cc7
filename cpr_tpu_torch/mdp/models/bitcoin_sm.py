"""Bitcoin selfish-mining MDP models from the literature.

Two variants, matching the reference:

- `Fc16BitcoinSM`: Sapirshtein et al., FC'16 (reference:
  mdp/lib/models/fc16sapirshtein.py:22-264). Randomness folded into the
  actions; stochastic start (first block already mined).
- `Aft20BitcoinSM`: Bar-Zur et al., AFT'20 (reference:
  mdp/lib/models/aft20barzur.py:28-241, itself checked against the
  authors' code). Deterministic Adopt/Override/Match; randomness only in
  Wait; Match becomes a fork state; deterministic empty start.

State is (a, h, fork): secret-chain length, public-chain length since the
last fork, and the match relevance flag.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cpr_tpu_torch.mdp.explicit import MDP, sum_to_one
from cpr_tpu_torch.mdp.implicit import Model, Transition

ADOPT, OVERRIDE, MATCH, WAIT = 0, 1, 2, 3
IRRELEVANT, RELEVANT, ACTIVE = 0, 1, 2


@dataclass(frozen=True, order=True)
class BState:
    a: int
    h: int
    fork: int


class _BitcoinSM(Model):
    """Shared parameter handling and state-space truncation."""

    def __init__(self, *, alpha: float, gamma: float,
                 maximum_fork_length: int, maximum_dag_size: int = 0):
        if not 0.0 <= alpha < 0.5:
            raise ValueError("alpha must be between 0 and 0.5")
        if not 0.0 <= gamma <= 1.0:
            raise ValueError("gamma must be between 0 and 1")
        self.alpha = alpha
        self.gamma = gamma
        self.mfl = maximum_fork_length
        self.mds = maximum_dag_size

    def __repr__(self):
        return (f"{type(self).__name__}(alpha={self.alpha}, gamma={self.gamma}, "
                f"maximum_fork_length={self.mfl}, maximum_dag_size={self.mds})")

    def truncated(self, s: BState) -> bool:
        """Stop growing forks beyond the truncation bounds
        (fc16sapirshtein.py:67-77)."""
        if self.mfl > 0 and (s.a >= self.mfl or s.h >= self.mfl):
            return True
        if self.mds > 0 and (s.a + s.h + 1 >= self.mds):
            return True
        return False

    def _mining_split(self, mk_attacker, mk_defender):
        """Two transitions: attacker finds the next block w.p. alpha."""
        return [
            Transition(probability=self.alpha, **mk_attacker),
            Transition(probability=1.0 - self.alpha, **mk_defender),
        ]

    def shutdown(self, s: BState):
        """Fair shutdown: settle the fork in the attacker's favour where it
        leads, by gamma-coinflip on a tie (fc16sapirshtein.py:198-225)."""
        out = []
        for snew, p in self.start():
            if s.h > s.a:
                out.append(Transition(probability=p, state=snew, reward=0.0,
                                      progress=s.h))
            elif s.a > s.h:
                out.append(Transition(probability=p, state=snew, reward=s.a,
                                      progress=s.a))
            else:
                out.append(Transition(probability=p * self.gamma, state=snew,
                                      reward=s.a, progress=s.a))
                out.append(Transition(probability=p * (1.0 - self.gamma),
                                      state=snew, reward=0.0, progress=s.h))
        assert sum_to_one(t.probability for t in out)
        return out


class Fc16BitcoinSM(_BitcoinSM):
    """FC'16 formulation: every action immediately resolves the next mining
    event (fc16sapirshtein.py:93-190)."""

    def start(self):
        return [
            (BState(1, 0, IRRELEVANT), self.alpha),
            (BState(0, 1, IRRELEVANT), 1.0 - self.alpha),
        ]

    def actions(self, s: BState):
        acts = []
        if not self.truncated(s):
            acts.append(WAIT)
        if s.a > s.h:
            acts.append(OVERRIDE)
        if s.a >= s.h and s.fork == RELEVANT:
            acts.append(MATCH)
        acts.append(ADOPT)
        return acts

    def apply(self, action, s: BState):
        if action == ADOPT:
            return self._mining_split(
                dict(state=BState(1, 0, IRRELEVANT), reward=0.0, progress=s.h),
                dict(state=BState(0, 1, IRRELEVANT), reward=0.0, progress=s.h),
            )
        if action == OVERRIDE:
            assert s.a > s.h
            return self._mining_split(
                dict(state=BState(s.a - s.h, 0, IRRELEVANT),
                     reward=s.h + 1.0, progress=s.h + 1.0),
                dict(state=BState(s.a - s.h - 1, 1, RELEVANT),
                     reward=s.h + 1.0, progress=s.h + 1.0),
            )
        if action == MATCH or (action == WAIT and s.fork == ACTIVE):
            # the race: defender mines on the attacker's release w.p. gamma
            assert action == WAIT or s.a >= s.h
            return [
                Transition(probability=self.alpha,
                           state=BState(s.a + 1, s.h, ACTIVE),
                           reward=0.0, progress=0.0),
                Transition(probability=self.gamma * (1.0 - self.alpha),
                           state=BState(s.a - s.h, 1, RELEVANT),
                           reward=float(s.h), progress=float(s.h)),
                Transition(probability=(1.0 - self.gamma) * (1.0 - self.alpha),
                           state=BState(s.a, s.h + 1, RELEVANT),
                           reward=0.0, progress=0.0),
            ]
        if action == WAIT:
            return self._mining_split(
                dict(state=BState(s.a + 1, s.h, IRRELEVANT), reward=0.0,
                     progress=0.0),
                dict(state=BState(s.a, s.h + 1, RELEVANT), reward=0.0,
                     progress=0.0),
            )
        raise ValueError(f"invalid action {action}")

    def honest(self, s: BState):
        return OVERRIDE if s.a > s.h else ADOPT


class Aft20BitcoinSM(_BitcoinSM):
    """AFT'20 formulation: deterministic Adopt/Override/Match, mining
    randomness only in Wait (aft20barzur.py:103-212)."""

    def start(self):
        return [(BState(0, 0, IRRELEVANT), 1.0)]

    def actions(self, s: BState):
        acts = []
        if not self.truncated(s):
            acts.append(WAIT)
        if s.a > s.h:
            acts.append(OVERRIDE)
        if s.a >= s.h and s.fork == RELEVANT:
            acts.append(MATCH)
        if s.h > 0:  # h == 0 would loop with zero progress
            acts.append(ADOPT)
        return acts

    def apply(self, action, s: BState):
        if action == ADOPT:
            return [Transition(probability=1.0, state=BState(0, 0, IRRELEVANT),
                               reward=0.0, progress=s.h)]
        if action == OVERRIDE:
            assert s.a > s.h
            return [Transition(probability=1.0,
                               state=BState(s.a - s.h - 1, 0, IRRELEVANT),
                               reward=s.h + 1.0, progress=s.h + 1.0)]
        if action == MATCH:
            assert s.fork == RELEVANT and s.a >= s.h
            return [Transition(probability=1.0, state=BState(s.a, s.h, ACTIVE),
                               reward=0.0, progress=0.0)]
        if action == WAIT:
            if s.fork != ACTIVE:
                return self._mining_split(
                    dict(state=BState(s.a + 1, s.h, IRRELEVANT), reward=0.0,
                         progress=0.0),
                    dict(state=BState(s.a, s.h + 1, RELEVANT), reward=0.0,
                         progress=0.0),
                )
            return [
                Transition(probability=self.alpha,
                           state=BState(s.a + 1, s.h, ACTIVE),
                           reward=0.0, progress=0.0),
                Transition(probability=(1.0 - self.alpha) * self.gamma,
                           state=BState(s.a - s.h, 1, RELEVANT),
                           reward=float(s.h), progress=float(s.h)),
                Transition(probability=(1.0 - self.alpha) * (1.0 - self.gamma),
                           state=BState(s.a, s.h + 1, RELEVANT),
                           reward=0.0, progress=0.0),
            ]
        raise ValueError(f"invalid action {action}")

    def honest(self, s: BState):
        if s.a == s.h == 0:
            return WAIT
        if s.a > s.h:
            return OVERRIDE
        if s.a == s.h and s.fork == RELEVANT:
            return MATCH
        return ADOPT


# -- probability reparameterization ---------------------------------------

mappable_params = dict(alpha=0.125, gamma=0.25)


def map_params(m: MDP, *, alpha: float, gamma: float) -> MDP:
    """Rewrite an MDP compiled at `mappable_params` to new (alpha, gamma)
    by exact probability-value substitution (reference:
    mdp/lib/models/fc16sapirshtein.py:231-264). Lets one compilation serve
    a whole parameter sweep."""
    assert 0.0 <= alpha <= 1.0 and 0.0 <= gamma <= 1.0
    a, g = mappable_params["alpha"], mappable_params["gamma"]
    keys = np.array([1.0, a, 1.0 - a, (1.0 - a) * g, (1.0 - a) * (1.0 - g)])
    vals = np.array([1.0, alpha, 1.0 - alpha, (1.0 - alpha) * gamma,
                     (1.0 - alpha) * (1.0 - gamma)])
    assert len(set(keys.tolist())) == len(keys), "mappable_params not mappable"

    def remap(p: float) -> float:
        i = np.argmin(np.abs(keys - p))
        assert np.isclose(keys[i], p), f"probability {p} not mappable"
        return float(vals[i])

    out = MDP(n_states=m.n_states, n_actions=m.n_actions,
              start={s: remap(p) for s, p in m.start.items()},
              src=list(m.src), act=list(m.act), dst=list(m.dst),
              prob=[remap(p) for p in m.prob],
              reward=list(m.reward), progress=list(m.progress))
    out.check()
    return out
