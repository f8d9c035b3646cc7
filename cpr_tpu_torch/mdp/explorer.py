"""Policy-guided incremental exploration of implicit models (host).

Reference counterpart: `cpr_tpu/mdp/explorer.py` (after
mdp/lib/policy_guided_explorer.py:13-131), host code, copied with the
port's imports. The guiding policy's action is explored first and sits
at positional action id 0, states are numbered in order of discovery,
and any prefix of the exploration yields an MDP whose positional policy
`s -> 0` is the guiding policy, so policies solved on truncated MDPs of
growing size stay compatible. The truncated tables solve through
`TensorMDP.value_iteration` like any other MDP.
"""

from __future__ import annotations

from cpr_tpu_torch.mdp.explicit import MDP
from cpr_tpu_torch.mdp.implicit import Model


class Explorer:
    def __init__(self, model: Model, policy):
        self.model = model
        self.policy = policy
        self.states: list = []  # state id -> state
        self.policy_actions: list[int] = []  # state id -> policy action idx
        self._ids: dict = {}
        self._mdp = MDP()
        self._policy_explored = 0  # ids < this have their policy action in
        self._fully_explored = 0  # ids < this have all actions in
        for s, p in model.start():
            self._mdp.start[self._id_of(s)] = p

    def _id_of(self, state) -> int:
        sid = self._ids.get(state)
        if sid is None:
            sid = len(self._ids)
            self._ids[state] = sid
            self.states.append(state)
        return sid

    @property
    def n_states(self) -> int:
        return len(self.states)

    def explore_along_policy(self, max_states: int = 0):
        """Expand the policy action of every discovered state (discovers
        new states, so this runs to a fixpoint)."""
        while self._policy_explored < self.n_states:
            if max_states and self.n_states > max_states:
                raise RuntimeError(
                    f"state budget exceeded: {self.n_states} > {max_states}")
            sid = self._policy_explored
            state = self.states[sid]
            actions = self.model.actions(state)
            if not actions:
                self.policy_actions.append(-1)  # terminal
                self._policy_explored += 1
                continue
            a = self.policy(state)
            self.policy_actions.append(actions.index(a))
            for t in self.model.apply(a, state):
                if t.probability == 0.0:
                    continue
                self._mdp.add_transition(
                    sid, 0, self._id_of(t.state),
                    probability=t.probability, reward=t.reward,
                    progress=t.progress)
            self._policy_explored += 1

    def explore_aside_policy(self, max_states: int = 0):
        """Expand the non-policy actions of every policy-explored state;
        newly found states then get their policy action expanded too."""
        self.explore_along_policy(max_states)
        while self._fully_explored < self._policy_explored:
            if max_states and self.n_states > max_states:
                raise RuntimeError(
                    f"state budget exceeded: {self.n_states} > {max_states}")
            sid = self._fully_explored
            state = self.states[sid]
            actions = self.model.actions(state)
            pa = self.policy_actions[sid]
            aid = 0  # the policy action occupies slot 0
            for i, a in enumerate(actions):
                if i == pa:
                    continue  # already explored as slot 0
                aid += 1
                for t in self.model.apply(a, state):
                    if t.probability == 0.0:
                        continue
                    self._mdp.add_transition(
                        sid, aid, self._id_of(t.state),
                        probability=t.probability, reward=t.reward,
                        progress=t.progress)
            self._fully_explored += 1
        # states discovered off-policy get their policy action expanded
        # too, under the same budget — so the caller's cap is honored and
        # a later mdp() call has nothing unbudgeted left to do
        self.explore_along_policy(max_states)

    def mdp(self, max_states: int = 0) -> MDP:
        """Finish policy exploration (every reachable state must at least
        abort into honest play) and return a copy of the table."""
        self.explore_along_policy(max_states)
        m = self._mdp
        # shallow per-field copies: the flat lists hold immutable scalars
        out = MDP(n_states=self.n_states, n_actions=m.n_actions,
                  start=dict(m.start), src=list(m.src), act=list(m.act),
                  dst=list(m.dst), prob=list(m.prob),
                  reward=list(m.reward), progress=list(m.progress))
        out.check()
        return out
