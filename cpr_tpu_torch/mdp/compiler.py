"""Implicit -> explicit MDP compiler (exhaustive BFS).

Reference counterpart: mdp/lib/compiler.py:6-90. Same contract — BFS from
the start states, integer ids assigned on first sight, positional action
ids per state — but transitions are appended to flat arrays (the
device-ready layout) and the semantic action behind each positional slot
is recorded so policies can be executed outside the MDP (e.g. inside the
environments).
"""

from __future__ import annotations

from collections import deque

from cpr_tpu_torch.mdp.explicit import MDP, sum_to_one
from cpr_tpu_torch.mdp.implicit import Model


class Compiler:
    def __init__(self, model: Model):
        self.model = model
        self.state_map: dict = {}
        self.action_map: list[list] = []  # state id -> semantic actions
        self.states: list = []  # state id -> state (for debugging/policies)
        self._queue: deque = deque()
        self._explored: set[int] = set()
        self._mdp = MDP()
        for state, probability in model.start():
            sid = self._id_of(state)
            self._mdp.start[sid] = probability

    def _id_of(self, state) -> int:
        sid = self.state_map.get(state)
        if sid is None:
            sid = len(self.state_map)
            self.state_map[state] = sid
            self.states.append(state)
            self.action_map.append([])
            self._queue.append(state)
        return sid

    @property
    def n_states(self) -> int:
        return len(self.state_map)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def explore(self, steps: int = 1000) -> bool:
        """Explore up to `steps` states; returns False when exhausted."""
        for _ in range(steps):
            if not self._queue:
                return False
            self.step()
        return True

    def step(self):
        state = self._queue.popleft()
        sid = self.state_map[state]
        if sid in self._explored:
            return
        self._explored.add(sid)
        actions = list(self.model.actions(state))
        self.action_map[sid] = actions
        for aid, action in enumerate(actions):
            transitions = self.model.apply(action, state)
            assert sum_to_one([t.probability for t in transitions]), (state, action)
            for t in transitions:
                self._mdp.add_transition(
                    sid, aid, self._id_of(t.state),
                    probability=t.probability, reward=t.reward,
                    progress=t.progress,
                )

    def mdp(self, finish_exploration: bool = True) -> MDP:
        if finish_exploration:
            while self._queue:
                self.step()
        elif self._queue:
            raise RuntimeError("unfinished exploration")
        self._mdp.n_states = max(self._mdp.n_states, len(self.state_map))
        self._mdp.check()
        return self._mdp
