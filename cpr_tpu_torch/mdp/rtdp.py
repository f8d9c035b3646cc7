"""Real-Time Dynamic Programming over implicit models (host).

Reference counterpart: `cpr_tpu/mdp/rtdp.py` (after mdp/lib/rtdp.py:27-458),
host code, copied with the port's imports: trajectory-sampled
asynchronous value iteration with eps-greedy + eps-honest exploration and
"exploring starts" drawn from a recent-state buffer. Per-state
bookkeeping lives in growable numpy arrays and each state's outgoing
transitions are cached as flat (prob, dst, reward, progress) arrays, so
a Bellman backup is two gathers and a dot product; `mdp()` hands the
partially-explored table to `TensorMDP.value_iteration` for polishing.
The same seed gives the reference's walk.

States are hashable values here; pass `state_key_fn` only if full
states are too large to keep as dict keys.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np

from cpr_tpu_torch.mdp.explicit import MDP
from cpr_tpu_torch.mdp.implicit import Model


@dataclass
class _ActionTable:
    """Cached outgoing transitions of one state: one row per action."""

    probs: list = field(default_factory=list)  # list[np.ndarray]
    dsts: list = field(default_factory=list)
    rews: list = field(default_factory=list)
    prgs: list = field(default_factory=list)
    honest: int = -1


class RTDP:
    """All exploration randomness flows through ONE explicit stream:
    `seed` builds a private `random.Random(seed)` (never the module
    global, so two RTDP instances — or RTDP and anything else using
    `random` — cannot perturb each other), or pass `rng` to share /
    control the stream directly (any object with the random.Random
    surface: random(), randrange(), choice(), choices()).  Same seed
    or same-state rng -> bit-identical runs; this is the deterministic
    host oracle for the device walkers (cpr_tpu_torch/mdp/rtdp_graph.py)."""

    def __init__(self, model: Model, *, eps: float, eps_honest: float = 0.0,
                 es: float = 0.0, es_threshold: int = 500_000,
                 state_key_fn=None, seed: int = 0, rng=None):
        assert 0.0 <= eps <= 1.0 and 0.0 <= eps_honest <= 1.0
        assert eps + eps_honest <= 1.0 and 0.0 <= es <= 1.0
        self.model = model
        self.eps = eps
        self.eps_honest = eps_honest
        self.es = es
        self.es_threshold = es_threshold
        self._keep_full = state_key_fn is None
        self.key_of = state_key_fn or (lambda s: s)
        self.rng = rng if rng is not None else random.Random(seed)

        self._idx: dict = {}  # state key -> int id
        self._full: dict = {}  # int id -> full state (kept while needed)
        self._tables: dict[int, _ActionTable] = {}  # explored states only
        cap = 1024
        self.value = np.zeros(cap, np.float64)
        self.progress = np.zeros(cap, np.float64)
        self.count = np.zeros(cap, np.int64)

        self.es_buf: dict[int, tuple] = {}  # id -> (full state, last seen)
        self.i = 0
        self.n_episodes = 0
        self.episode_progress = 0.0
        self.progress_ewma = 0.0

        self.start_ids = []
        self.start_probs = []
        for s, p in model.start():
            self.start_ids.append(self._id_of(s))
            self.start_probs.append(p)
        self._start_new_episode()

    # -- state table -----------------------------------------------------

    def _id_of(self, full_state) -> int:
        key = self.key_of(full_state)
        sid = self._idx.get(key)
        if sid is None:
            sid = len(self._idx)
            self._idx[key] = sid
            if sid >= self.value.shape[0]:
                for name in ("value", "progress", "count"):
                    arr = getattr(self, name)
                    grown = np.zeros(arr.shape[0] * 2, arr.dtype)
                    grown[: arr.shape[0]] = arr
                    setattr(self, name, grown)
            if self._keep_full or not hasattr(self, "cur_id"):
                # with a key fn, full states are discarded after init
                # (start states stay; trajectories re-derive on demand)
                self._full[sid] = full_state
            v, p = self._initial_estimate(full_state)
            self.value[sid] = v
            self.progress[sid] = p
        return sid

    def _initial_estimate(self, full_state):
        """Optimistic-ish guidance: value of a fair shutdown from here
        (rtdp.py:281-306)."""
        v = p = 0.0
        for t in self.model.shutdown(full_state):
            key = self.key_of(t.state)
            sid = self._idx.get(key)
            fv = self.value[sid] if sid is not None else 0.0
            fp = self.progress[sid] if sid is not None else 0.0
            v += t.probability * (t.reward + fv)
            p += t.probability * (t.progress + fp)
        return v, p

    def _table_of(self, sid: int, full_state) -> _ActionTable:
        tab = self._tables.get(sid)
        if tab is not None:
            return tab
        tab = _ActionTable()
        actions = self.model.actions(full_state)
        for a in actions:
            ts = [t for t in self.model.apply(a, full_state)
                  if t.probability > 0.0]
            tab.probs.append(np.array([t.probability for t in ts]))
            tab.dsts.append(np.array([self._id_of(t.state) for t in ts]))
            tab.rews.append(np.array([t.reward for t in ts]))
            tab.prgs.append(np.array([t.progress for t in ts]))
        if actions:
            tab.honest = actions.index(self.model.honest(full_state))
        self._tables[sid] = tab
        return tab

    # -- episode control -------------------------------------------------

    def _start_new_episode(self):
        self.episode_progress = 0.0
        if self.es > 0.0 and self.rng.random() < self.es and self.es_buf:
            expired = [sid for sid, (_, seen) in self.es_buf.items()
                       if self.i - seen >= self.es_threshold]
            for sid in expired:
                del self.es_buf[sid]
            if self.es_buf:
                sid = self.rng.choice(list(self.es_buf))
                self.cur_id, self.cur_state = sid, self.es_buf[sid][0]
                return
        r = self.rng.random() * sum(self.start_probs)
        acc = 0.0
        for sid, p in zip(self.start_ids, self.start_probs):
            acc += p
            if r <= acc:
                break
        self.cur_id, self.cur_state = sid, self._full[sid]

    def _reset(self):
        self.n_episodes += 1
        self.progress_ewma = (self.progress_ewma * 0.999
                              + 0.001 * self.episode_progress)
        self._start_new_episode()

    # -- the loop --------------------------------------------------------

    def step(self):
        self.i += 1
        sid, full = self.cur_id, self.cur_state
        self.count[sid] += 1
        tab = self._table_of(sid, full)
        n = len(tab.probs)
        if n == 0:  # terminal
            self._reset()
            return

        best_a, best_q, best_p = 0, 0.0, 0.0
        for a in range(n):
            q = float(tab.probs[a] @ (tab.rews[a] + self.value[tab.dsts[a]]))
            if q > best_q or a == 0:
                best_a, best_q = a, q
                best_p = float(tab.probs[a]
                               @ (tab.prgs[a] + self.progress[tab.dsts[a]]))
        self.value[sid] = best_q
        self.progress[sid] = best_p

        x = self.rng.random()
        greedy = False
        if x < self.eps:
            a = self.rng.randrange(n)
        elif x < self.eps + self.eps_honest:
            a = tab.honest
        else:
            a, greedy = best_a, True

        j = self.rng.choices(range(len(tab.probs[a])),
                             weights=tab.probs[a])[0]
        dst = int(tab.dsts[a][j])
        self.episode_progress += float(tab.prgs[a][j])
        nxt_full = self._full.get(dst)
        if nxt_full is None:
            # re-derive the full state from the model transition
            action = self.model.actions(full)[a]
            for t in self.model.apply(action, full):
                if self._idx.get(self.key_of(t.state)) == dst:
                    nxt_full = t.state
                    break
        self.cur_id, self.cur_state = dst, nxt_full
        if greedy and self.es > 0.0:  # buffer only feeds exploring starts
            self.es_buf[dst] = (nxt_full, self.i)

    def run(self, steps: int):
        for _ in range(steps):
            self.step()
        return self

    def set_exploration(self, *, eps=None, eps_honest=None, es=None):
        if eps is not None:
            self.eps = eps
        if eps_honest is not None:
            self.eps_honest = eps_honest
        if es is not None:
            self.es = es

    # -- extraction ------------------------------------------------------

    @property
    def n_states(self) -> int:
        return len(self._idx)

    def start_value_and_progress(self):
        v = sum(p * self.value[sid]
                for sid, p in zip(self.start_ids, self.start_probs))
        g = sum(p * self.progress[sid]
                for sid, p in zip(self.start_ids, self.start_probs))
        return float(v), float(g)

    def mdp(self):
        """Extract the partially-explored MDP (rtdp.py:308-387): explored
        states keep their cached transitions; frontier states get one
        pseudo-action to a terminal sink paying their current value
        estimate.  Returns dict(mdp=, policy=, value=)."""
        n = self.n_states
        terminal = n
        m = MDP()
        policy = np.full(n + 1, -1, np.int64)
        value = np.zeros(n + 1, np.float64)
        value[:n] = self.value[:n]
        for sid in range(n):
            tab = self._tables.get(sid)
            if tab is None:
                m.add_transition(sid, 0, terminal, probability=1.0,
                                 reward=float(self.value[sid]), progress=0.0)
                policy[sid] = 0
                continue
            if not tab.probs:
                continue  # true terminal state
            best_a, best_q = 0, -np.inf
            for a in range(len(tab.probs)):
                q = float(tab.probs[a]
                          @ (tab.rews[a] + self.value[tab.dsts[a]]))
                for j in range(len(tab.probs[a])):
                    m.add_transition(
                        sid, a, int(tab.dsts[a][j]),
                        probability=float(tab.probs[a][j]),
                        reward=float(tab.rews[a][j]),
                        progress=float(tab.prgs[a][j]))
                if q > best_q:
                    best_a, best_q = a, q
            policy[sid] = best_a
        m.n_states = n + 1
        for sid, p in zip(self.start_ids, self.start_probs):
            m.start[sid] = p
        m.check()
        return dict(mdp=m, policy=policy, value=value)
