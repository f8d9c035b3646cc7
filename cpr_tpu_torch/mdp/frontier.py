"""Frontier-batched implicit -> explicit MDP compiler.

Reference counterpart: `cpr_tpu/mdp/frontier.py` (`FrontierCompiler`),
host code, copied with the port's imports. The serial `Compiler`
explores one state per step; this compiler expands whole frontiers:

* **Rounds.** A round expands every state discovered in the previous
  round (one contiguous id range), collects the successors columnar and
  appends one numpy chunk per round through `MDP.add_transitions`.
* **Id determinism.** New states get ids in (source id, action slot,
  transition order), which is FIFO BFS order, so the result is bit
  for bit the serial `Compiler`'s: state ids, columns, start map and
  action_map. Dedup of worker-pickled keys runs vectorized (np.unique),
  with representatives mapped back in first-occurrence order.
* **Workers.** A frontier can be sharded across worker processes (spawn
  context by default, `CPR_MDP_COMPILE_MP_CONTEXT` overrides); payloads
  merge in shard order, so any worker count gives the same bytes.
  Workers import the port, never jax.
* **Validation.** A vectorized per-round probability-mass check with
  `sum_to_one`'s tolerance, raising AssertionError((state, action)).
* **Telemetry.** One `mdp_compile` event per compile with the
  reference's fields.
* **Tracer.** `trace_params=True` carries the monomial tracer's
  (coef, expo) columns through the collect for `param_mdp()`
  (`cpr_tpu_torch.mdp.grid.parametric_compile`).

Compile checkpoints (`checkpoint_path=`) are not ported (ROADMAP
item 6) and raise.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from cpr_tpu_torch import telemetry
from cpr_tpu_torch.telemetry import now

WORKERS_ENV_VAR = "CPR_MDP_COMPILE_WORKERS"
MP_CONTEXT_ENV_VAR = "CPR_MDP_COMPILE_MP_CONTEXT"
_PICKLE_PROTO = 5


def resolve_workers(n: int | None = None) -> int:
    """Worker-process count: explicit argument, else
    CPR_MDP_COMPILE_WORKERS, else 1 (inline expansion)."""
    if n is None:
        n = int(os.environ.get(WORKERS_ENV_VAR, "1") or 1)
    return max(1, int(n))


def _expand_states(model, states, trace_params: bool,
                   with_keys: bool = False) -> dict:
    """Expand one frontier shard in order into a columnar payload:
    per-state semantic actions, per-(state, action) transition counts,
    flat transition columns in (state, action slot, transition) order
    and each successor state; `with_keys` (worker shards) also pickles
    a dedup key per successor."""
    actions_out: list = []
    tcounts: list[int] = []
    probs: list = []
    rewards: list = []
    progresses: list = []
    succs: list = []
    for state in states:
        actions = list(model.actions(state))
        actions_out.append(actions)
        for action in actions:
            ts = model.apply(action, state)
            tcounts.append(len(ts))
            probs.extend(t.probability for t in ts)
            rewards.extend(t.reward for t in ts)
            progresses.extend(t.progress for t in ts)
            succs.extend(t.state for t in ts)
    if trace_params:
        from cpr_tpu_torch.mdp.grid import _extract_param

        ce = [_extract_param(p, "transition prob") for p in probs]
        coef = np.asarray([c for c, _ in ce], np.float64)
        expo = np.asarray([e for _, e in ce],
                          np.int16).reshape(len(ce), 4)
    else:
        coef = expo = None
    return dict(
        actions=actions_out,
        tcounts=np.asarray(tcounts, np.int64),
        # plain numbers and Param tracers alike (__float__)
        val=np.asarray(probs, np.float64),
        coef=coef, expo=expo,
        reward=np.asarray(rewards, np.float64),
        progress=np.asarray(progresses, np.float64),
        succs=succs,
        keys=([pickle.dumps(s, _PICKLE_PROTO) for s in succs]
              if with_keys else None),
    )


# worker-process state: the model is shipped once through the pool
# initializer, not once per round or shard
_WORKER: dict = {"model": None, "trace_params": False}


def _worker_init(model_blob: bytes, trace_params: bool):
    _WORKER["model"] = pickle.loads(model_blob)
    _WORKER["trace_params"] = bool(trace_params)


def _worker_expand(states):
    return _expand_states(_WORKER["model"], states,
                          _WORKER["trace_params"], with_keys=True)


class FrontierCompiler:
    """Batched twin of `Compiler`: the same `mdp()` entry point and
    `state_map` / `states` / `action_map` surfaces, bit-identical
    output. Knobs: `n_workers` (frontiers sharded across a process
    pool), `trace_params` (collect the tracer's coef/expo columns for
    `param_mdp()`), `protocol`/`cutoff` labels for the `mdp_compile`
    event."""

    # frontiers smaller than n_workers * min_shard expand inline: IPC
    # costs more than the round for the tiny early frontiers
    min_shard = 16

    def __init__(self, model, *, n_workers: int | None = None,
                 checkpoint_path: str | None = None,
                 trace_params: bool = False,
                 protocol: str | None = None,
                 cutoff: int | None = None):
        if checkpoint_path is not None:
            raise NotImplementedError(
                "compile checkpoints (checkpoint_path=) are not ported "
                "yet: they need the resilience checkpoints, ROADMAP item 6")
        self.model = model
        self.n_workers = resolve_workers(n_workers)
        self.trace_params = bool(trace_params)
        self.protocol = protocol
        self.cutoff = cutoff
        self._model_blob = pickle.dumps(model, _PICKLE_PROTO)
        self.state_map: dict = {}
        self.states: list = []
        self.action_map: list[list] = []
        self._start: dict = {}
        self._cols: list[tuple] = []    # per-round column chunks
        self._pcols: list[tuple] = []   # per-round (coef, expo) chunks
        self._explored_upto = 0
        self._round = 0
        self._elapsed = 0.0
        self._result = None
        self._pool = None
        for state, probability in model.start():
            sid = self._id_of(state)
            self._start[sid] = probability

    # -- state table ------------------------------------------------------

    def _id_of(self, state) -> int:
        sid = self.state_map.get(state)
        if sid is None:
            sid = len(self.state_map)
            self.state_map[state] = sid
            self.states.append(state)
            self.action_map.append([])
        return sid

    @property
    def n_states(self) -> int:
        return len(self.state_map)

    # -- expansion --------------------------------------------------------

    def _expand(self, frontier: list) -> list[dict]:
        if (self.n_workers <= 1
                or len(frontier) < self.n_workers * self.min_shard):
            return [_expand_states(self.model, frontier,
                                   self.trace_params)]
        if self._pool is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            ctx = multiprocessing.get_context(
                os.environ.get(MP_CONTEXT_ENV_VAR, "spawn"))
            self._pool = ProcessPoolExecutor(
                max_workers=self.n_workers, mp_context=ctx,
                initializer=_worker_init,
                initargs=(self._model_blob, self.trace_params))
        k = self.n_workers
        n = len(frontier)
        shards = [frontier[n * i // k: n * (i + 1) // k]
                  for i in range(k)]
        futs = [self._pool.submit(_worker_expand, s)
                for s in shards if s]
        # deterministic merge: results gathered in shard order
        return [f.result() for f in futs]

    def _absorb(self, lo: int, hi: int, payloads: list[dict]):
        """Merge one round's shard payloads (in shard order), validate
        probability mass, assign ids to the new states in first-sight
        order, and append the round's columns as one bulk chunk."""
        actions: list = []
        for p in payloads:
            actions.extend(p["actions"])
        self.action_map[lo:hi] = actions
        tcounts = np.concatenate([p["tcounts"] for p in payloads])
        total = int(tcounts.sum())
        na = np.asarray([len(a) for a in actions], np.int64)
        # (state, action) of each per-round transition group
        sid_of_group = np.repeat(np.arange(lo, hi, dtype=np.int64), na)
        off = np.cumsum(na) - na
        act_of_group = (np.arange(int(na.sum()), dtype=np.int64)
                        - np.repeat(off, na))
        if (tcounts == 0).any():
            g = int(np.flatnonzero(tcounts == 0)[0])
            state = self.states[int(sid_of_group[g])]
            action = actions[int(sid_of_group[g]) - lo][
                int(act_of_group[g])]
            raise AssertionError((state, action))
        if total == 0:
            return
        val = np.concatenate([p["val"] for p in payloads])
        reward = np.concatenate([p["reward"] for p in payloads])
        progress = np.concatenate([p["progress"] for p in payloads])
        succs: list = []
        for p in payloads:
            succs.extend(p["succs"])
        # per-round probability-mass validation: transitions are
        # contiguous per (state, action), so group sums are one reduceat
        # (sum_to_one's tolerance: rel 1e-9, no absolute slack)
        starts = np.cumsum(tcounts) - tcounts
        sums = np.add.reduceat(val, starts)
        bad = ~np.isclose(sums, 1.0, rtol=1e-9, atol=0.0)
        if bad.any():
            g = int(np.flatnonzero(bad)[0])
            state = self.states[int(sid_of_group[g])]
            action = actions[int(sid_of_group[g]) - lo][
                int(act_of_group[g])]
            raise AssertionError((state, action))
        src = np.repeat(sid_of_group, tcounts).astype(np.int32)
        act = np.repeat(act_of_group, tcounts).astype(np.int32)
        if payloads[0]["keys"] is not None:
            # dedup over worker-pickled keys: unique keys, whose
            # representatives are walked in first-occurrence order so
            # new ids land in the serial first-sight order; the state
            # dict lookup runs on the representatives only, so a model
            # whose equal states pickle differently loses batching,
            # never correctness (every pickle ends with the non-null STOP
            # opcode, so the fixed-width padding cannot collide)
            keys: list = []
            for p in payloads:
                keys.extend(p["keys"])
            karr = np.asarray(keys)
            uniq, first_idx, inverse = np.unique(
                karr, return_index=True, return_inverse=True)
            uid_gid = np.empty(len(uniq), np.int64)
            for u in np.argsort(first_idx, kind="stable"):
                uid_gid[u] = self._id_of(succs[int(first_idx[u])])
            dst = uid_gid[inverse].astype(np.int32)
        else:
            idf = self._id_of
            dst = np.fromiter((idf(s) for s in succs), np.int32,
                              len(succs))
        self._cols.append((src, act, dst, val, reward, progress))
        if self.trace_params:
            self._pcols.append((
                np.concatenate([p["coef"] for p in payloads]),
                np.concatenate([p["expo"] for p in payloads])))

    # -- the round driver -------------------------------------------------

    def _run(self):
        t0 = now()
        try:
            # the state and column tables live on the host: an RSS
            # watermark, sampled once per round
            with telemetry.memory_watermark("mdp_compile") as wm:
                while self._explored_upto < len(self.states):
                    self._round += 1
                    lo, hi = self._explored_upto, len(self.states)
                    self._absorb(lo, hi,
                                 self._expand(self.states[lo:hi]))
                    self._explored_upto = hi
                    wm.sample()
        finally:
            self._elapsed += now() - t0
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None

    # -- results ----------------------------------------------------------

    def mdp(self):
        """Run the compile to exhaustion and return the MDP, bit for bit
        `Compiler(model).mdp()`'s; emits the `mdp_compile` event."""
        if self._result is not None:
            return self._result
        from cpr_tpu_torch.mdp.explicit import MDP

        self._run()
        m = MDP()
        m.start = dict(self._start)
        for cols in self._cols:
            m.add_transitions(*cols)
        m.n_states = max(m.n_states, len(self.states))
        m.consolidate()
        m.check()
        dt = self._elapsed
        telemetry.current().event(
            "mdp_compile", protocol=self.protocol, cutoff=self.cutoff,
            rounds=self._round, states=len(self.states),
            transitions=m.n_transitions, n_workers=self.n_workers,
            compile_s=round(dt, 6),
            states_per_sec=(round(len(self.states) / dt, 3)
                            if dt > 0 else None),
            resumed=False)
        self._result = m
        return m

    def param_mdp(self, *, probe_alpha: float, probe_gamma: float,
                  meta: dict | None = None):
        """The ParamMDP of a `trace_params=True` compile: the base MDP
        holds the probe-valued probability column, the (coef, expo)
        columns came through the collect round by round."""
        if not self.trace_params:
            raise ValueError("param_mdp() needs trace_params=True")
        from cpr_tpu_torch.mdp.explicit import MDP
        from cpr_tpu_torch.mdp.grid import ParamMDP, _extract_param

        m = self.mdp()
        if self._pcols:
            coef = np.concatenate([c for c, _ in self._pcols])
            expo = np.concatenate([e for _, e in self._pcols])
        else:
            coef = np.zeros(0, np.float64)
            expo = np.zeros((0, 4), np.int16)
        start_ids = np.asarray(sorted(m.start), np.int32)
        start_coef = np.empty(len(start_ids), np.float64)
        start_expo = np.empty((len(start_ids), 4), np.int16)
        for i, sid in enumerate(start_ids):
            start_coef[i], start_expo[i] = _extract_param(
                m.start[int(sid)], f"start prob of state {sid}")
        src, act, dst, prob, reward, progress = m.arrays()
        base = MDP(n_states=m.n_states, n_actions=m.n_actions,
                   start={int(s): float(p) for s, p in m.start.items()},
                   src=src, act=act, dst=dst, prob=prob, reward=reward,
                   progress=progress)
        return ParamMDP(mdp=base, coef=coef, expo=expo,
                        start_ids=start_ids, start_coef=start_coef,
                        start_expo=start_expo, probe_alpha=probe_alpha,
                        probe_gamma=probe_gamma, meta=dict(meta or {}))
