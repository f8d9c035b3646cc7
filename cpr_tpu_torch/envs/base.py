"""Base contract for the port's attack environments (port of
cpr_tpu/envs/base.py).

Reference counterpart: the engine record `{n_actions; observation_length;
create; reset; step; low; high; policies}` (simulator/gym/intf.ml:3-13) and
its construction in `Engine.of_module` (simulator/gym/engine.ml:97-273).

Where the JAX package writes per-lane functions and vmaps them, every
function here takes the env state as a dataclass of tensors with a
leading lane axis (`[L]` per field, `[L, 2]` for the PRNG key) and works
on all lanes at once. `reset`/`step`/`_lane_step` are plain PyTorch and
run on any device.

The drivers — `init_lanes`, `reset_lanes`, `step_lanes`, `rollout` and
the function `make_episode_stats_fn` builds — dispatch on the device of
their tensors: on a CUDA tensor they launch the env's kernels (K2 the
fused episode stream, K3 the one-tick lane step; K10-bk, K10-eth,
K10-ts, K10-stree, K10-spar and K10-sdag for the DAG envs of `DagEnv`) or
raise; on a CPU tensor they run the plain
twins `stream_plain` and `step_lanes_plain`.
Where the JAX package donates the carry (base.py:259, :472) the port
updates it in place: after `step_lanes` and between chunks of the stats
driver the caller's carry tensors hold the new state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

# info keys mirror the reference step info list (simulator/gym/engine.ml:224-241)
INFO_KEYS = (
    "step_reward_attacker",
    "step_reward_defender",
    "step_progress",
    "step_chain_time",
    "step_sim_time",
    "episode_reward_attacker",
    "episode_reward_defender",
    "episode_progress",
    "episode_chain_time",
    "episode_sim_time",
    "episode_n_steps",
    "episode_n_activations",
)
EPISODE_KEYS = tuple(k for k in INFO_KEYS if k.startswith("episode_"))


def _lane_where(mask, a, b):
    """Per-lane select with the (n_lanes,) mask broadcast over trailing
    axes — the splice primitive of the resident lane API."""
    m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    return torch.where(m, a, b)


def map_state(fn, *states):
    """Apply `fn` tensor by tensor over states of one dataclass type
    (nested dataclasses and tuples, as the DAG envs' `dag.parents`, are
    mapped through)."""
    s0 = states[0]
    if dataclasses.is_dataclass(s0):
        return type(s0)(**{f.name: map_state(fn, *(getattr(s, f.name)
                                                   for s in states))
                           for f in dataclasses.fields(s0)})
    if isinstance(s0, tuple):
        return tuple(map_state(fn, *xs) for xs in zip(*states))
    return fn(*states)


def copy_state_(dst, src) -> None:
    """Write `src` into the tensors of `dst` (the in-place carry update)."""
    map_state(lambda d, s: d.copy_(s), dst, src)


def _index_params(params, idx):
    """The params of the lanes in `idx` (fields with a lane axis are
    indexed; scalars stay)."""
    return params.replace(**{
        f.name: getattr(params, f.name)[idx]
        for f in dataclasses.fields(params)
        if getattr(params, f.name).dim() > 0})


def _no_kernel(what, item):
    return NotImplementedError(
        f"{what}: no CUDA kernel for this yet (ROADMAP item {item})")


class TorchEnv:
    """Abstract batched environment.

    Subclasses define:
      n_actions: int
      fields: tuple[obs.Field, ...]
      unit_observation: bool
      reset(keys, params) -> (state, obs)
      step(state, actions, params) -> (state, obs, reward, done, info)
      observe(state) -> obs
      policies: dict[str, Callable[obs -> action]]
      scripted_policies: names of the policies the kernels implement,
          in kernel id order
    and, to run on CUDA, the kernel hooks `_empty_carry`,
    `_kernel_stream` and `_kernel_step_lanes`.
    """

    n_actions: int
    observation_length: int
    policies: dict[str, Callable]
    scripted_policies: tuple[str, ...] = ()
    # Envs whose state carries a `dag` set this to the most DAG rows a
    # fresh reset() populates: an auto-reset then switches only those
    # rows of every DAG plane (and n, overflow, live_floor and every
    # other field) to the fresh state, and rows >= R keep what they held
    # — the reference's logical reset (cpr_tpu/envs/base.py:85-119),
    # whose queries reject those stale rows through the gid and
    # exists() filters. None switches whole states.
    reset_dag_rows: int | None = None
    # ROADMAP item of the kernels an env without them waits for
    kernel_item = "8b"

    def select_reset(self, done, rstate, state):
        """where(done, rstate, state) for auto-reset streams, the logical
        reset where `reset_dag_rows` is set."""
        idx = done.nonzero().squeeze(1)
        return self._splice_reset(state, idx,
                                  map_state(lambda t: t[idx], rstate))

    def _splice_reset(self, state, idx, rstate):
        """`state` with the lanes `idx` switched to `rstate` (one fresh
        state per index) as `select_reset` switches them."""
        R = self.reset_dag_rows

        def whole(a, r):
            a = a.clone()
            a[idx] = r
            return a

        if R is None:
            return map_state(whole, state, rstate)

        def rows(a, r):
            if a.dim() == 1:
                return whole(a, r)
            a = a.clone()
            a[idx, :R] = r[:, :R]
            return a

        return state.replace(dag=map_state(rows, state.dag, rstate.dag), **{
            f.name: whole(getattr(state, f.name), getattr(rstate, f.name))
            for f in dataclasses.fields(state) if f.name != "dag"})

    def decode_obs(self, obs):
        """float observation -> per-field natural-scale int values
        (ssz_tools.ml:20-59 of_floatarray)."""
        from cpr_tpu_torch import obs as obslib
        return tuple(
            obslib.field_of_float(f, obs[..., i],
                                  self.unit_observation).to(torch.int32)
            for i, f in enumerate(self.fields))

    def reset(self, keys, params):
        raise NotImplementedError

    def step(self, state, action, params):
        raise NotImplementedError

    def observe(self, state):
        raise NotImplementedError

    def policy_from_ints(self, policy_id: int, state):
        """The scripted policy `policy_id` evaluated on the state (the
        kernels' form of the policy)."""
        raise NotImplementedError

    def finish_step(self, state, params, *, reward_attacker,
                    reward_defender, progress, chain_time,
                    extra_done=False):
        """Shared step epilogue (engine.ml:209-241): termination test,
        reward delta, the step_/episode_ info dict, and the last_*
        bookkeeping. Returns (state, obs, reward, done, info); the state
        must carry the common bookkeeping fields (steps, time, last_*)."""
        done = ~(
            (state.steps < params.max_steps)
            & (progress < params.max_progress)
            & (state.time < params.max_time)
        ) | extra_done
        reward = reward_attacker - state.last_reward_attacker
        info = {
            "step_reward_attacker": reward,
            "step_reward_defender": reward_defender - state.last_reward_defender,
            "step_progress": progress - state.last_progress,
            "step_chain_time": chain_time - state.last_chain_time,
            "step_sim_time": state.time - state.last_sim_time,
            "episode_reward_attacker": reward_attacker,
            "episode_reward_defender": reward_defender,
            "episode_progress": progress,
            "episode_chain_time": chain_time,
            "episode_sim_time": state.time,
            "episode_n_steps": state.steps.to(torch.float32),
            "episode_n_activations": state.n_activations.to(torch.float32),
        }
        state = state.replace(
            last_reward_attacker=reward_attacker,
            last_reward_defender=reward_defender,
            last_progress=progress,
            last_chain_time=chain_time,
            last_sim_time=state.time,
        )
        return state, self.observe(state), reward, done, info

    # -- plain stream pieces ----------------------------------------------

    def _stream_init(self, keys, params):
        """Episode-stream prologue shared by `rollout` and the stats
        drivers: split off the reset key and reset."""
        from cpr_tpu_torch import random
        return self.reset(random.threefry_plain(keys, 2)[..., 1, :], params)

    def _lane_step(self, state, action, params):
        """One auto-resetting transition of every lane: step, then reset
        from the post-step PRNG key where the episode ended.

        The reference resets every lane and selects; resetting only the
        lanes that are done gives the same bits (the kernels branch the
        same way). The splice is `select_reset`'s, logical reset included.

        Returns (state, obs_next, step_obs, reward, done, info) where
        `obs_next` is the continuation observation (post-reset at done)
        and `step_obs` is the raw post-step observation."""
        state, obs2, reward, done, info = self.step(state, action, params)
        obs_next = obs2
        idx = done.nonzero().squeeze(1)
        if idx.numel():
            rstate, robs = self.reset(state.key[idx],
                                      _index_params(params, idx))
            state = self._splice_reset(state, idx, rstate)
            obs_next = obs2.clone()
            obs_next[idx] = robs
        return state, obs_next, obs2, reward, done, info

    def _autoreset_body(self, params, policy):
        """One step of an auto-resetting episode stream on every lane:
        `body((state, obs)) -> ((state, obs_next), (obs, action, reward,
        done, info))`, the unit `stream_plain` loops over."""
        act = self._policy_fn(policy)

        def body(carry):
            state, obs = carry
            action = act(state, obs).to(torch.int32)
            state, obs_next, _, reward, done, info = self._lane_step(
                state, action, params)
            return (state, obs_next), (obs, action, reward, done, info)

        return body

    def _policy_fn(self, policy):
        """obs/state -> actions for the plain drivers: the integer form
        for a scripted policy (as the kernels compute it), else the
        callable itself (a `train.ppo.NetPolicy` among them), which gets
        `(state, obs)` where it has `takes_state = True` (the lane-batched
        state: the reference's base.py:218-226) and `obs` otherwise."""
        pid = self.scripted_policy_id(policy)
        if pid is not None:
            return lambda state, obs: self.policy_from_ints(pid, state)
        if not callable(policy):
            raise ValueError(f"unknown policy {policy!r}")
        if getattr(policy, "takes_state", False):
            return policy
        return lambda state, obs: policy(obs)

    def scripted_policy_id(self, policy):
        """Kernel id of a scripted policy given by name, id or as one of
        this env class's `policies`; None for any other callable."""
        names = self.scripted_policies
        if isinstance(policy, int):
            if not 0 <= policy < len(names):
                raise ValueError(f"policy id {policy} out of range "
                                 f"0..{len(names) - 1}")
            return policy
        if isinstance(policy, str):
            if policy not in names:
                raise ValueError(f"{policy} is not a valid policy; choose "
                                 f"from {', '.join(names)}")
            return names.index(policy)
        if getattr(policy, "policy_owner", None) is type(self):
            return names.index(policy.policy_name)
        return None

    # -- plain twins of the kernels ---------------------------------------

    def stream_plain(self, carry, params, policy, length: int,
                     with_sums: bool = True, store_traj: bool = False):
        """Plain twin of K2: `length` auto-resetting steps on every lane,
        updating the carry (state, obs) in place. Returns (sums [7, L],
        n_done [L], traj) like `kernels.stream`, traj lane-major here
        (obs [L, T, 4], action/reward/done [L, T], info {key: [L, T]})."""
        state, obs = carry
        body = self._autoreset_body(params, policy) if length > 0 else None
        n = obs.shape[0]
        sums = torch.zeros((len(EPISODE_KEYS), n), dtype=torch.float32,
                           device=obs.device)
        n_done = torch.zeros((n,), dtype=torch.int32, device=obs.device)
        steps = []
        c = carry
        for _ in range(length):
            c, step = body(c)
            _, _, _, done, info = step
            if with_sums:
                for j, k in enumerate(EPISODE_KEYS):
                    sums[j] += torch.where(done, info[k],
                                           torch.zeros_like(info[k]))
                n_done += done.to(torch.int32)
            if store_traj:
                steps.append(step)
        s, o = c
        traj = None
        if store_traj:  # before the carry update: steps[0] holds its obs
            traj = (torch.stack([x[0] for x in steps], 1),
                    torch.stack([x[1] for x in steps], 1),
                    torch.stack([x[2] for x in steps], 1),
                    torch.stack([x[3] for x in steps], 1),
                    {k: torch.stack([x[4][k] for x in steps], 1)
                     for k in INFO_KEYS})
        copy_state_(state, s)
        obs.copy_(o)
        if not with_sums:
            sums = n_done = None
        return sums, n_done, traj

    def step_lanes_plain(self, carry, actions, admit_mask, fresh_states,
                         step_mask, params):
        """Plain twin of K3 (see `step_lanes`)."""
        state, obs = carry
        fstate, fobs = fresh_states
        s = map_state(lambda a, b: _lane_where(admit_mask, a, b),
                      fstate, state)
        o = _lane_where(admit_mask, fobs, obs)
        new_state, obs_next, step_obs, reward, done, info = self._lane_step(
            s, actions, params)
        live = step_mask
        copy_state_(state, map_state(lambda a, b: _lane_where(live, a, b),
                                     new_state, s))
        out_obs = _lane_where(live, step_obs, o)
        obs.copy_(_lane_where(live, obs_next, o))
        reward = torch.where(live, reward, torch.zeros_like(reward))
        done = done & live
        info = {k: torch.where(live, v, torch.zeros_like(v))
                for k, v in info.items()}
        return carry, (out_obs, reward, done, info)

    # -- kernel hooks -------------------------------------------------------

    def _empty_carry(self, n: int, device):
        raise _no_kernel(type(self).__name__, self.kernel_item)

    def _kernel_stream(self, carry, keys, init_mode, length, params,
                       policy_id, with_sums, store_traj, net=None,
                       extend_obs=False):
        raise _no_kernel(type(self).__name__, self.kernel_item)

    def _kernel_step_lanes(self, carry, actions, admit_mask, fresh_states,
                           step_mask, params, extend_obs=False):
        raise _no_kernel(type(self).__name__, self.kernel_item)

    # -- drivers (kernel on CUDA, plain twin on CPU) ------------------------

    def _stream(self, carry, keys, init_mode: int, length: int, params,
                policy, with_sums: bool, store_traj: bool = False):
        """Create (init_mode 1: stream prologue, 2: raw reset) or continue
        (0) a carry and advance it `length` steps. Returns
        (carry, sums, n_done, traj)."""
        t = keys if carry is None else carry[1]
        if t.device.type == "cuda":
            pid = None
            if length > 0:
                pid = self.scripted_policy_id(policy)
                if pid is None and not getattr(policy, "is_net_policy",
                                               False):
                    raise NotImplementedError(
                        "on CUDA the stream kernels run the env's scripted "
                        f"policies ({', '.join(self.scripted_policies)}) "
                        "and the actor-critic net of a train.ppo.NetPolicy "
                        "(K11-act); an arbitrary Python callable runs on "
                        "the CPU only")
            if carry is None:
                keys = keys.contiguous()
                carry = self._empty_carry(keys.shape[0], keys.device)
            net = policy if getattr(policy, "is_net_policy", False) else None
            sums, n_done, traj = self._kernel_stream(
                carry, keys, init_mode, length, params, pid or 0,
                with_sums, store_traj, net=net)
            if traj is not None:
                obs, action, reward, done, info = traj[:5]
                traj = (obs.transpose(0, 1), action.t(), reward.t(),
                        done.t(), {k: info[i].t()
                                   for i, k in enumerate(INFO_KEYS)})
            return carry, sums, n_done, traj
        if t.device.type != "cpu":
            raise ValueError(f"unsupported device {t.device}")
        if carry is None:
            state, obs = (self._stream_init(keys, params) if init_mode == 1
                          else self.reset(keys, params))
            # the carry owns one tensor per field: it is updated in place
            carry = (map_state(torch.clone, state), obs.clone())
        sums, n_done, traj = self.stream_plain(
            carry, params, policy, length, with_sums, store_traj)
        return carry, sums, n_done, traj

    def init_lanes(self, keys, params):
        """Fresh per-lane (state, obs) carry from per-lane keys, using
        the same stream prologue as `rollout` (split, then reset) — a
        lane admitted with key K therefore replays `rollout(K, ...)`
        bit-for-bit."""
        return self._stream(None, keys, 1, 0, params, None, False)[0]

    def reset_lanes(self, keys, params):
        """Fresh per-lane (state, obs) carry via a raw reset (no
        prologue split) — the gym adapters' seeding."""
        return self._stream(None, keys, 2, 0, params, None, False)[0]

    def step_lanes(self, carry, actions, admit_mask, fresh_states,
                   step_mask, params):
        """Advance the resident lane block one tick.

        carry        -- (state, obs) with leading lane axis; updated IN
                        PLACE (the JAX package donates it) and returned.
                        Do not pass tensors aliasing it as `fresh_states`.
        actions      -- int32 (n_lanes,); only read where step_mask.
        admit_mask   -- bool (n_lanes,); lanes spliced from
                        `fresh_states` BEFORE stepping (admission).
        fresh_states -- (state, obs) like carry (e.g. from init_lanes /
                        reset_lanes); only read where admit_mask.
        step_mask    -- bool (n_lanes,); lanes that execute one
                        `_lane_step` this tick.  Held lanes (neither
                        admitted nor stepped) keep their state — PRNG
                        key included — bit-exactly.

        Returns (carry, (obs, reward, done, info)) where the output
        `obs` is the raw post-step observation for stepped lanes
        (terminal at done; the continuation obs lives in the carry) and
        the post-admission held observation for the rest.
        reward/done/info are zero/False/zero outside step_mask. K3 on
        CUDA, `step_lanes_plain` on the CPU."""
        obs = carry[1]
        if obs.device.type == "cuda":
            out = self._kernel_step_lanes(carry, actions, admit_mask,
                                          fresh_states, step_mask, params)
            return carry, out
        if obs.device.type != "cpu":
            raise ValueError(f"unsupported device {obs.device}")
        return self.step_lanes_plain(carry, actions, admit_mask,
                                     fresh_states, step_mask, params)

    def rollout(self, keys, params, policy, n_steps: int,
                with_metrics: bool = False):
        """Run one auto-resetting episode stream per key for `n_steps`
        env steps.

        Returns per-step (obs, action, reward, done, info) with a lane
        axis and a time axis, `[L, T, ...]` (the layout of
        `jax.vmap(rollout)`); a single key `[2]` gives `[T, ...]`."""
        if with_metrics:
            raise NotImplementedError(
                "rollout(with_metrics=True) needs device metrics, not "
                "ported yet (ROADMAP item 14, K17)")
        single = keys.dim() == 1
        if single:
            keys = keys[None]
        _, _, _, traj = self._stream(None, keys, 1, n_steps, params, policy,
                                     False, True)
        if single:
            obs, action, reward, done, info = traj
            traj = (obs[0], action[0], reward[0], done[0],
                    {k: v[0] for k, v in info.items()})
        return traj

    def episode_stats(self, keys, params, policy, n_steps: int):
        """Final-info aggregation over completed episodes, per lane; a
        single key `[2]` gives 0-dim stats, as the reference's
        (base.py:330-340) does."""
        single = keys.dim() == 1
        stats = self.make_episode_stats_fn(params, policy, n_steps)(
            keys[None] if single else keys)
        return {k: v[0] for k, v in stats.items()} if single else stats

    def make_episode_stats_fn(self, params, policy, n_steps: int,
                              chunk: int | None = None,
                              collect_metrics: bool = False,
                              mesh=None, mesh_axis: str = "d"):
        """Build `fn(keys) -> per-lane stats dict`, optionally split into
        several launches of `chunk` env steps each.

        Each chunk is one K2 launch on CUDA (the first one also runs the
        stream prologue from the keys); the host loop carries the state
        between chunks in place and adds the per-chunk done-masked sums,
        as the reference's chunked driver does. The unchunked call is one
        chunk. Per-lane means divide the sums by max(n_done, 1) in
        float32; `n_episodes` is the done count."""
        if chunk is not None and chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        if collect_metrics:
            raise NotImplementedError(
                "collect_metrics needs device metrics, not ported yet "
                "(ROADMAP item 14, K17)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded episode streams are not ported yet "
                "(ROADMAP item 13)")
        if chunk is None or chunk >= n_steps:
            lengths = (n_steps,)
        else:
            n_full, rem = divmod(n_steps, chunk)
            lengths = (chunk,) * n_full + ((rem,) if rem else ())

        def fn(keys):
            carry, totals, n_done = None, None, None
            for length in lengths:
                first = carry is None
                carry, sums, d, _ = self._stream(
                    carry, keys, 1 if first else 0, length, params, policy,
                    True)
                totals = sums if first else totals + sums
                n_done = d if first else n_done + d
            nd = torch.clamp(n_done, min=1)
            stats = {k: totals[j] / nd for j, k in enumerate(EPISODE_KEYS)}
            stats["n_episodes"] = n_done
            return stats

        return fn


class DagEnv(TorchEnv):
    """Base of the envs whose state is a lane-batched `core.dag.Dag` plus
    per-lane scalars (bk, ethereum, tailstorm, stree, spar, sdag), with
    the hooks of
    their K10 kernels.

    A subclass sets `state_cls`, `int_fields`, `bool_fields` (its scalar
    fields besides the float32 ones and `key`), `plane_fields` (its
    per-slot bool planes [L, B] outside the DAG), `kernel_name` (its launch
    counter), `kernel_lib` (its K10 library's entry points,
    `cpr_k10_<kernel_lib>_*`), `kernel_config()`, and the DAG modes
    `capacity`, `max_parents`, `ring`, `anc_masks`, `lift`. The kernels'
    limits are `kernels.check_dag_modes`'; full mode runs in the plain
    version only."""

    reset_dag_rows = 2
    kernel_item = "8c"
    bool_fields: tuple[str, ...] = ()
    plane_fields: tuple[str, ...] = ()

    def kernel_config(self) -> dict[str, int]:
        """The env's static options for its K10 kernel, by the field
        names of `EnvConfig` (csrc/dag_env.cuh) but `unit`."""
        raise NotImplementedError

    def _check_kernel(self):
        from cpr_tpu_torch import kernels
        kernels.check_dag_modes(type(self).__name__, self.capacity,
                                self.max_parents, self.ring, self.anc_masks,
                                self.lift)

    def _empty_carry(self, n: int, device):
        from cpr_tpu_torch.core import dag as D
        self._check_kernel()
        dag = D.empty(n, self.capacity, self.max_parents, lift=self.lift,
                      ring=self.ring, anc_masks=self.anc_masks,
                      device=device)

        def scalar(f):
            if f == "key":
                return torch.empty((n, 2), dtype=torch.int32, device=device)
            if f in self.plane_fields:
                return torch.empty((n, self.capacity), dtype=torch.bool,
                                   device=device)
            dt = (torch.int32 if f in self.int_fields else torch.bool
                  if f in self.bool_fields else torch.float32)
            return torch.empty((n,), dtype=dt, device=device)

        state = self.state_cls(dag=dag, **{
            f.name: scalar(f.name) for f in dataclasses.fields(self.state_cls)
            if f.name != "dag"})
        return state, torch.empty((n, self.observation_length),
                                  dtype=torch.float32, device=device)

    def _kernel_stream(self, carry, keys, init_mode, length, params,
                       policy_id, with_sums, store_traj, net=None,
                       extend_obs=False):
        from cpr_tpu_torch import kernels
        state, obs = carry
        return kernels.dag_stream(self, state, obs, keys, init_mode, length,
                                  params, policy_id, with_sums=with_sums,
                                  store_traj=store_traj, net=net,
                                  extend_obs=extend_obs)

    def _kernel_step_lanes(self, carry, actions, admit_mask, fresh_states,
                           step_mask, params, extend_obs=False):
        from cpr_tpu_torch import kernels
        state, obs = carry
        fstate, fobs = fresh_states
        out_obs, reward, done, info = kernels.dag_step_lanes(
            self, state, obs, actions, admit_mask, fstate, fobs, step_mask,
            params, extend_obs=extend_obs)
        return out_obs, reward, done, {k: info[i]
                                       for i, k in enumerate(INFO_KEYS)}


def relative_reward(info: dict[str, Any]) -> torch.Tensor:
    """attacker / (attacker + defender) at episode end
    (reference: gym/ocaml/cpr_gym/wrappers.py:8-26)."""
    a = info["episode_reward_attacker"]
    d = info["episode_reward_defender"]
    s = a + d
    return torch.where(s != 0, a / torch.where(s != 0, s, torch.ones_like(s)),
                       torch.zeros_like(s))


def reward_per_progress(info: dict[str, Any]) -> torch.Tensor:
    """attacker / progress at episode end
    (reference: gym/ocaml/cpr_gym/wrappers.py:29-51)."""
    a = info["episode_reward_attacker"]
    p = info["episode_progress"]
    return torch.where(p != 0, a / torch.where(p != 0, p, torch.ones_like(p)),
                       torch.zeros_like(p))
