"""ResidentEngine: the device half of the serving layer (port of
cpr_tpu/serve/engine.py).

Owns the (state, obs) lane carry and two device entry points:

  * the interactive tick: the env's `step_lanes` (K3 on the card, its
    plain twin on the CPU): admit/step/hold any lane subset, one launch
    a tick;
  * the policy burst: `burst` steps of every policy-driven lane in one
    launch, each lane's action from its entry of the policy table (the
    env's scripted policies, loaded greedy nets, hot-swappable nets and
    their `#sample` variants). On the card this is K14
    (csrc/nakamoto_stream.cu) for Nakamoto and K14-dag
    (csrc/dag_env.cuh, in the env's K10 library) for the DAG envs; on
    the CPU `_burst_plain`, generic over the env's `_lane_step`. Nothing
    is stacked per step:
    each lane's first done (step index and episode aggregates) is
    captured into per-lane registers, which is all the server needs to
    complete a session. A launch whose lanes use no net runs without
    the net weights (the reference gates each net behind a scalar
    `lax.cond`).

Both paths advance lanes by the same `_lane_step` unit as `rollout`, and
admission seeds lanes through `init_lanes` (the rollout stream
prologue): a session admitted with seed S replays `rollout(PRNGKey(S))`.
`burst_run(admit=)` admits policy sessions with the burst: on the card
K14 takes their fresh states in its own launch. Where the reference
donates the carry, the port updates its tensors in place.

Always-on learning adds two planes, both fixed at construction:

  * `swap_policies=` registers net policies whose weights the burst
    reads at every launch; `swap_policy()` replaces a slot's weight
    tensor between launches, so lanes that completed before the swap
    are bit-identical to a never-swapped engine. A swap policy is
    `name -> (net, params, fingerprint)`: `net` a `train.ppo.
    ActorCritic` (the widths and the apply function: logits =
    `net(obs, params)[0]`), `params` its flat parameter vector.
  * `experience=C` keeps per-lane rings of C steps (learn/buffer.py;
    K15 inside K14 on the card), and `drain_experience()` consolidates
    the full windows at a burst boundary. `<name>#sample` variants draw
    categorical actions from the per-lane experience streams (fold_in
    of the lane's stream key by its step counter) instead of the greedy
    argmax.

The engine runs on the card unless `device="cpu"` asks for the host. On
the card `extra_policies` must be greedy `train.ppo.NetPolicy`s, and the
table may hold at most 16 entries over at most 4 nets (the plain burst
takes any): K14's nets take at most 4 actions, K14-dag's at most 24 on
the env's observation, and all of a table's policy MLPs must fit in a
block's shared memory beside K14-dag's static shared memory, as the
card reports it (the env's `check_burst_nets`). A table past those
limits raises NotImplementedError naming the kernel
(`env.burst_kernel_name`); there is no fallback to the
plain burst. `mesh=` (item 13) raises.

With `CPR_DEVICE_METRICS=1` (read at construction) the engine keeps a
`device_metrics.serve_spec()` accumulator on its device: each
`burst_run` folds its cells from the burst's live mask and first-done
registers (K17 on the card, one launch after the burst's), the warm-up
burst of `start` does not count, and `emit_metrics` folds the host walls
and the shed count into a copy and emits it (one readback).
"""

from __future__ import annotations

import numpy as np
import torch

from cpr_tpu_torch import _device, device_metrics, kernels, random, telemetry
from cpr_tpu_torch.envs.base import _lane_where, copy_state_, map_state
from cpr_tpu_torch.kernels import BURST_GREEDY as _GREEDY
from cpr_tpu_torch.kernels import BURST_SAMPLE as _SAMPLE
from cpr_tpu_torch.kernels import BURST_SCRIPTED as _SCRIPTED

# per-lane first-done registers a burst returns: `done` (lane finished
# an episode this burst), `done_step` (step index within the burst),
# and the episode aggregates captured at that step
CAPTURE_FIELDS = ("episode_reward_attacker", "episode_reward_defender",
                  "episode_progress", "episode_n_steps")
BURST_FIELDS = ("done", "done_step") + CAPTURE_FIELDS


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to cpr_tpu_torch yet (ROADMAP item {item})")


class _Staging:
    """One pinned host buffer and its device twin, carved into typed
    views (`layout`: name -> (dtype, shape)), so that a dispatch's host
    inputs go to the card in one copy and its outputs come back in
    one: `views` the device tensors, `host` numpy arrays over the pinned
    buffer, `raw` all of it as bytes."""

    def __init__(self, layout: dict, dev):
        self.views, self.host = {}, {}
        off, spans = 0, {}
        for name, (dt, shape) in layout.items():
            size = torch.empty(shape, dtype=dt).nbytes
            off = -(-off // 8) * 8
            spans[name] = (off, size, dt, shape)
            off += size
        self._dev = torch.empty(off, dtype=torch.uint8, device=dev)
        self._host = torch.empty(off, dtype=torch.uint8).pin_memory()
        self.raw = self._host.numpy()
        for name, (o, size, dt, shape) in spans.items():
            self.views[name] = self._dev[o:o + size].view(dt).view(shape)
            self.host[name] = self._host[o:o + size].view(dt).view(
                shape).numpy()

    @property
    def ptrs(self) -> tuple:
        """(host, device, bytes) of the whole buffer."""
        return (self._host.data_ptr(), self._dev.data_ptr(),
                self._dev.nbytes)


def _lane_keys(seeds: np.ndarray, dev) -> torch.Tensor:
    """PRNGKey(seed) per lane, [n, 2] int32 words (0, seed)."""
    words = np.zeros((len(seeds), 2), np.uint32)
    words[:, 1] = np.asarray(seeds, np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(dev)


class ResidentEngine:
    """One resident lane block + policy table over a single TorchEnv."""

    def __init__(self, env, params, *, n_lanes: int, burst: int = 256,
                 extra_policies: dict | None = None,
                 swap_policies: dict | None = None,
                 sample_policies: tuple = (), experience: int = 0,
                 mesh=None, mesh_axis: str = "d", device=None):
        if burst <= 0:
            raise ValueError(f"burst must be positive, got {burst}")
        if mesh is not None:
            raise _not_ported("ResidentEngine(mesh=...)", 13)
        self.device = _device.resolve(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card and not env.burst_kernel:
            raise NotImplementedError(
                f"{type(env).__name__}: no serve burst kernel for this env "
                "on CUDA; the plain burst runs it with device='cpu'")
        self.env = env
        self.params = params
        self.n_lanes = int(n_lanes)
        self.burst = int(burst)
        self.n_devices = 1

        # policy table: the env's scripted policies (observation-only)
        # plus loaded nets, in a deterministic order so policy ids are
        # stable for the life of the process. Each entry: (kind, arg,
        # fn): scripted (kernel policy id, the env's policy), greedy or
        # sampled net (net slot, None).
        names = [n for n in sorted(env.policies)
                 if not getattr(env.policies[n], "takes_state", False)]
        entries = []
        for n in names:
            pid = env.scripted_policy_id(n) if self.on_card else None
            entries.append((_SCRIPTED, pid, env.policies[n]))
        # net slots: name -> [net, params]; loaded greedy nets, then the
        # swappable ones (whose params swap_policy replaces)
        self._slots: list[list] = []
        self._slot_of: dict[str, int] = {}
        for name in sorted(extra_policies or {}):
            pol = extra_policies[name]
            names.append(name)
            if getattr(pol, "is_net_policy", False) and pol.greedy:
                self._check_nets([pol.net])
                self._slot_of["extra:" + name] = len(self._slots)
                self._slots.append([pol.net, self._as_params(pol.net.flat)])
                entries.append((_GREEDY, self._slot_of["extra:" + name],
                                None))
            elif self.on_card:
                raise NotImplementedError(
                    f"extra policy {name!r}: on CUDA the burst runs the "
                    "env's scripted policies and greedy train.ppo."
                    f"NetPolicy nets ({env.burst_kernel_name}); an "
                    "arbitrary callable runs on the CPU only")
            else:
                entries.append((_SCRIPTED, None, pol))
        if not entries:
            raise ValueError("no servable policies: env has only "
                             "takes_state policies and no extra_policies")

        # hot-swappable net policies: name -> (net, params, fingerprint);
        # `#sample` variants draw from the experience key streams and
        # therefore require the experience plane
        swap_policies = dict(swap_policies or {})
        sample_policies = tuple(sample_policies)
        unknown = [n for n in sample_policies if n not in swap_policies]
        if unknown:
            raise ValueError(f"sample_policies not registered as "
                             f"swap_policies: {unknown}")
        self.experience = int(experience)
        if sample_policies and not self.experience:
            raise ValueError(
                "sample_policies need the experience plane "
                "(experience > 0): per-lane action keys live in the "
                "experience buffer carry")
        self._swap_net: dict = {}
        self._swap_fingerprint: dict = {}
        for name in sorted(swap_policies):
            net, net_params, fp = swap_policies[name]
            self._check_nets([net])
            self._swap_net[name] = net
            self._swap_fingerprint[name] = fp
            self._slot_of[name] = len(self._slots)
            self._slots.append([net, self._as_params(net_params)])
            names.append(name)
            entries.append((_GREEDY, self._slot_of[name], None))
        for name in sorted(sample_policies):
            names.append(name + "#sample")
            entries.append((_SAMPLE, self._slot_of[name], None))
        self._entries = tuple(entries)
        self.policy_names = tuple(names)
        self.policy_ids = {n: i for i, n in enumerate(names)}
        if self.on_card:
            if len(entries) > kernels._BURST_TABLE:
                raise NotImplementedError(
                    f"{env.burst_kernel_name} takes at most "
                    f"{kernels._BURST_TABLE} policy table entries, this "
                    f"table has {len(entries)}")
            self._check_nets([s[0] for s in self._slots])

        self._exp = None
        self._carry = None
        self._fresh0 = None
        # on the card: the burst's staging buffers, made once by start()
        self._stage_burst = self._stage_regs = None
        # the K14 launcher over them, and the net slots it was made for
        self._launch = self._launch_key = None

        # device metrics (CPR_DEVICE_METRICS=1): the accumulator, made
        # by start() after the warm-up burst, and the bursts' host walls
        self._spec = device_metrics.serve_spec()
        self._with_metrics = device_metrics.enabled()
        self._macc = None
        self._burst_wall: list[float] = []

        # host-side throughput ledger (report() / the serve perf rows)
        self.steps = 0
        self.episodes = 0
        self.bursts = 0
        self.ticks = 0
        self.admitted = 0
        self.busy_s = 0.0
        self._occ_sum = 0.0
        # admission-control refusals, recorded by the server's shed path
        self.sheds = 0
        # learning-plane counters: consolidated experience steps
        # drained, hot-swaps applied, and the clock time of the last
        # swap (None until one lands)
        self.samples = 0
        self.swaps = 0
        self.last_swap_t: float | None = None

    def _check_nets(self, nets):
        """The env's burst kernel's limits on these nets
        (`env.check_burst_nets`), checked before any weight moves to the
        card."""
        if self.on_card:
            self.env.check_burst_nets(nets)

    def _as_params(self, net_params) -> torch.Tensor:
        t = torch.as_tensor(net_params).detach()
        return t.to(self.device, torch.float32).contiguous()

    # -- lifecycle --------------------------------------------------------

    def start(self):
        """Materialize the lane carry and run both device entry points
        once with no lanes live (on the card: the kernels' build and
        load land before the first client)."""
        seeds = np.arange(self.n_lanes, dtype=np.uint32)
        keys = _lane_keys(seeds, self.device)
        # two carries: the carry is updated in place on every tick while
        # the template stays the fresh_states argument of non-admitting
        # ticks
        self._fresh0 = self.env.init_lanes(keys, self.params)
        self._carry = self.env.init_lanes(keys, self.params)
        zero_a = torch.zeros(self.n_lanes, dtype=torch.int32,
                             device=self.device)
        zero_m = torch.zeros(self.n_lanes, dtype=torch.bool,
                             device=self.device)
        self._zero_a, self._zero_m = zero_a, zero_m
        if self.on_card:
            n, i32 = self.n_lanes, torch.int32
            self._stage_burst = _Staging(
                dict(keys=(i32, (n, 2)), policy=(i32, (n,)),
                     live=(torch.bool, (n,)), admit=(torch.bool, (n,))),
                self.device)
            self._stage_regs = _Staging(
                dict(done_step=(i32, (n,)), caps=(torch.float32, (4, n)),
                     done=(torch.bool, (n,))), self.device)
        self.env.step_lanes(self._carry, zero_a, zero_m, self._fresh0,
                            zero_m, self.params)
        if self.experience:
            from cpr_tpu_torch.learn import buffer
            # sampler key plane: each lane's stream is the fold_in
            # sibling of its admission key; splice() re-derives it from
            # each admitted session's seed
            self._exp = buffer.init_buffer(
                buffer.experience_stream(keys), self.experience,
                self.env.observation_length)
        if self.on_card:
            self._burst_staged(np.zeros(0, np.int64), np.zeros(0, np.int32),
                               set())
        if self._with_metrics:
            # after the warm-up burst, which must not count
            self._macc = self._spec.init(self.device)

    # -- the three device entry points ------------------------------------

    def splice(self, lane_seeds: dict[int, int]) -> dict[int, np.ndarray]:
        """Admit sessions: splice a fresh `init_lanes` state over each
        given lane without stepping anything. Returns each admitted
        lane's first observation."""
        if not lane_seeds:
            return {}
        t0 = telemetry.now()
        seeds = np.zeros(self.n_lanes, np.uint32)
        admit = np.zeros(self.n_lanes, bool)
        for lane, seed in lane_seeds.items():
            seeds[lane] = seed
            admit[lane] = True
        fresh = self.env.init_lanes(_lane_keys(seeds, self.device),
                                    self.params)
        _, (obs, _, _, _) = self.env.step_lanes(
            self._carry, self._zero_a,
            torch.from_numpy(admit).to(self.device), fresh, self._zero_m,
            self.params)
        self._rekey(lane_seeds)
        obs = obs.cpu().numpy()
        self.admitted += len(lane_seeds)
        self.busy_s += telemetry.now() - t0
        return {lane: obs[lane] for lane in lane_seeds}

    def _rekey(self, lane_seeds: dict[int, int]):
        """With the rings: re-key the admitted lanes' sampler streams from
        their session seeds and restart their write windows (a stale
        partial window must never be consolidated); the monotone counter
        `t` keeps running."""
        if self._exp is None:
            return
        from cpr_tpu_torch.learn import buffer
        lanes = sorted(lane_seeds)
        idx = torch.tensor(lanes, dtype=torch.int64, device=self.device)
        nk = buffer.experience_stream(_lane_keys(
            np.asarray([lane_seeds[lane] for lane in lanes], np.uint32),
            self.device))
        self._exp["key"][idx] = nk
        self._exp["cursor"][idx] = 0

    def tick(self, lane_actions: dict[int, int]) -> dict[int, dict]:
        """Advance exactly the given lanes by one step with the given
        client actions; every other lane holds bit-exactly. Returns
        per-lane {obs, reward, done, info}."""
        if not lane_actions:
            return {}
        t0 = telemetry.now()
        actions = np.zeros(self.n_lanes, np.int32)
        step = np.zeros(self.n_lanes, bool)
        for lane, a in lane_actions.items():
            actions[lane] = a
            step[lane] = True
        no_admit = torch.zeros(self.n_lanes, dtype=torch.bool,
                               device=self.device)
        _, (obs, reward, done, info) = self.env.step_lanes(
            self._carry, torch.from_numpy(actions).to(self.device),
            no_admit, self._fresh0, torch.from_numpy(step).to(self.device),
            self.params)
        obs, reward, done = (obs.cpu().numpy(), reward.cpu().numpy(),
                             done.cpu().numpy())
        info = {k: v.cpu().numpy() for k, v in info.items()}
        self.ticks += 1
        self.steps += len(lane_actions)
        self.busy_s += telemetry.now() - t0
        return {
            lane: dict(obs=obs[lane], reward=float(reward[lane]),
                       done=bool(done[lane]),
                       info={k: float(v[lane]) for k, v in info.items()})
            for lane in lane_actions
        }

    def burst_run(self, lane_policy: dict[int, int],
                  occupancy: float | None = None,
                  admit: dict[int, int] | None = None) -> dict | None:
        """Advance every policy-driven lane by `burst` steps in one
        launch (actions from the policy table); non-listed lanes hold
        bit-exactly. Returns the per-lane BURST_FIELDS first-done
        registers as (n_lanes,) numpy arrays, or None when no lane is
        policy-driven. `occupancy` is the scheduler's assigned-lane
        fraction (defaults to the live fraction). `admit` ({lane: seed})
        admits those sessions first, as `splice` does: on the card inside
        the burst's own launch (K14's or K14-dag's admission), on the
        CPU by `splice`."""
        if not lane_policy:
            if admit:
                self.splice(admit)
            return None
        if admit and not self.on_card:
            self.splice(admit)
        t0 = telemetry.now()
        n = len(lane_policy)
        lanes = np.fromiter(lane_policy.keys(), np.int64, n)
        pids = np.fromiter(lane_policy.values(), np.int32, n)
        used = np.unique(pids)
        if used[0] < 0 or used[-1] >= len(self._entries):
            raise ValueError(f"policy ids {used.tolist()} outside "
                             f"0..{len(self._entries) - 1}")
        used = set(used.tolist())
        occ = (n / self.n_lanes if occupancy is None else float(occupancy))
        if self.on_card:
            if admit:
                self._rekey(admit)
                self.admitted += len(admit)
            host = self._burst_staged(lanes, pids, used, admit)
            live_t = self._stage_burst.views["live"]
            got_t = self._stage_regs.views["done"]
        else:
            pol = np.zeros(self.n_lanes, np.int32)
            live = np.zeros(self.n_lanes, bool)
            pol[lanes] = pids
            live[lanes] = True
            live_t = torch.from_numpy(live)
            regs = self._burst_plain(self._carry, self._exp,
                                     torch.from_numpy(pol), live_t)
            host = {k: v.numpy() for k, v in regs.items()}
            got_t = regs["done"]
        if self._macc is not None:
            self._fold_burst(live_t, got_t, occ)
        dur = telemetry.now() - t0
        self.bursts += 1
        self.steps += len(lane_policy) * self.burst
        self.episodes += int(host["done"].sum())
        self.busy_s += dur
        self._occ_sum += occ
        self._burst_wall.append(dur)
        return host

    def _fold_burst(self, live, got, occ: float):
        """The per-burst cells (the reference's engine.py:311-320) from
        the burst's own inputs and registers on its device: env_steps =
        live lanes x burst, episodes = lanes whose first episode ended
        (`got`), one burst, the occupancy. One K17 launch on the card,
        reading the staging buffers before the next burst's copy."""
        dm = device_metrics
        self._spec.fold(self._macc, [
            dm.count_op("env_steps", live, self.burst),
            dm.count_op("episodes", got),
            dm.count_op("bursts", 1),
            dm.observe_op("occupancy", occ)])

    # -- the burst: K14/K14-dag on the card, the plain twin on the CPU ------

    def _burst_staged(self, lanes, pids, used: set,
                      admit: dict | None = None) -> dict:
        """K14 (K14-dag) on the card with the dispatch's host traffic in
        one copy each way, inside the launch's own call: the policy ids,
        the live mask and the admissions ({lane: seed}, or None) in, the
        registers out, through the pinned staging buffers. Returns the
        BURST_FIELDS registers as numpy arrays."""
        sb, sr = self._stage_burst, self._stage_regs
        h = sb.host
        sb.raw.fill(0)  # policy 0, nothing live, nothing admitted
        h["policy"][lanes] = pids
        h["live"][lanes] = True
        if admit:
            # PRNGKey(seed): the words (0, seed)
            idx = np.fromiter(admit.keys(), np.int64, len(admit))
            h["keys"].view(np.uint32)[idx, 1] = np.fromiter(
                admit.values(), np.uint32, len(admit))
            h["admit"][idx] = True
        slots = {self._entries[i][1] for i in used
                 if self._entries[i][0] != _SCRIPTED}
        # one launcher a set of net slots (their weights' tensors: a swap
        # makes new ones), carry and rings (a caller may swap `_carry` or
        # `_exp` for copies); every other pointer is the engine's own
        key = tuple(s[1] for j, s in enumerate(self._slots) if j in slots)
        made = self._launch_key
        if (made is None or made[1] is not self._carry
                or made[2] is not self._exp or len(made[0]) != len(key)
                or any(a is not b for a, b in zip(made[0], key))):
            state, obs = self._carry
            nets = [tuple(s) if j in slots else None
                    for j, s in enumerate(self._slots)]
            out = sr.views
            (h_in, d_in, n_in), (h_out, d_out, n_out) = sb.ptrs, sr.ptrs
            self._launch = self.env._kernel_burst_launcher(
                state, obs, self.params, sb.views["policy"],
                sb.views["live"],
                [(k, 0 if a is None else a) for k, a, _ in self._entries],
                nets, self.burst, self._exp,
                (out["done"], out["done_step"], out["caps"]),
                (sb.views["admit"], sb.views["keys"]),
                (h_in, d_in, n_in, d_out, h_out, n_out))
            self._launch_key = (key, self._carry, self._exp)
        # the inputs in, the burst, the registers out, in one call
        self._launch()
        caps = sr.host["caps"].copy()
        return dict(done=sr.host["done"].copy(),
                    done_step=sr.host["done_step"].copy(),
                    **dict(zip(CAPTURE_FIELDS, caps)))

    def _actions_plain(self, state, obs, policy, live, exp):
        """Each lane's action for this step from its table entry."""
        actions = torch.zeros(obs.shape[0], dtype=torch.int32,
                              device=obs.device)
        keys = None
        for i, (kind, arg, fn) in enumerate(self._entries):
            sel = (policy == i) & live
            if not bool(sel.any()):
                continue
            if kind == _SCRIPTED:
                act = self.env._policy_fn(fn)(state, obs)
            else:
                net, flat = self._slots[arg]
                with torch.no_grad():
                    logits = net(obs, flat)[0]
                if kind == _GREEDY:
                    act = torch.argmax(logits, dim=-1)
                else:
                    from cpr_tpu_torch.learn import buffer
                    if keys is None:
                        keys = buffer.step_keys_plain(exp["key"], exp["t"])
                    A = logits.shape[-1]
                    x0, x1 = random.threefry_words(
                        keys[:, None, :],
                        torch.arange(A, device=obs.device)[None, :])
                    g = random.gumbel_of_bits(random.from_words(x0 ^ x1))
                    act = torch.argmax(g + logits, dim=-1)
            actions = torch.where(sel, act.to(torch.int32), actions)
        return actions

    def _burst_plain(self, carry, exp, policy, live) -> dict:
        """Plain twin of K14 and K14-dag, generic over the env's
        `_lane_step`: the reference's scan body (engine.py:241-302) a step
        at a time, the carry and the rings `exp` (or None) updated in
        place. Returns the BURST_FIELDS registers as tensors. Used by the
        tests and, on the card, only to hold the kernel."""
        from cpr_tpu_torch.learn import buffer
        state, obs = carry
        n, dev = obs.shape[0], obs.device
        got = torch.zeros(n, dtype=torch.bool, device=dev)
        idx = torch.zeros(n, dtype=torch.int32, device=dev)
        caps = {k: torch.zeros(n, dtype=torch.float32, device=dev)
                for k in CAPTURE_FIELDS}
        s, o = state, obs
        for i in range(self.burst):
            actions = self._actions_plain(s, o, policy, live, exp)
            new_state, obs_next, _, reward, done, info = \
                self.env._lane_step(s, actions, self.params)
            done = done & live
            if exp is not None:
                # the pre-step obs and the action taken from it
                buffer.record_plain(
                    exp, live, o, actions, reward, done,
                    info["episode_reward_attacker"],
                    info["episode_reward_defender"], policy)
            s = map_state(lambda a, b: _lane_where(live, a, b),
                          new_state, s)
            o = _lane_where(live, obs_next, o)
            newly = done & ~got
            idx = torch.where(newly, torch.full_like(idx, i), idx)
            caps = {k: torch.where(newly, info[k].to(torch.float32), v)
                    for k, v in caps.items()}
            got = got | done
        copy_state_(state, s)
        obs.copy_(o)
        return dict(done=got, done_step=idx, **caps)

    # -- the learning plane -----------------------------------------------

    @property
    def swap_names(self) -> tuple:
        """Names of the hot-swappable net policies, sorted."""
        return tuple(sorted(self._swap_net))

    def policy_fingerprint(self, name: str | None = None):
        """The snapshot fingerprint currently serving `name` (default:
        the first swappable policy), or None without swap policies."""
        if not self._swap_net:
            return None
        if name is None:
            name = self.swap_names[0]
        return self._swap_fingerprint.get(name)

    def swap_policy(self, name: str, net_params, *,
                    fingerprint=None) -> dict:
        """Hot-swap a registered net policy's weights: the next burst
        serves `net_params` (a flat parameter vector, or an
        `ActorCritic`, whose widths must then match too), in-flight lanes
        are untouched. An identical fingerprint is a no-op
        (swapped=False). Weights of another length or widths are refused
        with the typed IntegrityError (reason="version"): the serving
        kernel's slot has a fixed shape."""
        if name not in self._swap_net:
            raise ValueError(
                f"unknown swappable policy {name!r}; registered: "
                f"{sorted(self._swap_net)}")
        if fingerprint is not None and \
                fingerprint == self._swap_fingerprint.get(name):
            return dict(swapped=False, reason="identical",
                        fingerprint=fingerprint)
        net = self._swap_net[name]
        slot = self._slots[self._slot_of[name]]
        widths = (net.obs_dim, net.n_actions, net.hidden)
        if hasattr(net_params, "flat"):  # an ActorCritic
            same = (net_params.obs_dim, net_params.n_actions,
                    net_params.hidden) == widths
            net_params = net_params.flat
        else:
            same = True
        new = torch.as_tensor(net_params).detach()
        if (not same or new.dtype != torch.float32
                or tuple(new.shape) != tuple(slot[1].shape)):
            from cpr_tpu_torch.integrity import (IntegrityError,
                                                 integrity_event)
            artifact = str(fingerprint or name)
            integrity_event(artifact=artifact, kind="policy_snapshot",
                            reason="version", action="refused",
                            detail="parameter tree does not match the "
                                   "serving program")
            raise IntegrityError(
                f"swap refused for {name!r}: snapshot parameter tree "
                f"does not match the serving program",
                artifact=artifact, kind="policy_snapshot",
                reason="version")
        slot[1] = self._as_params(new)
        self._swap_fingerprint[name] = fingerprint
        self.swaps += 1
        self.last_swap_t = telemetry.now()
        return dict(swapped=True, fingerprint=fingerprint)

    def drain_experience(self) -> dict | None:
        """Consolidate the experience rings into a feed batch, one copy
        to the host at a burst boundary. Write cursors reset; key
        streams and the monotone step counters continue. Returns None
        when the plane is off or no lane filled a window."""
        if self._exp is None:
            return None
        from cpr_tpu_torch.learn import buffer
        # copies: on the CPU `.cpu()` would alias the rings reset below
        host = {k: v.to("cpu", copy=True).numpy()
                for k, v in self._exp.items() if k != "key"}
        last_obs = self._carry[1].to("cpu", copy=True).numpy()
        self._exp["cursor"].zero_()
        batch = buffer.consolidate(host, last_obs)
        if not batch["steps"]:
            return None
        self.samples += batch["steps"]
        from cpr_tpu_torch.learn import learn_event
        learn_event("sample", steps=batch["steps"], batches=1,
                    fingerprint=self.policy_fingerprint(),
                    staleness_s=None, lanes=int(len(batch["lanes"])),
                    partial=batch["partial"])
        return batch

    # -- reporting --------------------------------------------------------

    def report(self) -> dict:
        """Host-side throughput summary, the payload of the `serve`
        report event. Rates are over busy (launch) wall time."""
        return dict(
            steps=self.steps, episodes=self.episodes, bursts=self.bursts,
            ticks=self.ticks, admitted=self.admitted,
            busy_s=self.busy_s,
            steps_per_sec=(self.steps / self.busy_s
                           if self.busy_s > 0 else 0.0),
            occupancy=(self._occ_sum / self.bursts
                       if self.bursts else 0.0),
            burst=self.burst, n_lanes=self.n_lanes,
            n_devices=self.n_devices,
            policies=list(self.policy_names),
            samples=self.samples, swaps=self.swaps)

    def record_shed(self):
        """Count one admission-control refusal (the server's shed
        path)."""
        self.sheds += 1

    def emit_metrics(self, scope: str = "serve"):
        """Fold the host-recorded burst walls (the `burst_s` spread and
        the `burst_s_hist` log buckets) and the shed counter into a copy
        of the accumulator and emit the `device_metrics` event (one
        readback). Returns its summary; None when metrics are off."""
        if self._macc is None:
            return None
        dm = device_metrics
        ops = []
        if self._burst_wall:
            walls = torch.tensor(self._burst_wall, dtype=torch.float32,
                                 device=self.device)
            ops += [dm.observe_op("burst_s", walls),
                    dm.hist_op("burst_s_hist", walls)]
        if self.sheds:
            ops.append(dm.count_op("shed_sessions", self.sheds))
        macc = self._spec.fold(self._macc.clone(), ops)
        return dm.emit(scope, self._spec, macc)
