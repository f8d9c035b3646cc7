"""Nakamoto consensus under the SSZ'16 selfish-mining attack space (port
of cpr_tpu/envs/nakamoto.py).

Reference counterparts:
- protocol: simulator/protocols/nakamoto.ml (longest chain, reward 1/block)
- attack space: simulator/protocols/nakamoto_ssz.ml (Observation
  {public_blocks, private_blocks, diff_blocks, event}, Actions
  Adopt|Override|Match|Wait, built-in policies honest/simple/
  eyal-sirer-2014/sapirshtein-2016-sm1)
- gym engine semantics: simulator/gym/engine.ml:97-273.

One env step is one action plus one Bernoulli(alpha) mining draw (plus a
Bernoulli(gamma) communication draw when a match race is live). The
state is a handful of scalars per lane, held here as one tensor per
field with a leading lane axis. The plain functions below are the
arithmetic of kernels K2 and K3 (`csrc/nakamoto_stream.cu`), which run
them with the lane state in registers; the deviations from the
reference's event-queue semantics are those of the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from cpr_tpu_torch import obs as obslib
from cpr_tpu_torch import random
from cpr_tpu_torch.envs.base import TorchEnv

# action encoding mirrors Variants.to_rank order (nakamoto_ssz.ml:116-154)
ADOPT, OVERRIDE, MATCH, WAIT = 0, 1, 2, 3

# event encoding mirrors Discrete [`ProofOfWork; `Network] (nakamoto_ssz.ml:38)
EV_POW, EV_NETWORK = 0, 1

OBS_FIELDS = (
    obslib.Field("public_blocks", obslib.UINT, scale=1),
    obslib.Field("private_blocks", obslib.UINT, scale=1),
    obslib.Field("diff_blocks", obslib.INT, scale=1),
    obslib.Field("event", obslib.DISCRETE, n=2),
)

# kernel policy ids (csrc/nakamoto_stream.cu `policy`)
POLICY_NAMES = ("honest", "simple", "eyal-sirer-2014",
                "sapirshtein-2016-sm1")


@dataclasses.dataclass
class State:
    """Per-lane env state; every field has a leading lane axis."""

    # fork state relative to the common ancestor
    a: torch.Tensor  # int32, private (attacker) blocks after common ancestor
    h: torch.Tensor  # int32, public (defender) blocks after common ancestor
    event: torch.Tensor  # int32, EV_POW | EV_NETWORK
    match_h: torch.Tensor  # int32, height of live match race (-1: none)
    # common-chain accumulators (precursor-accumulation, simulator.ml:377-388)
    ca_atk: torch.Tensor  # float32
    ca_def: torch.Tensor
    ca_progress: torch.Tensor
    # clocks, float32
    time: torch.Tensor
    t_priv: torch.Tensor  # mining time of private tip
    t_pub: torch.Tensor  # mining time of public tip
    # episode bookkeeping (engine.ml:69-79)
    steps: torch.Tensor  # int32
    n_activations: torch.Tensor  # int32
    last_reward_attacker: torch.Tensor  # float32
    last_reward_defender: torch.Tensor
    last_progress: torch.Tensor
    last_chain_time: torch.Tensor
    last_sim_time: torch.Tensor
    key: torch.Tensor  # int32 [L, 2], threefry key words

    def replace(self, **kwargs) -> "State":
        return dataclasses.replace(self, **kwargs)


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(State))
INT_FIELDS = ("a", "h", "event", "match_h", "steps", "n_activations")


def _where(c, a, b):
    return torch.where(c, a, b)


class NakamotoSSZ(TorchEnv):
    """cpr-nakamoto SSZ attack env, one step per attacker interaction."""

    n_actions = 4
    obs_fields = OBS_FIELDS
    observation_length = len(OBS_FIELDS)
    scripted_policies = POLICY_NAMES

    def __init__(self, unit_observation: bool = True, strict_match: bool = True):
        # strict_match=True reproduces the reference event-queue network:
        # a Match only splits the defenders when applied at the interaction
        # where the competing defender block just arrived (network.ml:61-105).
        # strict_match=False reproduces the SSZ'16 MDP convention
        # (gym/rust/src/fc16.rs:104-115) where a match race stays live
        # across Wait actions.
        self.unit_observation = unit_observation
        self.strict_match = strict_match
        self.fields = OBS_FIELDS
        self.low, self.high = obslib.low_high(OBS_FIELDS, unit_observation)
        self.policies = self._make_policies()

    # -- observation ------------------------------------------------------

    def observe(self, state: State):
        """nakamoto_ssz.ml:220-230."""
        return obslib.encode(
            OBS_FIELDS,
            (state.h, state.a, state.a - state.h, state.event),
            self.unit_observation,
        )

    # -- dynamics ---------------------------------------------------------

    def _mine(self, state: State, params) -> State:
        """One activation: Bernoulli(alpha) miner choice plus the gamma
        communication race (engine.ml:108-121 fast-forward collapsed to one
        draw; simulator.ml:465-472 PoW clock). The four-way key split is
        one threefry batch and the three draws another."""
        ks = random.threefry_plain(state.key, 4)  # [L, 4, 2]
        b = random.threefry_plain(ks[:, 1:], 1, 0, random.MODE_BITS)[..., 0]
        dt = random.exponential_of_bits(b[:, 0]) * params.activation_delay
        time = state.time + dt
        attacker_mines = random.uniform_of_bits(b[:, 1]) < params.alpha
        gamma_hit = random.uniform_of_bits(b[:, 2]) < params.gamma

        a_att = state.a + 1
        on_split = (state.match_h >= 0) & (state.match_h == state.h)
        def_on_attacker = on_split & gamma_hit
        zero = torch.zeros_like(state.h)
        jump = _where(def_on_attacker, state.h, zero).to(torch.float32)
        ca_atk_d = state.ca_atk + jump
        ca_prog_d = state.ca_progress + jump
        a_def = _where(def_on_attacker, state.a - state.h, state.a)
        h_def = _where(def_on_attacker, torch.ones_like(state.h), state.h + 1)

        return state.replace(
            a=_where(attacker_mines, a_att, a_def),
            h=_where(attacker_mines, state.h, h_def),
            ca_atk=_where(attacker_mines, state.ca_atk, ca_atk_d),
            ca_progress=_where(attacker_mines, state.ca_progress, ca_prog_d),
            match_h=_where(attacker_mines, state.match_h,
                           torch.full_like(state.match_h, -1)),
            event=_where(attacker_mines, torch.full_like(state.event, EV_POW),
                         torch.full_like(state.event, EV_NETWORK)),
            time=time,
            t_priv=_where(attacker_mines, time, state.t_priv),
            t_pub=_where(attacker_mines, state.t_pub, time),
            n_activations=state.n_activations + 1,
            key=ks[:, 0],
        )

    def _zero_state(self, keys) -> State:
        n, dev = keys.shape[0], keys.device

        def full(v, dtype):  # one tensor per field: carries are updated in place
            return torch.full((n,), v, dtype=dtype, device=dev)

        return State(**{
            f: keys.clone() if f == "key" else full(
                {"event": EV_POW, "match_h": -1}.get(f, 0),
                torch.int32 if f in INT_FIELDS else torch.float32)
            for f in STATE_FIELDS})

    def reset(self, keys, params):
        """Fresh state per key [L, 2], fast-forwarded to the first attacker
        interaction as the reference does at env construction
        (engine.ml:137-141): one mining draw."""
        state = self._mine(self._zero_state(keys), params)
        return state, self.observe(state)

    def _apply(self, state: State, action) -> State:
        """Apply the agent action (nakamoto_ssz.ml:232-259)."""
        a, h = state.a, state.h
        zero = torch.zeros_like(h)
        f32 = torch.float32

        adopt = action == ADOPT
        # Override: release block at height h+1; effective iff a > h
        override_eff = (action == OVERRIDE) & (a > h)
        # Match: release block at height h; a live race iff the attacker
        # has a block at that height and (strict mode) the competing
        # defender block just arrived
        match_eff = (action == MATCH) & (a >= h) & (h > 0)
        if self.strict_match:
            match_eff = match_eff & (state.event == EV_NETWORK)

        ca_atk = state.ca_atk + _where(override_eff, h + 1, zero).to(f32)
        ca_def = state.ca_def + _where(adopt, h, zero).to(f32)
        ca_progress = (
            state.ca_progress
            + _where(adopt, h, zero).to(f32)
            + _where(override_eff, h + 1, zero).to(f32)
        )
        new_a = _where(adopt, zero, _where(override_eff, a - (h + 1), a))
        new_h = _where(adopt | override_eff, zero, h)
        match_h = _where(match_eff, h,
                         _where(adopt | override_eff,
                                torch.full_like(h, -1), state.match_h))
        t_priv = _where(adopt, state.t_pub, state.t_priv)
        # after an effective override the public tip is the released
        # attacker block (approximated by the private tip's mining time)
        t_pub = _where(override_eff, state.t_priv, state.t_pub)
        return state.replace(
            a=new_a, h=new_h, ca_atk=ca_atk, ca_def=ca_def,
            ca_progress=ca_progress, match_h=match_h,
            t_priv=t_priv, t_pub=t_pub,
        )

    def step(self, state: State, action, params):
        """engine.ml:176-249: apply action, fast-forward to the next
        attacker interaction, compute winner head, rewards, termination."""
        state = self._apply(state, action)
        state = self._mine(state, params)
        state = state.replace(steps=state.steps + 1)

        # winner over node preferences; ties go to the attacker because it
        # is node 0 in the fold (engine.ml:196-206, nakamoto.ml:43-48)
        head_private = state.a >= state.h
        zero = torch.zeros_like(state.a)
        f32 = torch.float32
        reward_attacker = state.ca_atk + _where(head_private, state.a,
                                                zero).to(f32)
        reward_defender = state.ca_def + _where(head_private, zero,
                                                state.h).to(f32)
        progress = state.ca_progress + torch.maximum(state.a,
                                                     state.h).to(f32)
        chain_time = _where(head_private, state.t_priv, state.t_pub)

        return self.finish_step(
            state, params,
            reward_attacker=reward_attacker,
            reward_defender=reward_defender,
            progress=progress,
            chain_time=chain_time,
        )

    # -- built-in policies (nakamoto_ssz.ml:274-350) ----------------------

    @staticmethod
    def _policy_ints(policy_id: int, a, h):
        c = lambda v: torch.full_like(a, v)  # noqa: E731
        if policy_id == 0:  # honest
            return _where(a > h, c(OVERRIDE), _where(a < h, c(ADOPT), c(WAIT)))
        if policy_id == 1:  # simple
            return _where(h > 0, _where(a < h, c(ADOPT), c(OVERRIDE)),
                          c(WAIT))
        if policy_id == 2:  # Eyal & Sirer 2014 (nakamoto_ssz.ml:294-321)
            return _where(
                a < h, c(ADOPT),
                _where((h == 0) & (a == 1), c(WAIT),
                       _where((h == 1) & (a == 1), c(MATCH),
                              _where((h == 1) & (a == 2), c(OVERRIDE),
                                     _where(h > 0,
                                            _where(a - h == 1, c(OVERRIDE),
                                                   c(MATCH)),
                                            c(WAIT))))))
        if policy_id == 3:  # Sapirshtein et al. 2016, SM1 (nakamoto_ssz.ml:325-339)
            return _where(
                h > a, c(ADOPT),
                _where((h == 1) & (a == 1), c(MATCH),
                       _where((h == a - 1) & (h >= 1), c(OVERRIDE),
                              c(WAIT))))
        raise ValueError(f"unknown policy id {policy_id}")

    def policy_from_ints(self, policy_id: int, state):
        return self._policy_ints(policy_id, state.a, state.h)

    def _make_policies(self):
        def make(pid, name):
            def policy(obs):
                h, a, _, _event = self.decode_obs(obs)
                return self._policy_ints(pid, a, h)
            policy.policy_name = name
            policy.policy_owner = NakamotoSSZ
            return policy

        return {name: make(i, name) for i, name in enumerate(POLICY_NAMES)}

    # -- kernel hooks (K2, K3, K14) ---------------------------------------

    burst_kernel = True

    def _empty_carry(self, n: int, device):
        i32 = dict(dtype=torch.int32, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        state = State(**{
            f: torch.empty((n, 2) if f == "key" else (n,),
                           **(i32 if f in INT_FIELDS or f == "key" else f32))
            for f in STATE_FIELDS})
        return state, torch.empty((n, 4), **f32)

    def _kernel_stream(self, carry, keys, init_mode, length, params,
                       policy_id, with_sums, store_traj, net=None,
                       extend_obs=False):
        from cpr_tpu_torch import kernels
        state, obs = carry
        return kernels.stream(state, obs, keys, init_mode, length, params,
                              policy_id, self.strict_match,
                              self.unit_observation, with_sums=with_sums,
                              store_traj=store_traj, net=net,
                              extend_obs=extend_obs)

    def _kernel_step_lanes(self, carry, actions, admit_mask, fresh_states,
                           step_mask, params, extend_obs=False):
        from cpr_tpu_torch import kernels
        from cpr_tpu_torch.envs.base import INFO_KEYS
        state, obs = carry
        fstate, fobs = fresh_states
        out_obs, reward, done, info = kernels.step_lanes(
            state, obs, actions, admit_mask, fstate, fobs, step_mask, params,
            self.strict_match, self.unit_observation, extend_obs=extend_obs)
        return out_obs, reward, done, {k: info[i]
                                       for i, k in enumerate(INFO_KEYS)}

    def _kernel_burst_launcher(self, state, obs, params, policy, live, table,
                               nets, length, exp, out, admit, staging):
        from cpr_tpu_torch import kernels
        return kernels.burst_launcher(
            state, obs, params, self.strict_match, self.unit_observation,
            policy, live, table, nets, length, exp, out, admit, staging)
