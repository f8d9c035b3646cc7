"""Spar — simple parallel PoW — under the SSZ-like withholding attack
space, on the DAG substrate (port of cpr_tpu/envs/spar.py).

Reference counterparts:
- protocol: simulator/protocols/spar.ml — every puzzle solution is a vote
  (one parent block, same height) or a block (parent block + k-1 votes on
  it, height + 1) (100-117); the miner drafts a block as soon as k-1 votes
  confirm its preferred block, otherwise a vote (203-222); preference by
  (height, confirming votes, own first, earliest seen) (185-196); the
  `Constant` and `Block` rewards (140-156),
- attack space: simulator/protocols/spar_ssz.ml — the 7-field observation
  (22-46), Action8 with a persistent Proceed/Prolong mining filter
  (186-189, 305-308), release targeting by (height, votes) of the public
  head with the proposal fast path (261-298), policies honest/selfish
  (332-351),
- engine semantics: simulator/gym/engine.ml:97-273.

One step is one attacker action and one mining draw whose payload is
decided at mining time from masked vote counts; votes store their block
in `signer`. Plain twin of kernel K10-spar (`csrc/spar_stream.cu`).
"""

from __future__ import annotations

import dataclasses

import torch

from cpr_tpu_torch import obs as obslib
from cpr_tpu_torch import random
from cpr_tpu_torch.core import dag as D
from cpr_tpu_torch.envs.base import DagEnv

I32, F32 = torch.int32, torch.float32

BLOCK, VOTE = 0, 1

# events: Discrete [`ProofOfWork; `Network] (spar_ssz.ml:45)
EV_POW, EV_NETWORK = 0, 1

# Action8 ranks (ssz_tools.ml:230-263)
(ADOPT_PROLONG, OVERRIDE_PROLONG, MATCH_PROLONG, WAIT_PROLONG,
 ADOPT_PROCEED, OVERRIDE_PROCEED, MATCH_PROCEED, WAIT_PROCEED) = range(8)

INCENTIVE_SCHEMES = ("constant", "block")
# kernel policy ids (csrc/spar_stream.cu `policy`)
POLICY_NAMES = ("honest", "selfish")


def obs_fields(k: int):
    """spar_ssz.ml:36-46."""
    return (
        obslib.Field("public_blocks", obslib.UINT, scale=1),
        obslib.Field("private_blocks", obslib.UINT, scale=1),
        obslib.Field("diff_blocks", obslib.INT, scale=1),
        obslib.Field("public_votes", obslib.UINT, scale=k - 1),
        obslib.Field("private_votes_inclusive", obslib.UINT, scale=k - 1),
        obslib.Field("private_votes_exclusive", obslib.UINT, scale=k - 1),
        obslib.Field("event", obslib.DISCRETE, n=2),
    )


@dataclasses.dataclass
class State:
    """Per-lane env state; every field has a leading lane axis."""

    dag: D.Dag
    public: torch.Tensor  # int32, defender-preferred block
    private: torch.Tensor  # int32, attacker-preferred block
    event: torch.Tensor  # int32, EV_*
    race_tip: torch.Tensor  # int32, live match race target block
    mining_excl: torch.Tensor  # bool, Prolong: exclusive vote filter
    time: torch.Tensor
    steps: torch.Tensor
    n_activations: torch.Tensor
    last_reward_attacker: torch.Tensor
    last_reward_defender: torch.Tensor
    last_progress: torch.Tensor
    last_chain_time: torch.Tensor
    last_sim_time: torch.Tensor
    key: torch.Tensor  # int32 [L, 2]

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


INT_FIELDS = ("public", "private", "event", "race_tip", "steps",
              "n_activations")
BOOL_FIELDS = ("mining_excl",)


def _c(ref, v, dtype=I32):
    return torch.full_like(ref, v, dtype=dtype)


def _at(plane, idx):
    return D.at(plane, idx.clamp(min=0))


class SparSSZ(DagEnv):
    n_actions = 8
    scripted_policies = POLICY_NAMES
    state_cls = State
    int_fields = INT_FIELDS
    bool_fields = BOOL_FIELDS
    kernel_family, kernel_lib = "K10-spar", "spar"

    def __init__(self, k: int = 8, incentive_scheme: str = "constant",
                 unit_observation: bool = True, max_steps_hint: int = 256,
                 window: int | None = None,
                 anc_masks: bool | None = None):
        assert k >= 2
        assert incentive_scheme in INCENTIVE_SCHEMES
        self.k = k
        self.incentive_scheme = incentive_scheme
        self.unit_observation = unit_observation
        # one PoW append per step; floored at the k+8 release selection
        self.capacity = max(max_steps_hint + 8, k + 8)
        if window is not None:
            self.capacity = max(window, k + 8)
        self.ring = window is not None
        self.anc_masks = self.ring if anc_masks is None else anc_masks
        assert self.anc_masks or not self.ring, \
            "ring windows require anc_masks (walks could cross reclaimed slots)"
        self.lift = False
        self.max_parents = k
        self.fields = obs_fields(k)
        self.observation_length = len(self.fields)
        self.low, self.high = obslib.low_high(self.fields, unit_observation)
        self.policies = self._make_policies()

    # -- protocol primitives (spar.ml) -------------------------------------

    def confirming(self, dag, b, extra_mask=None):
        """[L, B] votes confirming block b (spar.ml:88-91); newer_than
        guards a reclaimed ring slot."""
        m = (dag.exists() & (dag.kind == VOTE) & (dag.signer == b[:, None])
             & D.newer_than(dag, b))
        if extra_mask is not None:
            m = m & extra_mask
        return m

    def common_ancestor(self, dag, a, b):
        if dag.has_masks:
            return D.common_ancestor_masked(dag, a, b)
        return D.common_ancestor_by_height(dag, a, b)

    def last_block(self, dag, x):
        """spar.ml:77-84."""
        return torch.where(_at(dag.kind, x) == BLOCK, x, _at(dag.signer, x))

    def cmp_blocks(self, dag, x, y, vote_filter_mask, me: int):
        """spar.ml:185-196: x strictly preferred over y by (height,
        filtered confirming votes, own-appended first, earliest seen)."""
        nx = self.confirming(dag, x, vote_filter_mask).sum(1)
        ny = self.confirming(dag, y, vote_filter_mask).sum(1)
        seen = dag.born_at if me == D.ATTACKER else dag.vis_d_since
        keys = ((_at(dag.height, x), _at(dag.height, y)), (nx, ny),
                (_at(dag.miner, x) == me, _at(dag.miner, y) == me),
                (-_at(seen, x), -_at(seen, y)))
        gt = torch.zeros_like(x, dtype=torch.bool)
        eq = torch.ones_like(gt)
        for a, b in keys:
            gt = gt | (eq & (a > b))
            eq = eq & (a == b)
        return gt & (x != y)

    def update_head(self, dag, old, cand, me: int):
        mask = dag.exists() if me == D.ATTACKER else dag.vis_d
        return torch.where(self.cmp_blocks(dag, cand, old, mask, me), cand,
                           old)

    def _mine_one(self, dag, head, view, vote_filter, miner, time, powh):
        """puzzle_payload' (spar.ml:203-227): a block on k-1 filtered
        votes, else a vote. Returns (dag, idx, is_block)."""
        k = self.k
        votes = self.confirming(dag, head, view) & vote_filter
        make_block = votes.sum(1) >= k - 1
        # vote choice: own first, then earliest seen (spar.ml:208-214)
        att = (miner == D.ATTACKER)[:, None]
        seen = torch.where(att, dag.born_at, dag.vis_d_since)
        horizon = dag.born_at.amax(1, keepdim=True) + 1.0
        score = torch.where(dag.miner == miner[:, None], seen, seen + horizon)
        vidx, take = D.top_k_by(score, votes, k - 1)
        row_block = torch.cat([head[:, None], torch.where(
            take, vidx, torch.full_like(vidx, D.NONE))], 1)
        row_vote = torch.full_like(row_block, D.NONE)
        row_vote[:, 0] = head
        row = torch.where(make_block[:, None], row_block, row_vote)
        height = _at(dag.height, head) + make_block.to(I32)
        # rewards at block append (spar.ml:140-156)
        if self.incentive_scheme == "constant":
            ids = torch.where(take, dag.miner.gather(1, vidx.long()),
                              torch.full_like(vidx, D.NONE))
            atk = ((ids == D.ATTACKER).sum(1) + (miner == D.ATTACKER)).to(F32)
            dfn = ((ids == D.DEFENDER).sum(1) + (miner == D.DEFENDER)).to(F32)
        else:  # block: k to the block miner
            atk = (miner == D.ATTACKER).to(F32) * float(k)
            dfn = (miner == D.DEFENDER).to(F32) * float(k)
        zero = torch.zeros_like(atk)
        kind = torch.where(make_block, _c(head, BLOCK), _c(head, VOTE))
        signer = torch.where(make_block, _c(head, D.NONE), head)
        progress = (height * k + (~make_block).to(I32)).to(F32)
        dag, idx = D.append(
            dag, row, kind=kind, height=height, pow_hash=powh,
            signer=signer, miner=miner, vis_a=True,
            vis_d=(miner == D.DEFENDER), time=time,
            reward_atk=torch.where(make_block, atk, zero),
            reward_def=torch.where(make_block, dfn, zero),
            progress=progress)
        return dag, idx, make_block

    # -- env API ------------------------------------------------------------

    def reset(self, keys, params):
        n, dev = keys.shape[0], keys.device
        dag = D.empty(n, self.capacity, self.max_parents, ring=self.ring,
                      anc_masks=self.anc_masks, device=dev)
        dag, root = D.append(
            dag, torch.full((n, self.max_parents), D.NONE, dtype=I32,
                            device=dev),
            kind=BLOCK, height=0, miner=D.NONE, vis_a=True, vis_d=True,
            time=0.0, progress=0.0)
        z = torch.zeros(n, dtype=I32, device=dev)
        f = torch.zeros(n, dtype=F32, device=dev)
        state = State(
            dag=dag, public=root, private=root.clone(), event=z + EV_POW,
            race_tip=z + D.NONE,
            mining_excl=torch.zeros(n, dtype=torch.bool, device=dev),
            time=f, steps=z.clone(), n_activations=z.clone(),
            last_reward_attacker=f.clone(), last_reward_defender=f.clone(),
            last_progress=f.clone(), last_chain_time=f.clone(),
            last_sim_time=f.clone(), key=keys.clone())
        state = self._mine(state, params)
        return state, self.observe(state)

    def _mine(self, state: State, params) -> State:
        """spar.py:236-280: one activation, the gamma race."""
        dag = state.dag
        ks = random.threefry_plain(state.key, 5)
        bits = random.threefry_plain(ks[:, 1:], 1, 0, random.MODE_BITS)[..., 0]
        dt = random.exponential_of_bits(bits[:, 0]) * params.activation_delay
        time = state.time + dt
        attacker = random.uniform_of_bits(bits[:, 1]) < params.alpha
        powh = random.uniform_of_bits(bits[:, 2])
        tgt = state.race_tip.clamp(min=0)
        still_tie = ((state.race_tip >= 0)
                     & (_at(dag.height, tgt) == _at(dag.height, state.public))
                     & (self.confirming(dag, tgt, dag.vis_d).sum(1)
                        == self.confirming(dag, state.public,
                                           dag.vis_d).sum(1)))
        gamma_hit = (~attacker & still_tie
                     & (random.uniform_of_bits(bits[:, 3]) < params.gamma))
        def_head = torch.where(gamma_hit, tgt, state.public)
        race_tip = torch.where(attacker, state.race_tip, _c(tgt, D.NONE))
        atk_filter = torch.where(state.mining_excl[:, None],
                                 dag.miner == D.ATTACKER, dag.exists())
        head = torch.where(attacker, state.private, def_head)
        view = torch.where(attacker[:, None], dag.vis_a, dag.vis_d)
        filt = torch.where(attacker[:, None], atk_filter, dag.exists())
        miner = torch.where(attacker, _c(tgt, D.ATTACKER),
                            _c(tgt, D.DEFENDER))
        dag, idx, is_blk = self._mine_one(dag, head, view, filt, miner, time,
                                          powh)
        private = torch.where(attacker & is_blk, idx, state.private)
        public = torch.where(
            attacker, state.public,
            torch.where(is_blk, self.update_head(dag, def_head, idx,
                                                 D.DEFENDER), def_head))
        return state.replace(
            dag=dag, private=private, public=public, race_tip=race_tip,
            event=torch.where(attacker, _c(tgt, EV_POW), _c(tgt, EV_NETWORK)),
            time=time, n_activations=state.n_activations + 1,
            key=ks[:, 0])

    def obs_ints(self, state: State):
        """spar_ssz.ml:226-253."""
        dag = state.dag
        ca = self.common_ancestor(dag, state.public, state.private) \
            .clamp(min=0)
        pub_v = self.confirming(dag, state.public, dag.vis_d).sum(1).to(I32)
        inc = self.confirming(dag, state.private)
        exc = inc & (dag.miner == D.ATTACKER)
        hp, hv, hc = (_at(dag.height, state.public),
                      _at(dag.height, state.private), _at(dag.height, ca))
        return (hp - hc, hv - hc, hv - hp, pub_v, inc.sum(1).to(I32),
                exc.sum(1).to(I32), state.event)

    def observe(self, state: State):
        return obslib.encode(self.fields, self.obs_ints(state),
                             self.unit_observation)

    def release_plan(self, state: State, action):
        """The release of spar_ssz.ml:261-298 (spar.py:313-349): the
        released block, the vote mask released beside its closure, and
        per lane whether the proposal fast path (`use_prop`) or the
        release-every-vote fallback (`not_enough`) decided it."""
        dag = state.dag
        k = self.k
        is_override = (action == OVERRIDE_PROLONG) | \
            (action == OVERRIDE_PROCEED)
        is_match = (action == MATCH_PROLONG) | (action == MATCH_PROCEED)
        h_pub = _at(dag.height, state.public)
        nv_pub = self.confirming(dag, state.public, dag.vis_d).sum(1).to(I32)
        tgt_h = torch.where(is_override & (nv_pub >= k), h_pub + 1, h_pub)
        tgt_v = torch.where(is_match, nv_pub,
                            torch.where(nv_pub >= k, torch.zeros_like(nv_pub),
                                        nv_pub + 1))
        # the private chain's block at the target height
        if dag.has_masks:
            blk = D.chain_first_at_most(dag, state.private, dag.height, tgt_h)
        else:
            blk = D.block_at_height(dag, state.private, tgt_h)
        blk = blk.clamp(min=0)
        # proposal fast path: the first block child of blk by age
        child_blocks = D.children0_mask(dag, blk) & (dag.kind == BLOCK)
        first_prop = D.first_by_age(dag, child_blocks).clamp(min=0)
        use_prop = (tgt_v >= k) & child_blocks.any(1)
        rel_block = torch.where(use_prop, first_prop, blk)
        rel_votes_n = torch.where(use_prop, torch.zeros_like(tgt_v), tgt_v)
        votes = self.confirming(dag, rel_block)
        width = k + 8
        vidx, vvalid = D.top_k_by(dag.born_at, votes, width)
        take = torch.arange(width, device=votes.device)[None, :] \
            < rel_votes_n[:, None]
        not_enough = (votes.sum(1) < rel_votes_n) | (rel_votes_n > width)
        vote_mask = D.mask_of(vidx, vvalid & take, self.capacity)
        vote_mask = torch.where(not_enough[:, None], votes, vote_mask)
        return rel_block, vote_mask, use_prop, not_enough

    def _apply(self, state: State, action) -> State:
        """spar_ssz.ml:255-317."""
        dag = state.dag
        is_adopt = (action == ADOPT_PROLONG) | (action == ADOPT_PROCEED)
        is_override = (action == OVERRIDE_PROLONG) | \
            (action == OVERRIDE_PROCEED)
        is_match = (action == MATCH_PROLONG) | (action == MATCH_PROCEED)
        is_release = is_override | is_match
        rel_block, vote_mask, _, _ = self.release_plan(state, action)
        # the chosen votes sit directly on the released block, so a flat
        # release covers them
        if dag.has_masks:
            released = D.release_masked(dag, rel_block, state.time)
        else:
            released = D.release_chain(dag, rel_block, state.time)
        released = D.release(released, vote_mask, state.time)
        dag = D.select_vis(is_release, released, dag)
        # deliver to the simulated defender; a tie arms the gamma race
        rb = self.last_block(dag, rel_block)
        public = torch.where(is_release, self.update_head(
            dag, state.public, rb, D.DEFENDER), state.public)
        tie = (is_release & (rb != public)
               & (_at(dag.height, rb) == _at(dag.height, public))
               & (self.confirming(dag, rb, dag.vis_d).sum(1)
                  == self.confirming(dag, public, dag.vis_d).sum(1)))
        race_tip = torch.where(tie, rb, torch.where(
            is_adopt | is_override, _c(rb, D.NONE), state.race_tip))
        private = torch.where(is_adopt, public, state.private)
        return state.replace(dag=dag, public=public, private=private,
                             race_tip=race_tip, mining_excl=action < 4)

    def step(self, state: State, action, params):
        state = self._apply(state, action.to(I32))
        state = self._mine(state, params)
        state = state.replace(steps=state.steps + 1)
        dag = state.dag
        if self.ring:
            # retire below the preference fork; drop a race tip that
            # retired with it
            ca = D.common_ancestor_masked(dag, state.public, state.private)
            dag = D.retire_below(dag, _at(dag.gid, ca))
            state = state.replace(
                dag=dag, race_tip=D.drop_if_retired(dag, state.race_tip))
        # winner (spar.ml:123-128): ties to the attacker
        n_pub = self.confirming(dag, state.public).sum(1)
        n_priv = self.confirming(dag, state.private).sum(1)
        hp = _at(dag.height, state.public)
        hv = _at(dag.height, state.private)
        pub_better = (hp > hv) | ((hp == hv) & (n_pub > n_priv))
        head = torch.where(pub_better, state.public, state.private)
        return self.finish_step(
            state, params,
            reward_attacker=_at(dag.cum_atk, head),
            reward_defender=_at(dag.cum_def, head),
            progress=(_at(dag.height, head) * self.k).to(F32),
            chain_time=_at(dag.born_at, head),
            extra_done=dag.overflow)

    # -- policies (spar_ssz.ml:332-351) -------------------------------------

    def _policy_ints(self, policy_id: int, pub_b, priv_b):
        c = lambda v: torch.full_like(pub_b, v)  # noqa: E731
        w = torch.where
        if policy_id == 0:  # honest
            return w(pub_b > 0, c(ADOPT_PROCEED), c(OVERRIDE_PROCEED))
        if policy_id == 1:  # selfish
            return w(priv_b < pub_b, c(ADOPT_PROCEED),
                     w((priv_b == 0) & (pub_b == 0), c(WAIT_PROLONG),
                       w(pub_b == 0, c(WAIT_PROCEED), c(OVERRIDE_PROCEED))))
        raise ValueError(f"unknown policy id {policy_id}")

    def policy_from_ints(self, policy_id: int, state):
        v = self.obs_ints(state)
        return self._policy_ints(policy_id, v[0], v[1])

    def _make_policies(self):
        def make(pid, name):
            def policy(obs):
                v = self.decode_obs(obs)
                return self._policy_ints(pid, v[0], v[1])
            policy.policy_name = name
            policy.policy_owner = type(self)
            return policy

        return {name: make(i, name) for i, name in enumerate(POLICY_NAMES)}

    def _check_kernel(self):
        from cpr_tpu_torch import kernels
        super()._check_kernel()
        kernels.check_spar_modes(type(self).__name__, self.k)

    # -- kernel hooks (K10-spar) --------------------------------------------

    def kernel_config(self):
        return dict(k=self.k,
                    constant=int(self.incentive_scheme == "constant"))
