"""Stree — simple parallel PoW with tree-structured voting — under the
SSZ-like withholding attack space, on the DAG substrate (port of
cpr_tpu/envs/stree.py).

Reference counterparts:
- protocol: simulator/protocols/stree.ml — every vertex carries PoW; a
  vote extends the deepest branch confirming a block (136-144), a block
  references its parent block plus quorum leaves whose closure holds k-1
  votes (144-151); selections altruistic / heuristic / optimal (383-486);
  rewards constant / discount / punish / hybrid pay the block and its
  confirmed votes (176-202); preference (height, confirming votes)
  (518-531),
- attack space: simulator/protocols/stree_ssz.ml — the 10-field
  observation (22-44), Action8 with a persistent Proceed/Prolong mining
  filter (166, 302-309), release prefixes (272-295), the six policies
  (327-420),
- engine semantics: simulator/gym/engine.ml:97-273.

The layout mirrors `envs/tailstorm.py`. Blocks carry PoW, so appends are
never deduplicated and there are no Append interactions: one step is one
attacker action and one mining draw, whose payload (block or vote) is
decided at mining time. Plain twin of kernel K10-stree
(`csrc/stree_stream.cu`).
"""

from __future__ import annotations

import dataclasses

import torch

from cpr_tpu_torch import obs as obslib
from cpr_tpu_torch import random
from cpr_tpu_torch.core import dag as D
from cpr_tpu_torch.envs import quorum as Q
from cpr_tpu_torch.envs.base import DagEnv

I32, F32 = torch.int32, torch.float32

BLOCK, VOTE = 0, 1

# events: Discrete [`ProofOfWork; `Network] (stree_ssz.ml:49)
EV_POW, EV_NETWORK = 0, 1

(ADOPT_PROLONG, OVERRIDE_PROLONG, MATCH_PROLONG, WAIT_PROLONG,
 ADOPT_PROCEED, OVERRIDE_PROCEED, MATCH_PROCEED, WAIT_PROCEED) = range(8)

INCENTIVE_SCHEMES = ("constant", "discount", "punish", "hybrid")
SUBBLOCK_SELECTIONS = ("altruistic", "heuristic", "optimal")
# kernel policy ids (csrc/stree_stream.cu `policy`)
POLICY_NAMES = ("honest", "release-block", "override-block",
                "override-catchup", "minor-delay", "avoid-loss")


def obs_fields(k: int):
    """stree_ssz.ml:22-49: the public fields scale with k, the private
    ones with k-1."""
    q = max(k - 1, 1)
    return (
        obslib.Field("public_blocks", obslib.UINT, scale=1),
        obslib.Field("private_blocks", obslib.UINT, scale=1),
        obslib.Field("diff_blocks", obslib.INT, scale=1),
        obslib.Field("public_votes", obslib.UINT, scale=k),
        obslib.Field("private_votes_inclusive", obslib.UINT, scale=q),
        obslib.Field("private_votes_exclusive", obslib.UINT, scale=q),
        obslib.Field("public_depth", obslib.UINT, scale=k),
        obslib.Field("private_depth_inclusive", obslib.UINT, scale=q),
        obslib.Field("private_depth_exclusive", obslib.UINT, scale=q),
        obslib.Field("event", obslib.DISCRETE, n=2),
    )


@dataclasses.dataclass
class State:
    """Per-lane env state; every field has a leading lane axis."""

    dag: D.Dag
    public: torch.Tensor  # int32
    private: torch.Tensor  # int32
    event: torch.Tensor  # int32
    race_tip: torch.Tensor  # int32, live match race target block
    mining_excl: torch.Tensor  # bool, Prolong: exclusive vote filter
    stale: torch.Tensor  # bool [L, B], withheld blocks abandoned at Adopt
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


class StreeSSZ(DagEnv):
    n_actions = 8
    scripted_policies = POLICY_NAMES
    state_cls = State
    int_fields = INT_FIELDS
    bool_fields = BOOL_FIELDS
    plane_fields = ("stale",)
    kernel_family, kernel_lib = "K10-stree", "stree"

    def __init__(self, k: int = 8, incentive_scheme: str = "constant",
                 subblock_selection: str = "heuristic",
                 unit_observation: bool = True, max_steps_hint: int = 256,
                 release_scan: int = 128, window: int | None = None,
                 anc_masks: bool | None = None):
        assert k >= 2
        assert incentive_scheme in INCENTIVE_SCHEMES
        assert subblock_selection in SUBBLOCK_SELECTIONS
        self.k = k
        self.q = k - 1
        self.incentive_scheme = incentive_scheme
        self.subblock_selection = subblock_selection
        if subblock_selection == "optimal":
            self.opt_window = Q.optimal_window(k - 1, 4 * k + 16)
            self.opt_combos = Q.optimal_combos(k - 1, self.opt_window)
        self.unit_observation = unit_observation
        self.max_parents = k  # parent block + k-1 leaves
        self.C_MAX = 4 * k + 16
        self.capacity = max(max_steps_hint + 8, self.C_MAX)
        if window is not None:
            self.capacity = max(window, self.C_MAX)
        self.ring = window is not None
        self.anc_masks = self.ring if anc_masks is None else anc_masks
        assert self.anc_masks or not self.ring, \
            "ring windows require anc_masks (walks could cross reclaimed slots)"
        self.lift = False
        self.STALE_WALK = 4
        self.release_scan = min(release_scan, self.capacity)
        self.fields = obs_fields(k)
        self.observation_length = len(self.fields)
        self.low, self.high = obslib.low_high(self.fields, unit_observation)
        self.policies = self._make_policies()

    @property
    def discount(self) -> bool:
        return self.incentive_scheme in ("discount", "hybrid")

    @property
    def punish(self) -> bool:
        return self.incentive_scheme in ("punish", "hybrid")

    # -- protocol primitives (stree.ml) ------------------------------------

    def confirming(self, dag, b, extra_mask=None):
        m = (dag.exists() & (dag.kind == VOTE) & (dag.signer == b[:, None])
             & D.newer_than(dag, b))
        if extra_mask is not None:
            m = m & extra_mask
        return m

    def last_block(self, dag, x):
        return torch.where(_at(dag.kind, x) == BLOCK, x, _at(dag.signer, x))

    def last_block_all(self, dag):
        """[L, B] last_block of every slot (Q.last_of_kind_all)."""
        return Q.last_of_kind_all(dag, BLOCK)

    def common_ancestor(self, dag, a, b):
        if dag.has_masks:
            return D.common_ancestor_masked(dag, a, b)
        return D.common_ancestor_by_height(dag, a, b)

    def vote_score(self, dag):
        """compare_votes_in_block (stree.ml:96-100): depth desc, ties in
        insertion order (the age key above the ring floor over the
        capacity)."""
        age = (dag.age_key() - dag.live_floor[:, None]).to(F32)
        return dag.aux.to(F32) - Q.fdiv(age, self.capacity)

    vote_order = vote_score

    def cmp_blocks(self, dag, x, y, vote_filter_mask):
        """stree.ml:518-527: strict (height, filtered confirming votes)."""
        return Q.prefers(dag, x, y, vote_filter_mask)

    def update_head(self, dag, old, cand, vote_filter_mask):
        return torch.where(self.cmp_blocks(dag, cand, old, vote_filter_mask),
                           cand, old)

    def quorum(self, dag, b, voter, vote_filter_mask, view_mask):
        """k-1 sized vote-closure selection (stree.ml:383-486): (found,
        leaves row [L, k-1])."""
        cand = self.confirming(dag, b) & vote_filter_mask & view_mask
        own = dag.miner == voter[:, None]
        f = Q.candidate_frame(dag, cand, self.C_MAX, VOTE)
        score = self.vote_score(dag)
        if self.subblock_selection == "altruistic":
            seen = torch.where((voter == D.ATTACKER)[:, None], dag.born_at,
                               dag.vis_d_since)
            n, _, leaves_c, n_cand = Q.quorum_altruistic(f, own, seen,
                                                         dag.aux, self.q)
            found = (n == self.q) & (n_cand >= self.q)
        elif self.subblock_selection == "optimal":
            found, leaves_c = Q.quorum_optimal_or_heuristic(
                f, own, dag.aux, self.q, self.opt_window, self.opt_combos,
                k=self.k, discount=self.discount, punish=self.punish,
                depth_plus=1, leaf_score=score, miner_share=1)
        else:
            found, leaves_c = Q.quorum_heuristic(f, own, self.q)
        return found, Q.leaves_to_row(dag, f, leaves_c, self.q, score)

    def block_reward(self, dag, leaves_row, miner):
        """stree.ml:176-202: the block and its confirmed vote closure each
        earn r; discount r = (depth + 1)/k, punish pays the first leaf's
        branch only."""
        L, dev = dag.n_lanes, dag.device
        leaves = leaves_row[:, :1] if self.punish else leaves_row
        closure = torch.zeros((L, dag.capacity), dtype=torch.bool,
                              device=dev)
        slots = dag.slots()[None, None, :]
        cur = leaves
        for _ in range(self.C_MAX):
            ci = cur.clamp(min=0).long()
            valid = (cur >= 0) & (dag.kind.gather(1, ci) == VOTE)
            if not bool(valid.any()):
                break
            closure = closure | ((cur[:, :, None] == slots)
                                 & valid[:, :, None]).any(1)
            cur = torch.where(valid, dag.parent0.gather(1, ci),
                              torch.full_like(cur, -1))
        depth0 = _at(dag.aux, leaves_row[:, 0])
        r = (Q.fdiv(depth0 + 1, self.k) if self.discount
             else torch.ones(L, dtype=F32, device=dev))
        atk = r * ((closure & (dag.miner == D.ATTACKER)).sum(1)
                   + (miner == D.ATTACKER)).to(F32)
        dfn = r * ((closure & (dag.miner == D.DEFENDER)).sum(1)
                   + (miner == D.DEFENDER)).to(F32)
        return atk, dfn

    def _mine_one(self, dag, head, view, vote_filter, miner, time, powh):
        """puzzle_payload' (stree.ml:488-516): a block where a k-1 quorum
        exists, else a vote on the deepest filtered branch."""
        found, leaves = self.quorum(dag, head, miner, vote_filter, view)
        row_block = torch.cat([head[:, None].to(I32), leaves], 1)
        atk, dfn = self.block_reward(dag, leaves, miner)
        cand = self.confirming(dag, head, view) & vote_filter
        has = cand.any(1)
        score = torch.where(cand, self.vote_score(dag),
                            torch.full_like(dag.pow_hash, -float("inf")))
        parent = torch.where(has, torch.argmax(score, dim=1).to(I32), head)
        depth = torch.where(has, _at(dag.aux, parent) + 1, _c(head, 1))
        row_vote = torch.full_like(row_block, D.NONE)
        row_vote[:, 0] = parent
        row = torch.where(found[:, None], row_block, row_vote)
        kind = torch.where(found, _c(head, BLOCK), _c(head, VOTE))
        height = _at(dag.height, head) + found.to(I32)
        aux = torch.where(found, _c(head, 0), depth)
        signer = torch.where(found, _c(head, D.NONE), head)
        zero = torch.zeros_like(atk)
        dag, idx = D.append(
            dag, row, kind=kind, height=height, aux=aux, pow_hash=powh,
            signer=signer, miner=miner, vis_a=True,
            vis_d=(miner == D.DEFENDER), time=time,
            reward_atk=torch.where(found, atk, zero),
            reward_def=torch.where(found, dfn, zero),
            progress=(height * self.k + aux).to(F32))
        return dag, idx, found

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
            stale=torch.zeros((n, self.capacity), dtype=torch.bool,
                              device=dev),
            time=f, steps=z.clone(), n_activations=z.clone(),
            last_reward_attacker=f.clone(), last_reward_defender=f.clone(),
            last_progress=f.clone(), last_chain_time=f.clone(),
            last_sim_time=f.clone(), key=keys.clone())
        state = self._mine(state, params)
        return state, self.observe(state)

    def _mine(self, state: State, params) -> State:
        """stree.py:305-346: one mining draw every step."""
        dag = state.dag
        ks = random.threefry_plain(state.key, 5)
        bits = random.threefry_plain(ks[:, 1:], 1, 0, random.MODE_BITS)[..., 0]
        dt = random.exponential_of_bits(bits[:, 0]) * params.activation_delay
        time = state.time + dt
        attacker = random.uniform_of_bits(bits[:, 1]) < params.alpha
        powh = random.uniform_of_bits(bits[:, 2])
        tgt = state.race_tip.clamp(min=0)
        still_tie = ((state.race_tip >= 0)
                     & ~self.cmp_blocks(dag, state.public, tgt, dag.vis_d)
                     & ~self.cmp_blocks(dag, tgt, state.public, dag.vis_d))
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
        stale = state.stale.clone()
        stale[D.lanes(dag), idx] = False
        private = torch.where(attacker & is_blk, idx, state.private)
        public = torch.where(
            attacker, state.public,
            torch.where(is_blk, self.update_head(dag, def_head, idx,
                                                 dag.vis_d), def_head))
        return state.replace(
            dag=dag, private=private, public=public, race_tip=race_tip,
            stale=stale,
            event=torch.where(attacker, _c(tgt, EV_POW), _c(tgt, EV_NETWORK)),
            time=time, n_activations=state.n_activations + 1,
            key=ks[:, 0])

    def obs_ints(self, state: State):
        """stree_ssz.ml:242-270."""
        dag = state.dag
        ca = self.common_ancestor(dag, state.public, state.private) \
            .clamp(min=0)

        def depth_count(mask):
            return (torch.where(mask, dag.aux, torch.zeros_like(dag.aux))
                    .amax(1), mask.sum(1).to(I32))

        pub_d, pub_v = depth_count(self.confirming(dag, state.public,
                                                   dag.vis_d))
        inc_d, inc_v = depth_count(self.confirming(dag, state.private))
        exc_d, exc_v = depth_count(self.confirming(
            dag, state.private, dag.miner == D.ATTACKER))
        hp, hv, hc = (_at(dag.height, state.public),
                      _at(dag.height, state.private), _at(dag.height, ca))
        return (hp - hc, hv - hc, hv - hp, pub_v, inc_v, exc_v, pub_d, inc_d,
                exc_d, state.event)

    def observe(self, state: State):
        return obslib.encode(self.fields, self.obs_ints(state),
                             self.unit_observation)

    def _release_sets(self, state: State):
        dag = state.dag
        cands = dag.exists() & ~dag.vis_d & ~state.stale
        return Q.prefix_release_sets(
            dag, state.public, state.private, cands, self.release_scan,
            self.last_block_all(dag), self.cmp_blocks)

    def _apply(self, state: State, action) -> State:
        """stree_ssz.ml:272-314."""
        dag = state.dag
        is_adopt = (action == ADOPT_PROLONG) | (action == ADOPT_PROCEED)
        is_override = (action == OVERRIDE_PROLONG) | \
            (action == OVERRIDE_PROCEED)
        is_match = (action == MATCH_PROLONG) | (action == MATCH_PROCEED)
        is_release = is_override | is_match
        override_set, match_set, found, new_head = self._release_sets(state)
        mask = torch.where(is_override[:, None], override_set,
                           match_set & is_match[:, None])
        released = D.release(dag, mask, state.time)
        dag = D.select_vis(is_release, released, dag)
        public = torch.where(is_override & found, new_head, state.public)
        private = torch.where(is_adopt, public, state.private)
        stale = Q.stale_after_adopt(
            dag, public, state.stale, is_adopt, self.release_scan,
            self.STALE_WALK, self.last_block_all(dag),
            lambda d, i: d.parent0.gather(1, i.long()))
        rel_tip = D.last_by_age(dag, match_set)
        race_tip = torch.where(
            is_match & found & (rel_tip >= 0),
            self.last_block(dag, rel_tip.clamp(min=0)),
            torch.where(is_adopt | is_override, _c(rel_tip, D.NONE),
                        state.race_tip))
        return state.replace(dag=dag, public=public, private=private,
                             race_tip=race_tip, stale=stale,
                             mining_excl=action < 4)

    def step(self, state: State, action, params):
        state = self._apply(state, action.to(I32))
        state = self._mine(state, params)
        state = state.replace(steps=state.steps + 1)
        dag = state.dag
        if self.ring:
            ca = self.common_ancestor(dag, state.public, state.private)
            dag = D.retire_below(dag, _at(dag.gid, ca))
            state = state.replace(
                dag=dag, race_tip=D.drop_if_retired(dag, state.race_tip))
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

    # -- policies (stree_ssz.ml:327-420) ------------------------------------

    def _policy_ints(self, policy_id: int, pub_b, priv_b, pub_v, priv_vi,
                     inc_d):
        k = self.k
        c = lambda v: torch.full_like(pub_b, v)  # noqa: E731
        w = torch.where
        if policy_id == 0:  # honest
            return w(pub_b > 0, c(ADOPT_PROCEED), c(OVERRIDE_PROCEED))
        if policy_id == 1:  # release-block
            return w(priv_b < pub_b, c(ADOPT_PROCEED),
                     w(priv_b > pub_b, c(OVERRIDE_PROCEED), c(WAIT_PROCEED)))
        if policy_id == 2:  # override-block
            return w(priv_b < pub_b, c(ADOPT_PROCEED),
                     w(pub_b == 0, c(WAIT_PROCEED), c(OVERRIDE_PROCEED)))
        if policy_id == 3:  # override-catchup
            return w(priv_b < pub_b, c(ADOPT_PROCEED),
                     w((priv_b == 0) & (pub_b == 0), c(WAIT_PROCEED),
                       w(pub_b == 0, c(WAIT_PROCEED),
                         w((inc_d == 0) & (priv_b == pub_b + 1),
                           c(OVERRIDE_PROCEED),
                           w((pub_b == priv_b) & (priv_vi == pub_v + 1),
                             c(OVERRIDE_PROCEED),
                             w(priv_b - pub_b > 10, c(OVERRIDE_PROCEED),
                               c(WAIT_PROCEED)))))))
        if policy_id == 4:  # minor-delay
            return w(pub_b > priv_b, c(ADOPT_PROCEED),
                     w(pub_b == 0, c(WAIT_PROCEED), c(OVERRIDE_PROCEED)))
        if policy_id == 5:  # avoid-loss
            hp = pub_b * k + pub_v
            ap = priv_b * k + priv_vi
            return w(pub_b == 0, c(WAIT_PROCEED),
                     w((pub_b == 1) & (hp == ap), c(MATCH_PROCEED),
                       w(hp > ap, c(ADOPT_PROCEED),
                         w(hp == ap - 1, c(OVERRIDE_PROCEED),
                           w(pub_b < priv_b - 10, c(OVERRIDE_PROCEED),
                             c(WAIT_PROCEED))))))
        raise ValueError(f"unknown policy id {policy_id}")

    def policy_from_ints(self, policy_id: int, state):
        v = self.obs_ints(state)
        return self._policy_ints(policy_id, v[0], v[1], v[3], v[4], v[7])

    def _make_policies(self):
        def make(pid, name):
            def policy(obs):
                v = self.decode_obs(obs)
                return self._policy_ints(pid, v[0], v[1], v[3], v[4], v[7])
            policy.policy_name = name
            policy.policy_owner = type(self)
            return policy

        return {name: make(i, name) for i, name in enumerate(POLICY_NAMES)}

    def _check_kernel(self):
        from cpr_tpu_torch import kernels
        super()._check_kernel()
        kernels.check_quorum_modes(type(self).__name__, self.C_MAX,
                                   self.release_scan, self.q)

    # -- kernel hooks (K10-stree) -------------------------------------------

    @property
    def kernel_scheme(self) -> int:
        return INCENTIVE_SCHEMES.index(self.incentive_scheme)

    def kernel_config(self):
        return dict(k=self.k, scheme=self.kernel_scheme,
                    selection=SUBBLOCK_SELECTIONS.index(
                        self.subblock_selection),
                    cmax=self.C_MAX, rscan=self.release_scan,
                    opt_window=getattr(self, "opt_window", 0))
