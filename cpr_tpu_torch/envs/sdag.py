"""Sdag — simple parallel PoW with DAG-structured voting — under the
SSZ-like withholding attack space, on the DAG substrate (port of
cpr_tpu/envs/sdag.py).

Reference counterparts:
- protocol: simulator/protocols/sdag.ml — every vertex carries PoW; a
  vote references the leaves of its miner's current quorum attempt (a
  vote's number is the size of its vote closure), a block references
  leaves whose closure holds exactly k-1 votes confirming the previous
  block (139-172); selections altruistic and heuristic (reward density)
  returning Full or Partial sets (292-364); rewards constant / discount
  (190-223); preference (height, confirming votes) (399-413),
- attack space: simulator/protocols/sdag_ssz.ml — the 7-field
  observation (22-46), Action8 with a persistent Proceed/Prolong mining
  filter, the prefix release scan, the six policies,
- engine semantics: simulator/gym/engine.ml:97-273.

The layout mirrors `envs/stree.py`; votes have up to k-1 parents, so the
candidate frame closes over every parent column. Plain twin of kernel
K10-sdag (`csrc/sdag_stream.cu`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cpr_tpu_torch import obs as obslib
from cpr_tpu_torch import random
from cpr_tpu_torch.core import dag as D
from cpr_tpu_torch.envs import quorum as Q
from cpr_tpu_torch.envs.base import DagEnv

I32, F32 = torch.int32, torch.float32

BLOCK, VOTE = 0, 1
EV_POW, EV_NETWORK = 0, 1

(ADOPT_PROLONG, OVERRIDE_PROLONG, MATCH_PROLONG, WAIT_PROLONG,
 ADOPT_PROCEED, OVERRIDE_PROCEED, MATCH_PROCEED, WAIT_PROCEED) = range(8)

INCENTIVE_SCHEMES = ("constant", "discount")
SUBBLOCK_SELECTIONS = ("altruistic", "heuristic")
# kernel policy ids (csrc/sdag_stream.cu `policy`)
POLICY_NAMES = ("honest", "release-block", "override-block",
                "override-catchup", "minor-delay", "avoid-loss")


def obs_fields(k: int):
    """sdag_ssz.ml:22-46: public votes scale with k, private with k-1."""
    q = max(k - 1, 1)
    return (
        obslib.Field("public_blocks", obslib.UINT, scale=1),
        obslib.Field("private_blocks", obslib.UINT, scale=1),
        obslib.Field("diff_blocks", obslib.INT, scale=1),
        obslib.Field("public_votes", obslib.UINT, scale=k),
        obslib.Field("private_votes_inclusive", obslib.UINT, scale=q),
        obslib.Field("private_votes_exclusive", obslib.UINT, scale=q),
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
    stale: torch.Tensor  # bool [L, B], withheld vertices abandoned at Adopt
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


def discount_factor(q: int) -> torch.Tensor:
    """The float32 reciprocal 1/max(q, 1) that XLA multiplies by where
    the reference divides by the constant (csrc/sdag_stream.cu's
    `discount_factor`)."""
    return torch.tensor(1.0, dtype=F32) / torch.tensor(float(max(q, 1)),
                                                        dtype=F32)


def xla_row_sum(x) -> torch.Tensor:
    """The float32 sum of each row of x [L, C] in XLA:CPU's order: a row
    of at most 32 adds up from the first element; a longer one is padded
    to a multiple of 32, half the padding in front, and its windows of 32
    add up in turn, the window sums then in order (XLA's tree reduction
    rewrite; C <= 64 gives at most two windows)."""
    L, C = x.shape
    if C > 32:
        pad = -C % 32
        x = torch.cat([x.new_zeros((L, pad // 2)), x,
                       x.new_zeros((L, pad - pad // 2))], 1)
        parts = [xla_row_sum(w) for w in x.split(32, dim=1)]
        return xla_row_sum(torch.stack(parts, 1))
    acc = x.new_zeros(L)
    for j in range(C):
        acc = acc + x[:, j]
    return acc


def select_heuristic(f: Q.Frame, own_c, q: int):
    """Reward-density greedy (sdag.py:201-240, sdag.ml:330-359): at most
    max(q, 1) rounds, each adding the candidate c whose closure gives the
    set S'_c = S | closure(c) the largest (own reward gain) / (size
    gain), the first candidate on ties (an arange * 1e-7 tiebreak), while
    S'_c holds at most q votes. Own reward(S') is the sum over own x in
    S' of |descendants of x in S'| + |closure(x) & S'| - 1, exact
    integers in float32. Returns (S [L, C] bool, n [L] int64)."""
    L, C = f.cidx.shape
    dev = f.cidx.device
    A = f.abits.to(F32)
    own_f = (own_c & f.cvalid).to(F32)[:, None, :]
    tie = torch.arange(C, device=dev).to(F32) * torch.full(
        (C,), 1e-7, dtype=F32, device=dev)
    S = torch.zeros((L, C), dtype=torch.bool, device=dev)
    n = torch.zeros(L, dtype=torch.int64, device=dev)
    mrn = torch.zeros(L, dtype=F32, device=dev)
    ln = torch.arange(L, device=dev)
    for _ in range(max(q, 1)):
        Sc = S[:, None, :] | f.abits  # row c: S after adding c
        size = Sc.sum(2)
        Sf = Sc.to(F32)
        col = torch.bmm(Sf, A)  # |descendants of x in S'_c|
        row = torch.bmm(Sf, A.transpose(1, 2))  # |closure(x) & S'_c|
        mrt = ((col + row - 1.0) * own_f * Sf).sum(2)
        eligible = (f.cvalid & ~S & (size <= q) & (size > n[:, None])
                    & (n < q)[:, None])
        gain = torch.clamp((size - n[:, None]).to(F32), min=1.0)
        density = (mrt - mrn[:, None]) / gain - tie[None, :]
        density = torch.where(eligible, density,
                              torch.full_like(density, -math.inf))
        c = torch.argmax(density, dim=1)
        ok = density[ln, c] > -math.inf
        if not bool(ok.any()):
            break  # no set changed: the later rounds find nothing either
        S = torch.where(ok[:, None], Sc[ln, c], S)
        n = torch.where(ok, size[ln, c], n)
        mrn = torch.where(ok, mrt[ln, c], mrn)
    return S, n


class SdagSSZ(DagEnv):
    n_actions = 8
    scripted_policies = POLICY_NAMES
    state_cls = State
    int_fields = INT_FIELDS
    bool_fields = BOOL_FIELDS
    plane_fields = ("stale",)
    kernel_name, kernel_lib = "K10-sdag", "sdag"

    def __init__(self, k: int = 8, incentive_scheme: str = "constant",
                 subblock_selection: str = "heuristic",
                 unit_observation: bool = True, max_steps_hint: int = 256,
                 release_scan: int = 128, window: int | None = None,
                 anc_masks: bool | None = None):
        assert k >= 2  # sdag.ml:3-24
        assert incentive_scheme in INCENTIVE_SCHEMES
        assert subblock_selection in SUBBLOCK_SELECTIONS
        self.k = k
        self.q = k - 1
        self.incentive_scheme = incentive_scheme
        self.subblock_selection = subblock_selection
        self.unit_observation = unit_observation
        self.max_parents = max(k - 1, 1)  # leaves only (votes or blocks)
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

    # -- protocol primitives (sdag.ml) -------------------------------------

    def confirming(self, dag, b, extra_mask=None):
        m = (dag.exists() & (dag.kind == VOTE) & (dag.signer == b[:, None])
             & D.newer_than(dag, b))
        if extra_mask is not None:
            m = m & extra_mask
        return m

    def last_block(self, dag, x):
        return torch.where(_at(dag.kind, x) == BLOCK, x, _at(dag.signer, x))

    def last_block_all(self, dag):
        return Q.last_of_kind_all(dag, BLOCK)

    def prev_block(self, dag, b):
        """A block's previous block, cached in `aux2` at append."""
        return dag.aux2.gather(1, b.long())

    def block_lca(self, dag, a, b):
        """Common ancestor along the block chain (sdag.py:155-175): the
        chain plane in a ring (blocks' chain pointer is their previous
        block), else a height-synchronized walk over prev_block."""
        if dag.has_masks:
            return D.common_ancestor_masked(dag, a, b).clamp(min=0)
        x, y = a.clone(), b.clone()
        while True:
            live = (x != y) & (x >= 0) & (y >= 0)
            if not bool(live.any()):
                return x.clamp(min=0)
            hx, hy = _at(dag.height, x), _at(dag.height, y)
            nx = torch.where(hx >= hy, _at(dag.aux2, x), x)
            ny = torch.where(hy >= hx, _at(dag.aux2, y), y)
            x, y = torch.where(live, nx, x), torch.where(live, ny, y)

    def vote_score(self, dag):
        """compare_votes_in_block: vote number desc, then insertion order
        (the age key above the ring floor over the capacity)."""
        age = (dag.age_key() - dag.live_floor[:, None]).to(F32)
        return dag.aux.to(F32) - Q.fdiv(age, self.capacity)

    def cmp_blocks(self, dag, x, y, vote_filter_mask):
        """sdag.ml:399-413: strict (height, filtered confirming votes)."""
        return Q.prefers(dag, x, y, vote_filter_mask)

    def update_head(self, dag, old, cand, vote_filter_mask):
        return torch.where(self.cmp_blocks(dag, cand, old, vote_filter_mask),
                           cand, old)

    # -- quorum selection ---------------------------------------------------

    def select(self, dag, b, voter, vote_filter_mask, view_mask):
        """Full/Partial vote-set selection (sdag.ml:292-364): (full, n,
        the selection's true leaves as a parent row [L, P], the frame and
        the selected set S)."""
        cand = self.confirming(dag, b) & vote_filter_mask & view_mask
        own = dag.miner == voter[:, None]
        f = Q.candidate_frame(dag, cand, self.C_MAX, VOTE,
                              max_vote_parents=self.max_parents)
        if self.subblock_selection == "altruistic":
            seen = torch.where((voter == D.ATTACKER)[:, None], dag.born_at,
                               dag.vis_d_since)
            n, S, _, _ = Q.quorum_altruistic(f, own, seen, dag.aux, self.q)
        else:
            S, n = select_heuristic(f, f.gather(own) > 0.5, self.q)
        # true leaves: members of S no other member has in its closure
        desc_in_S = (f.abits & S[:, :, None]).sum(1)
        leaves_c = S & (desc_in_S == 1)
        row = Q.leaves_to_row(dag, f, leaves_c, self.max_parents,
                              self.vote_score(dag))
        return n == self.q, n, row, f, S

    def block_reward(self, dag, f: Q.Frame, S, miner):
        """sdag.ml:190-223: the block miner earns 1 and each confirmed
        vote r, discount r = (fwd + bwd - 1)/(k-1) with fwd/bwd counted
        inside the selection. XLA:CPU computes the division by the
        constant k-1 as a product with its float32 reciprocal and sums
        the votes' r as `xla_row_sum` does; so does this."""
        A = f.abits.to(F32)
        in_S = S & f.cvalid
        Sf = in_S.to(F32)
        if self.incentive_scheme == "discount":
            fwd = (Sf[:, :, None] * A).sum(1)
            bwd = (A * Sf[:, None, :]).sum(2)
            r = (fwd + bwd - 1.0) * discount_factor(self.q)
        else:
            r = torch.ones_like(Sf)
        m = f.gather(dag.miner).to(I32)
        zero = torch.zeros_like(r)
        atk = xla_row_sum(torch.where(in_S & (m == D.ATTACKER), r, zero)) \
            + (miner == D.ATTACKER).to(F32)
        dfn = xla_row_sum(torch.where(in_S & (m == D.DEFENDER), r, zero)) \
            + (miner == D.DEFENDER).to(F32)
        return atk, dfn

    def _mine_one(self, dag, head, view, vote_filter, miner, time, powh):
        """puzzle_payload' (sdag.ml:366-397): a block on a Full selection,
        else a vote on the leaves of the Partial one (or on the block)."""
        full, n, leaves_row, f, S = self.select(dag, head, miner,
                                                vote_filter, view)
        atk, dfn = self.block_reward(dag, f, S, miner)
        row_first = torch.full_like(leaves_row, D.NONE)
        row_first[:, 0] = head
        row = torch.where((full | (n > 0))[:, None], leaves_row, row_first)
        kind = torch.where(full, _c(head, BLOCK), _c(head, VOTE))
        height = _at(dag.height, head) + full.to(I32)
        aux = torch.where(full, torch.zeros_like(n), n + 1).to(I32)
        signer = torch.where(full, _c(head, D.NONE), head)
        zero = torch.zeros_like(atk)
        dag, idx = D.append(
            dag, row, kind=kind, height=height, aux=aux, pow_hash=powh,
            signer=signer, miner=miner, vis_a=True,
            vis_d=(miner == D.DEFENDER), time=time,
            reward_atk=torch.where(full, atk, zero),
            reward_def=torch.where(full, dfn, zero),
            progress=(height * self.k + aux).to(F32),
            # blocks cache their previous block and chain to it; votes
            # chain through their first leaf
            aux2=torch.where(full, head, _c(head, D.NONE)),
            chain_parent=torch.where(full, head, row[:, 0]))
        return dag, idx, full

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
        """sdag.py:342-382: one mining draw every step."""
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
        """sdag_ssz.ml:226-249."""
        dag = state.dag
        ca = self.block_lca(dag, state.public, state.private)
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

    def _release_sets(self, state: State):
        dag = state.dag
        cands = dag.exists() & ~dag.vis_d & ~state.stale
        return Q.prefix_release_sets(
            dag, state.public, state.private, cands, self.release_scan,
            self.last_block_all(dag), self.cmp_blocks)

    def _apply(self, state: State, action) -> State:
        """sdag.py:412-443."""
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
            self.STALE_WALK, self.last_block_all(dag), self.prev_block)
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
            # retire strictly below the block-chain LCA of the two heads
            ca = self.block_lca(dag, state.public, state.private)
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

    # -- policies (sdag_ssz.ml Policies) ------------------------------------

    def _policy_ints(self, policy_id: int, pub_b, priv_b, pub_v, priv_vi):
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
                     w(pub_b == 0, c(WAIT_PROCEED),
                       w((priv_vi == 0) & (priv_b == pub_b + 1),
                         c(OVERRIDE_PROCEED),
                         w((pub_b == priv_b) & (priv_vi == pub_v + 1),
                           c(OVERRIDE_PROCEED),
                           w(priv_b - pub_b > 10, c(OVERRIDE_PROCEED),
                             c(WAIT_PROCEED))))))
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
        return self._policy_ints(policy_id, v[0], v[1], v[3], v[4])

    def _make_policies(self):
        def make(pid, name):
            def policy(obs):
                v = self.decode_obs(obs)
                return self._policy_ints(pid, v[0], v[1], v[3], v[4])
            policy.policy_name = name
            policy.policy_owner = type(self)
            return policy

        return {name: make(i, name) for i, name in enumerate(POLICY_NAMES)}

    def _check_kernel(self):
        from cpr_tpu_torch import kernels
        super()._check_kernel()
        kernels.check_quorum_modes(type(self).__name__, self.C_MAX,
                                   self.release_scan, self.max_parents)

    # -- kernel hooks (K10-sdag) --------------------------------------------

    def kernel_config(self):
        return dict(k=self.k,
                    scheme=INCENTIVE_SCHEMES.index(self.incentive_scheme),
                    selection=SUBBLOCK_SELECTIONS.index(
                        self.subblock_selection),
                    cmax=self.C_MAX, rscan=self.release_scan)
