"""Bₖ protocol under the SSZ-like withholding attack space, on the DAG
substrate (port of cpr_tpu/envs/bk.py).

Reference counterparts:
- protocol: simulator/protocols/bk.ml — k votes (PoW) per block, blocks
  signed by the leader (smallest vote hash), votes ordered by hash inside
  the block (bk.ml:110-132), quorum selection with replace-hash fast paths
  (bk.ml:233-279), `Block`/`Constant` reward schemes (bk.ml:151-176),
- attack space: simulator/protocols/bk_ssz.ml — 8 actions (Adopt|Override|
  Match|Wait x Prolong|Proceed), the 8-field observation (bk_ssz.ml:21-48),
  release targeting (bk_ssz.ml:271-306), proposals with inclusive or
  exclusive vote filters (bk_ssz.ml:316-326),
- engine semantics: simulator/gym/engine.ml:97-273.

One env step processes exactly one attacker event: a pending
self-append, a defender proposal, or one mining draw. The state is a
lane-batched `core.dag.Dag` plus per-lane scalars; the functions below
are plain PyTorch over all lanes at once and are the arithmetic of
kernel K10-bk (`csrc/bk_stream.cu`), which runs one warp per lane in
ring mode with ancestry planes. The deviations from the reference's
event-queue simulation are the JAX package's (cpr_tpu/envs/bk.py:25-67).
"""

from __future__ import annotations

import dataclasses

import torch

from cpr_tpu_torch import obs as obslib
from cpr_tpu_torch import random
from cpr_tpu_torch.core import dag as D
from cpr_tpu_torch.envs.base import DagEnv

I32, F32 = torch.int32, torch.float32

# kinds
BLOCK, VOTE = 0, 1

# events: Discrete [`Append; `ProofOfWork; `Network] (bk_ssz.ml:47)
EV_APPEND, EV_POW, EV_NETWORK = 0, 1, 2

# Action8 ranks (ssz_tools.ml:230-263)
(ADOPT_PROLONG, OVERRIDE_PROLONG, MATCH_PROLONG, WAIT_PROLONG,
 ADOPT_PROCEED, OVERRIDE_PROCEED, MATCH_PROCEED, WAIT_PROCEED) = range(8)

# kernel policy ids (csrc/bk_stream.cu `policy`)
POLICY_NAMES = ("honest", "get-ahead", "minor-delay", "avoid-loss")


def obs_fields(k: int):
    return (
        obslib.Field("public_blocks", obslib.UINT, scale=1),
        obslib.Field("private_blocks", obslib.UINT, scale=1),
        obslib.Field("diff_blocks", obslib.INT, scale=1),
        obslib.Field("public_votes", obslib.UINT, scale=k),
        obslib.Field("private_votes_inclusive", obslib.UINT, scale=k),
        obslib.Field("private_votes_exclusive", obslib.UINT, scale=k),
        obslib.Field("lead", obslib.BOOL),
        obslib.Field("event", obslib.DISCRETE, n=3),
    )


@dataclasses.dataclass
class State:
    """Per-lane env state; every field has a leading lane axis."""

    dag: D.Dag
    public: torch.Tensor  # int32, defender-preferred block
    private: torch.Tensor  # int32, attacker-preferred block
    event: torch.Tensor  # int32, EV_*
    pending_append: torch.Tensor  # int32, attacker proposal awaiting Append
    # episode bookkeeping (engine.ml:69-79)
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


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(State))
INT_FIELDS = ("public", "private", "event", "pending_append", "steps",
              "n_activations")


def _c(ref, v, dtype=I32):
    return torch.full_like(ref, v, dtype=dtype)


class BkSSZ(DagEnv):
    n_actions = 8
    # a fresh reset populates at most genesis + one first interaction
    # (DagEnv.reset_dag_rows = 2)
    scripted_policies = POLICY_NAMES
    state_cls = State
    int_fields = INT_FIELDS
    kernel_family, kernel_lib = "K10-bk", "bk"

    def __init__(self, k: int = 8, incentive_scheme: str = "constant",
                 unit_observation: bool = True, max_steps_hint: int = 256,
                 window: int | None = None,
                 anc_masks: bool | None = None):
        assert incentive_scheme in ("constant", "block")
        self.k = k
        self.incentive_scheme = incentive_scheme
        self.unit_observation = unit_observation
        self.capacity = max(2 * max_steps_hint + 8, k + 8)
        if window is not None:
            self.capacity = max(window, k + 8)
        self.ring = window is not None
        self.anc_masks = self.ring if anc_masks is None else anc_masks
        assert self.anc_masks or not self.ring, \
            "ring windows require anc_masks (walks could cross reclaimed slots)"
        self.lift = False
        self.max_parents = k + 1
        self.fields = obs_fields(k)
        self.observation_length = len(self.fields)
        self.low, self.high = obslib.low_high(self.fields, unit_observation)
        self.policies = self._make_policies()

    # -- protocol primitives (bk.ml) --------------------------------------

    def votes_on(self, dag, b, extra_mask=None):
        """[L, B] votes confirming block b (bk.ml:100-103)."""
        m = D.children0_mask(dag, b) & (dag.kind == VOTE)
        if extra_mask is not None:
            m = m & extra_mask
        return m

    def row_leader_hash(self, dag, row):
        """Hash of a proposal row's lead vote (row slot 1)."""
        v0 = row[:, 1]
        return torch.where(v0 >= 0, D.at(dag.pow_hash, v0.clamp(min=0)),
                           torch.full_like(dag.pow_hash[:, 0], D.NO_POW))

    def cmp_blocks(self, dag, x, y, vote_filter_mask):
        """compare_blocks (bk.ml:217-226): height, filtered votes, smaller
        leader hash, earlier defender visibility; x strictly preferred."""
        nx = self.votes_on(dag, x, vote_filter_mask).sum(1)
        ny = self.votes_on(dag, y, vote_filter_mask).sum(1)
        kx = (D.at(dag.height, x), nx, -D.at(dag.auxf, x),
              -D.at(dag.vis_d_since, x))
        ky = (D.at(dag.height, y), ny, -D.at(dag.auxf, y),
              -D.at(dag.vis_d_since, y))
        gt = torch.zeros_like(x, dtype=torch.bool)
        eq = torch.ones_like(gt)
        for a, b in zip(kx, ky):
            gt = gt | (eq & (a > b))
            eq = eq & (a == b)
        return torch.where(x == y, torch.zeros_like(gt), gt)

    def update_head(self, dag, old, candidate, vote_filter_mask):
        """bk.ml:228-231: switch only on strict improvement."""
        better = self.cmp_blocks(dag, candidate, old, vote_filter_mask)
        return torch.where(better, candidate, old)

    def quorum(self, dag, b, voter, vote_filter_mask, view_mask):
        """bk.ml:233-279: (found [L], parents row [L, k+1]) for a proposal
        on b by `voter` [L] — k votes with the voter's smallest hash
        leading."""
        k = self.k
        votes = self.votes_on(dag, b, vote_filter_mask & view_mask)
        mine = votes & (dag.aux == voter[:, None])
        theirs = votes & (dag.aux != voter[:, None])
        inf = torch.full_like(dag.pow_hash, float("inf"))
        my_hash = torch.where(mine, dag.pow_hash, inf).amin(1)
        child_blocks = D.children0_mask(dag, b) & (dag.kind == BLOCK) \
            & view_mask
        replace_hash = torch.where(child_blocks, dag.auxf, inf).amin(1)
        nvotes = votes.sum(1)
        nmine = mine.sum(1)
        idx_mine, valid_mine = D.top_k_by(dag.pow_hash, mine, k)
        theirs_ok = theirs & (dag.pow_hash > my_hash[:, None])
        seen = torch.where((voter == D.ATTACKER)[:, None], dag.born_at,
                           dag.vis_d_since)
        idx_theirs, valid_theirs = D.top_k_by(seen, theirs_ok, k)
        n_needed = k - nmine
        take_theirs = torch.arange(k, device=b.device)[None, :] \
            < n_needed[:, None]
        mine_sel = D.mask_of(idx_mine, valid_mine, dag.capacity)
        sel_mask = mine_sel | D.mask_of(idx_theirs, valid_theirs & take_theirs,
                                        dag.capacity)
        case1 = nmine >= k
        quorum_mask = torch.where(case1[:, None], mine_sel, sel_mask)
        enough_theirs = theirs_ok.sum(1) >= n_needed
        found = (replace_hash > my_hash) & (nvotes >= k) \
            & (case1 | enough_theirs)
        vidx, vvalid = D.top_k_by(dag.pow_hash, quorum_mask, k)
        row = torch.cat([b[:, None].to(I32),
                         torch.where(vvalid, vidx, _c(vidx, D.NONE))], 1)
        return found, row

    def reward_of_block(self, dag, parents_row, signer):
        """Per-block coinbase at append time (bk.ml:151-176)."""
        votes = parents_row[:, 1:]
        valid = votes >= 0
        if self.incentive_scheme == "constant":
            ids = dag.aux.gather(1, votes.clamp(min=0).long())
            atk = (valid & (ids == D.ATTACKER)).sum(1).to(F32)
            dfn = (valid & (ids == D.DEFENDER)).sum(1).to(F32)
        else:
            zero = torch.zeros(votes.shape[0], dtype=F32,
                               device=votes.device)
            atk = torch.where(signer == D.ATTACKER, zero + self.k, zero)
            dfn = torch.where(signer == D.DEFENDER, zero + self.k, zero)
        return atk, dfn

    def append_proposal(self, dag, b, voter, vote_filter_mask, view_mask,
                        time):
        """Append a quorum proposal on b where one is found; returns
        (dag, idx_or_NONE)."""
        found, row = self.quorum(dag, b, voter, vote_filter_mask, view_mask)
        atk, dfn = self.reward_of_block(dag, row, voter)
        height = D.at(dag.height, b) + 1
        return D.append_if(
            dag, found, row, kind=BLOCK, height=height, aux=0,
            signer=voter, miner=voter, vis_a=True,
            vis_d=(voter == D.DEFENDER), time=time, reward_atk=atk,
            reward_def=dfn, progress=(height * self.k).to(F32),
            auxf=self.row_leader_hash(dag, row))

    def common_ancestor(self, dag, a, b):
        if dag.has_masks:
            return D.common_ancestor_masked(dag, a, b)
        return D.common_ancestor_by_height(dag, a, b)

    def last_block(self, dag, x):
        """bk.ml:78-87: the block a vertex belongs to."""
        return torch.where(D.at(dag.kind, x) == BLOCK, x,
                           D.at(dag.parent0, x))

    # -- env API ----------------------------------------------------------

    def reset(self, keys, params):
        n, dev = keys.shape[0], keys.device
        dag = D.empty(n, self.capacity, self.max_parents, ring=self.ring,
                      anc_masks=self.anc_masks, device=dev)
        dag, root = D.append(
            dag, torch.full((n, self.max_parents), D.NONE, dtype=I32,
                            device=dev),
            kind=BLOCK, height=0, miner=D.NONE, vis_a=True, vis_d=True,
            time=0.0, progress=0.0, auxf=D.NO_POW)
        z = torch.zeros(n, dtype=I32, device=dev)
        f = torch.zeros(n, dtype=F32, device=dev)
        state = State(
            dag=dag, public=root, private=root.clone(),
            event=z + EV_POW, pending_append=z + D.NONE,
            time=f, steps=z.clone(), n_activations=z.clone(),
            last_reward_attacker=f.clone(), last_reward_defender=f.clone(),
            last_progress=f.clone(), last_chain_time=f.clone(),
            last_sim_time=f.clone(), key=keys.clone())
        state = self._advance(state, params)
        return state, self.observe(state)

    def _advance(self, state: State, params) -> State:
        """The next attacker interaction: pending self-append, defender
        proposal, or one mining draw, as one conditional row append
        (bk.py:340-419). The key splits in four and the three draws are
        made every step."""
        dag = state.dag
        has_pending = state.pending_append >= 0
        dfd = _c(state.public, D.DEFENDER)
        found, prow = self.quorum(dag, state.public, dfd, dag.vis_d,
                                  dag.vis_d)
        do_prop = ~has_pending & found
        do_mine = ~has_pending & ~found

        ks = random.threefry_plain(state.key, 4)  # [L, 4, 2]
        bits = random.threefry_plain(ks[:, 1:], 1, 0, random.MODE_BITS)[..., 0]
        dt = random.exponential_of_bits(bits[:, 0]) * params.activation_delay
        time = torch.where(do_mine, state.time + dt, state.time)
        attacker = random.uniform_of_bits(bits[:, 1]) < params.alpha
        powh = random.uniform_of_bits(bits[:, 2])
        target = torch.where(attacker, state.private, state.public)
        vrow = torch.full_like(prow, D.NONE)
        vrow[:, 0] = target
        miner_v = torch.where(attacker, _c(target, D.ATTACKER),
                              _c(target, D.DEFENDER))

        h_prop = D.at(dag.height, state.public) + 1
        h_tgt = D.at(dag.height, target)
        atk, dfn = self.reward_of_block(dag, prow, dfd)
        zero = torch.zeros_like(atk)
        dag, idx = D.append_if(
            dag, do_prop | do_mine,
            torch.where(do_prop[:, None], prow, vrow),
            kind=torch.where(do_prop, _c(target, BLOCK), _c(target, VOTE)),
            height=torch.where(do_prop, h_prop, h_tgt),
            aux=torch.where(do_prop, _c(target, 0), miner_v),
            pow_hash=torch.where(do_prop, torch.full_like(powh, D.NO_POW),
                                 powh),
            signer=torch.where(do_prop, dfd, _c(target, D.NONE)),
            miner=torch.where(do_prop, dfd, miner_v),
            vis_a=True, vis_d=torch.where(do_prop, do_prop, ~attacker),
            time=time,
            reward_atk=torch.where(do_prop, atk, zero),
            reward_def=torch.where(do_prop, dfn, zero),
            progress=torch.where(do_prop, h_prop * self.k,
                                 h_tgt * self.k + 1).to(F32),
            auxf=torch.where(do_prop, self.row_leader_hash(dag, prow),
                             torch.full_like(powh, D.NO_POW)))
        public = torch.where(
            do_prop,
            self.update_head(dag, state.public, idx.clamp(min=0), dag.vis_d),
            state.public)
        event = torch.where(
            has_pending, _c(target, EV_APPEND),
            torch.where(do_prop, _c(target, EV_NETWORK),
                        torch.where(attacker, _c(target, EV_POW),
                                    _c(target, EV_NETWORK))))
        return state.replace(
            dag=dag, public=public,
            private=torch.where(has_pending, state.pending_append,
                                state.private),
            event=event, pending_append=_c(target, D.NONE), time=time,
            n_activations=state.n_activations + do_mine.to(I32),
            key=ks[:, 0])

    def obs_ints(self, state: State):
        """The observation's natural-scale fields (bk_ssz.ml:225-263)."""
        dag = state.dag
        ca = self.common_ancestor(dag, state.public, state.private) \
            .clamp(min=0)
        pub_votes = self.votes_on(dag, state.public, dag.vis_d).sum(1)
        priv_inc = self.votes_on(dag, state.private).sum(1)
        priv_exc = self.votes_on(dag, state.private,
                                 dag.miner == D.ATTACKER).sum(1)
        votes_pub = self.votes_on(dag, state.public)
        leader = torch.argmin(torch.where(
            votes_pub, dag.pow_hash,
            torch.full_like(dag.pow_hash, float("inf"))), dim=1)
        lead = votes_pub.any(1) & (D.at(dag.aux, leader) == D.ATTACKER)
        hp, hv, hc = (D.at(dag.height, state.public),
                      D.at(dag.height, state.private), D.at(dag.height, ca))
        return (hp - hc, hv - hc, hv - hp, pub_votes, priv_inc, priv_exc,
                lead, state.event)

    def observe(self, state: State):
        return obslib.encode(self.fields, self.obs_ints(state),
                             self.unit_observation)

    def _apply(self, state: State, action) -> State:
        """bk_ssz.ml:265-331."""
        dag = state.dag
        k = self.k
        is_adopt = (action == ADOPT_PROLONG) | (action == ADOPT_PROCEED)
        is_override = (action == OVERRIDE_PROLONG) | \
            (action == OVERRIDE_PROCEED)
        is_match = (action == MATCH_PROLONG) | (action == MATCH_PROCEED)
        is_release = is_override | is_match
        proceed = action >= 4

        h_pub = D.at(dag.height, state.public)
        nv_pub = self.votes_on(dag, state.public, dag.vis_d).sum(1).to(I32)
        tgt_h = torch.where(is_override & (nv_pub >= k), h_pub + 1, h_pub)
        tgt_v = torch.where(is_match, nv_pub,
                            torch.where(nv_pub >= k, torch.zeros_like(nv_pub),
                                        nv_pub + 1))
        if dag.has_masks:
            blk = D.chain_first_at_most(dag, state.private, dag.height, tgt_h)
        else:
            blk = D.block_at_height(dag, state.private, tgt_h)
        blk = blk.clamp(min=0)
        child_blocks = D.children0_mask(dag, blk) & (dag.kind == BLOCK)
        has_prop = child_blocks.any(1)
        first_prop = D.first_by_age(dag, child_blocks).clamp(min=0)
        use_prop = (tgt_v >= k) & has_prop
        rel_block = torch.where(use_prop, first_prop, blk)
        rel_votes_n = torch.where(use_prop, torch.zeros_like(tgt_v), tgt_v)
        ctk = self.capacity_topk
        votes = self.votes_on(dag, rel_block)
        vidx, vvalid = D.top_k_by(dag.born_at, votes, ctk)
        take = torch.arange(ctk, device=votes.device)[None, :] \
            < rel_votes_n[:, None]
        release_all = (votes.sum(1) < rel_votes_n) | (rel_votes_n > ctk)
        vote_mask = D.mask_of(vidx, vvalid & take, self.capacity)
        vote_mask = torch.where(release_all[:, None], votes, vote_mask)

        if dag.has_masks:
            released = D.release_masked(dag, rel_block, state.time)
        else:
            released = D.release_chain(dag, rel_block, state.time)
        released = D.release(released, vote_mask, state.time)
        dag = D.select_vis(is_release, released, dag)

        public = torch.where(
            is_release,
            self.update_head(dag, state.public,
                             self.last_block(dag, rel_block), dag.vis_d),
            state.public)
        private = torch.where(is_adopt, public, state.private)
        vote_filter = torch.where(proceed[:, None], dag.exists(),
                                  dag.miner == D.ATTACKER)
        dag, prop = self.append_proposal(
            dag, private, _c(private, D.ATTACKER), vote_filter, dag.vis_a,
            state.time)
        return state.replace(dag=dag, public=public, private=private,
                             pending_append=prop)

    @property
    def capacity_topk(self):
        return min(self.capacity, 2 * self.k + 8, 16)

    def step(self, state: State, action, params):
        state = self._apply(state, action.to(I32))
        state = self._advance(state, params)
        state = state.replace(steps=state.steps + 1)
        dag = state.dag
        if self.ring:
            ca = D.common_ancestor_masked(dag, state.public, state.private)
            dag = D.retire_below(dag, D.at(dag.gid, ca.clamp(min=0)))
            state = state.replace(dag=dag)
        n_pub = self.votes_on(dag, state.public).sum(1)
        n_priv = self.votes_on(dag, state.private).sum(1)
        hp = D.at(dag.height, state.public)
        hv = D.at(dag.height, state.private)
        pub_better = (hp > hv) | ((hp == hv) & (n_pub > n_priv))
        head = torch.where(pub_better, state.public, state.private)
        return self.finish_step(
            state, params,
            reward_attacker=D.at(dag.cum_atk, head),
            reward_defender=D.at(dag.cum_def, head),
            progress=(D.at(dag.height, head) * self.k).to(F32),
            chain_time=D.at(dag.born_at, head),
            extra_done=dag.overflow)

    # -- policies (bk_ssz.ml:346-404) --------------------------------------

    def _policy_ints(self, policy_id: int, pub_b, priv_b, pub_v, priv_vi):
        k = self.k
        c = lambda v: torch.full_like(pub_b, v)  # noqa: E731
        w = torch.where
        if policy_id == 0:  # honest
            return w(pub_b > priv_b, c(ADOPT_PROCEED), c(OVERRIDE_PROCEED))
        if policy_id == 1:  # get-ahead
            return w(pub_b > priv_b, c(ADOPT_PROCEED),
                     w(pub_b < priv_b, c(OVERRIDE_PROCEED), c(WAIT_PROCEED)))
        if policy_id == 2:  # minor-delay
            return w(pub_b > priv_b, c(ADOPT_PROCEED),
                     w(pub_b == 0, c(WAIT_PROCEED), c(OVERRIDE_PROCEED)))
        if policy_id == 3:  # avoid-loss (avoid_loss_alt, bk_ssz.ml:389-400)
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
        pub_b, priv_b, _, pub_v, priv_vi, _, _, _ = self.obs_ints(state)
        return self._policy_ints(policy_id, pub_b, priv_b, pub_v.to(I32),
                                 priv_vi.to(I32))

    def _make_policies(self):
        def make(pid, name):
            def policy(obs):
                pub_b, priv_b, _, pub_v, priv_vi, _, _, _ = \
                    self.decode_obs(obs)
                return self._policy_ints(pid, pub_b, priv_b, pub_v, priv_vi)
            policy.policy_name = name
            policy.policy_owner = BkSSZ
            return policy

        return {name: make(i, name) for i, name in enumerate(POLICY_NAMES)}

    # -- kernel hooks (K10-bk) --------------------------------------------

    def kernel_config(self):
        return dict(k=self.k,
                    constant=int(self.incentive_scheme == "constant"),
                    ctk=self.capacity_topk)
