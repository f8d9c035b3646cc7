"""Tailstorm under the SSZ-like withholding attack space, on the DAG
substrate (port of cpr_tpu/envs/tailstorm.py).

Reference counterparts:
- protocol: simulator/protocols/tailstorm.ml — summaries (no PoW) over
  depth-labelled vote trees (tailstorm.ml:54-72), summary preference by
  (height, confirming votes) (183-194), reward schemes constant /
  discount / punish / hybrid (204-227), sub-block selection altruistic /
  heuristic / optimal (271-506),
- attack space: simulator/protocols/tailstorm_ssz.ml — the 10-field
  observation (22-38), Action8, release prefixes (292-314), summary
  (re-)appending with inclusive or exclusive vote filters (322-346), the
  seven policies (365-472),
- engine semantics: simulator/gym/engine.ml:97-273.

One env step processes one attacker event: a pending self-append, a
defender summary, or one mining draw. The state is a lane-batched
`core.dag.Dag`, per-lane scalars and the per-slot `stale` plane; the
functions are plain PyTorch over all lanes at once and are the
arithmetic of kernel K10-ts (`csrc/tailstorm_stream.cu`), which runs one
warp per lane in ring mode with ancestry planes over K8 and K9. The
deviations from the reference's event-queue simulation are the JAX
package's (cpr_tpu/envs/tailstorm.py:35-55).
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

# kinds
SUMMARY, VOTE = 0, 1

# events: Discrete [`Append; `ProofOfWork; `Network] (tailstorm_ssz.ml:54)
EV_APPEND, EV_POW, EV_NETWORK = 0, 1, 2

# Action8 ranks (ssz_tools.ml:230-263)
(ADOPT_PROLONG, OVERRIDE_PROLONG, MATCH_PROLONG, WAIT_PROLONG,
 ADOPT_PROCEED, OVERRIDE_PROCEED, MATCH_PROCEED, WAIT_PROCEED) = range(8)

INCENTIVE_SCHEMES = ("constant", "discount", "punish", "hybrid")
SUBBLOCK_SELECTIONS = ("altruistic", "heuristic", "optimal")
# kernel policy ids (csrc/tailstorm_stream.cu `policy`)
POLICY_NAMES = ("honest", "get-ahead", "minor-delay", "avoid-loss",
                "avoid-loss-a", "avoid-loss-b", "long-delay")


def obs_fields(k: int):
    """tailstorm_ssz.ml:41-55."""
    return (
        obslib.Field("public_blocks", obslib.UINT, scale=1),
        obslib.Field("private_blocks", obslib.UINT, scale=1),
        obslib.Field("diff_blocks", obslib.INT, scale=1),
        obslib.Field("public_votes", obslib.UINT, scale=k),
        obslib.Field("private_votes_inclusive", obslib.UINT, scale=k),
        obslib.Field("private_votes_exclusive", obslib.UINT, scale=k),
        obslib.Field("public_depth", obslib.UINT, scale=k),
        obslib.Field("private_depth_inclusive", obslib.UINT, scale=k),
        obslib.Field("private_depth_exclusive", obslib.UINT, scale=k),
        obslib.Field("event", obslib.DISCRETE, n=3),
    )


@dataclasses.dataclass
class State:
    """Per-lane env state; every field has a leading lane axis."""

    dag: D.Dag
    public: torch.Tensor  # int32, defender-preferred summary
    private: torch.Tensor  # int32, attacker-preferred summary
    event: torch.Tensor  # int32, EV_*
    pending_append: torch.Tensor  # int32, attacker summary awaiting Append
    match_tgt: torch.Tensor  # int32, live match race target summary
    def_dirty: torch.Tensor  # bool, defender gained votes since its attempt
    stale: torch.Tensor  # bool [L, B], withheld vertices abandoned at Adopt
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


# the kernels' scalar order (csrc/dag_env.cuh `EnvPtrs`): i[0..5] as bk's,
# i[6] the second slot pointer
INT_FIELDS = ("public", "private", "event", "pending_append", "steps",
              "n_activations", "match_tgt")
BOOL_FIELDS = ("def_dirty",)


def _c(ref, v, dtype=I32):
    return torch.full_like(ref, v, dtype=dtype)


def _at(plane, idx):
    """plane[lane, idx[lane]] for any idx (clamped at 0; callers guard
    the NONE case)."""
    return D.at(plane, idx.clamp(min=0))


class TailstormSSZ(DagEnv):
    n_actions = 8
    # a fresh reset = genesis + one _advance append (DagEnv.reset_dag_rows)
    scripted_policies = POLICY_NAMES
    state_cls = State
    int_fields = INT_FIELDS
    bool_fields = BOOL_FIELDS
    plane_fields = ("stale",)
    kernel_name, kernel_lib = "K10-ts", "ts"

    def __init__(self, k: int = 8, incentive_scheme: str = "discount",
                 subblock_selection: str = "heuristic",
                 unit_observation: bool = True, max_steps_hint: int = 256,
                 release_scan: int = 128, window: int | None = None,
                 anc_masks: bool | None = None):
        assert incentive_scheme in INCENTIVE_SCHEMES
        assert subblock_selection in SUBBLOCK_SELECTIONS
        self.k = k
        self.incentive_scheme = incentive_scheme
        self.subblock_selection = subblock_selection
        if subblock_selection == "optimal":
            self.opt_window = Q.optimal_window(k, 4 * k + 16)
            self.opt_combos = Q.optimal_combos(k, self.opt_window)
        self.unit_observation = unit_observation
        self.max_parents = k
        self.D_MAX = 3 * k + 8
        self.C_MAX = 4 * k + 16
        self.capacity = max(2 * max_steps_hint + 8, self.C_MAX)
        if window is not None:
            self.capacity = max(window, self.C_MAX)
        self.ring = window is not None
        self.anc_masks = self.ring if anc_masks is None else anc_masks
        assert self.anc_masks or not self.ring, \
            "ring windows require anc_masks (walks could cross reclaimed slots)"
        self.lift = False
        self.STALE_WALK = 4
        assert self.C_MAX < (1 << 8), "composite sort keys use 8 bits"
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

    # -- protocol primitives (tailstorm.ml) --------------------------------

    def confirming(self, dag, s, extra_mask=None):
        """[L, B] votes confirming summary s (tailstorm.ml:151-154)."""
        m = (dag.exists() & (dag.kind == VOTE) & (dag.signer == s[:, None])
             & D.newer_than(dag, s))
        if extra_mask is not None:
            m = m & extra_mask
        return m

    def last_summary(self, dag, x):
        """tailstorm.ml:113-121."""
        return torch.where(_at(dag.kind, x) == SUMMARY, x, _at(dag.signer, x))

    def last_summary_all(self, dag):
        """[L, B] last_summary of every slot (Q.last_of_kind_all)."""
        return Q.last_of_kind_all(dag, SUMMARY)

    def prev_summary(self, dag, s):
        """The summary before s on the chain (cached in aux2), NONE at
        genesis."""
        return _at(dag.aux2, s)

    def summary_lca(self, dag, a, b):
        """Common ancestor along the summary chain (dagtools.ml:102-121):
        one chain-row intersection with ancestry planes, else the
        height-synchronized walk over the cached prev-summary pointers."""
        if dag.has_masks:
            return D.common_ancestor_masked(dag, a, b).clamp(min=0)
        x, y = a.clone(), b.clone()
        while True:
            live = (x != y) & (x >= 0) & (y >= 0)
            if not bool(live.any()):
                return x.clamp(min=0)
            hx, hy = _at(dag.height, x), _at(dag.height, y)
            nx = torch.where(hx >= hy, self.prev_summary(dag, x), x)
            ny = torch.where(hy >= hx, self.prev_summary(dag, y), y)
            x, y = torch.where(live, nx, x), torch.where(live, ny, y)

    def vote_ancestors(self, dag, starts):
        """[L, C, D_MAX] vote paths (tailstorm.py:231-247): row i lists
        starts[:, i] and its vote ancestors up to, excluding, the summary,
        NONE-padded (the vectorized `acc_votes parents [x]`,
        tailstorm.ml:134-149)."""
        def vote_at(x):
            return dag.kind.gather(1, x.clamp(min=0).long()) == VOTE

        cur = torch.where((starts >= 0) & vote_at(starts), starts,
                          torch.full_like(starts, D.NONE))
        cols = []
        for _ in range(self.D_MAX):
            cols.append(cur)
            nxt = dag.parent0.gather(1, cur.clamp(min=0).long())
            ok = (cur >= 0) & (nxt >= 0) & vote_at(nxt)
            cur = torch.where(ok, nxt, torch.full_like(cur, D.NONE))
        return torch.stack(cols, 2)

    def closure_counts(self, anc, masks):
        """[L, C, M] counts of the masked vertices along each vote path;
        `masks` [L, B, M] bool, `anc` from `vote_ancestors`."""
        L, B, M = masks.shape
        pad = torch.cat([masks, torch.zeros((L, 1, M), dtype=masks.dtype,
                                            device=masks.device)], 1)
        idx = torch.where(anc >= 0, anc, torch.full_like(anc, B)).long()
        rows = pad.gather(1, idx.reshape(L, -1, 1).expand(-1, -1, M))
        return rows.reshape(*anc.shape, M).sum(2).to(I32)

    def mark_closure(self, anc_row, mask, on=True):
        """mask [L, B] | the vote path anc_row [L, D_MAX], where `on` (a
        bool or [L])."""
        on = torch.as_tensor(on, device=mask.device)
        valid = (anc_row >= 0) & (on[:, None] if on.dim() else on)
        slots = torch.arange(mask.shape[1], device=mask.device)
        hit = (anc_row[:, :, None] == slots) & valid[:, :, None]
        return mask | hit.any(1)

    def own_reward(self, dag, s, my):
        """The summary's own coinbase share for party `my` (auxf attacker,
        auxg defender)."""
        return torch.where(my == D.ATTACKER, _at(dag.auxf, s),
                           _at(dag.auxg, s))

    def cmp_summaries(self, dag, x, y, vote_filter_mask, my):
        """compare_blocks (tailstorm.ml:539-549): height, filtered
        confirming votes, own reward; x strictly preferred."""
        return Q.prefers(dag, x, y, vote_filter_mask,
                         lambda s: self.own_reward(dag, s, my))

    def update_head(self, dag, old, candidate, vote_filter_mask, my):
        better = self.cmp_summaries(dag, candidate, old, vote_filter_mask, my)
        return torch.where(better, candidate, old)

    def leaf_score(self, dag):
        """depth - hash, the vote order inside a summary."""
        return dag.aux.to(F32) - dag.pow_hash

    vote_order = leaf_score

    # -- quorum selection ---------------------------------------------------

    def quorum(self, dag, b, voter, vote_filter_mask, view_mask):
        """k sub-blocks confirming b: (found, parents row [L, k], frame,
        leaves_c)."""
        cand = self.confirming(dag, b) & vote_filter_mask & view_mask
        own = dag.miner == voter[:, None]
        f = Q.candidate_frame(dag, cand, self.C_MAX, VOTE)
        score = self.leaf_score(dag)
        if self.subblock_selection == "altruistic":
            seen = torch.where((voter == D.ATTACKER)[:, None], dag.born_at,
                               dag.vis_d_since)
            n, _, leaves_c, n_cand = Q.quorum_altruistic(f, own, seen,
                                                         dag.aux, self.k)
            found = (n == self.k) & (n_cand >= self.k)
        elif self.subblock_selection == "optimal":
            found, leaves_c = Q.quorum_optimal_or_heuristic(
                f, own, dag.aux, self.k, self.opt_window, self.opt_combos,
                k=self.k, discount=self.discount, punish=self.punish,
                depth_plus=0, leaf_score=score, miner_share=0)
        else:
            found, leaves_c = Q.quorum_heuristic(f, own, self.k)
        row = Q.leaves_to_row(dag, f, leaves_c, self.k, score)
        return found, row, f, leaves_c

    def summary_reward(self, dag, row, f, leaves_c):
        """Coinbase of a summary draft (tailstorm.ml:204-227) on the
        candidate frame."""
        L = dag.n_lanes
        if self.punish:
            score_c = torch.where(f.cvalid, f.gather(self.leaf_score(dag)),
                                  torch.full_like(f.cvalid, -float("inf"),
                                                  dtype=F32))
            j = torch.argmax(torch.where(leaves_c, score_c,
                                         torch.full_like(score_c,
                                                         -float("inf"))),
                             dim=1)
            sel = f.abits[torch.arange(L, device=dag.device), j] \
                & leaves_c.any(1)[:, None]
        else:
            sel = (leaves_c[:, :, None] & f.abits).any(1)
        own_att = f.gather(dag.miner == D.ATTACKER) > 0.5
        own_def = f.gather(dag.miner == D.DEFENDER) > 0.5
        depth0 = _at(dag.aux, row[:, 0])
        r = (Q.fdiv(depth0, self.k) if self.discount
             else torch.ones(L, dtype=F32, device=dag.device))
        atk = r * (sel & own_att).sum(1).to(F32)
        dfn = r * (sel & own_def).sum(1).to(F32)
        return atk, dfn

    def append_summary(self, dag, b, voter, vote_filter_mask, view_mask,
                       time, cond=None):
        """Append the next summary on b where a quorum exists and no
        identical summary does (tailstorm.ml:530-537, simulator.ml:138-158);
        `cond` gates the append per lane. Returns (dag, idx_or_dup_or_NONE,
        fresh)."""
        found, row, f, leaves_c = self.quorum(dag, b, voter,
                                              vote_filter_mask, view_mask)
        atk, dfn = self.summary_reward(dag, row, f, leaves_c)
        height = _at(dag.height, b) + 1
        row_eq = dag.parents[0] == row[:, 0:1]
        for p in range(1, dag.max_parents):
            row_eq = row_eq & (dag.parents[p] == row[:, p:p + 1])
        dup_mask = (dag.exists() & (dag.kind == SUMMARY)
                    & (dag.height == height[:, None]) & row_eq
                    & D.newer_than(dag, b))
        dup = torch.where(dup_mask.any(1),
                          torch.argmax(dup_mask.to(torch.int8), dim=1).to(I32),
                          _c(b, D.NONE))
        fresh = found & (dup < 0)
        if cond is not None:
            fresh = fresh & cond
        dag, idx = D.append_if(
            dag, fresh, row, kind=SUMMARY, height=height, aux=0,
            signer=D.NONE, miner=voter, vis_a=True,
            vis_d=(voter == D.DEFENDER), time=time, reward_atk=atk,
            reward_def=dfn, progress=(height * self.k).to(F32),
            auxf=atk, auxg=dfn, aux2=b, chain_parent=b)
        out = torch.where(fresh, idx, torch.where(found, dup, _c(b, D.NONE)))
        return dag, out, fresh

    def mine_vote(self, dag, pref, voter, view_mask, time, pow_hash, cond):
        """puzzle_payload (tailstorm.ml:509-528): a vote on the deepest
        visible branch confirming `pref`, on the lanes of `cond`."""
        cand = self.confirming(dag, pref, view_mask)
        has = cand.any(1)
        score = torch.where(cand, self.leaf_score(dag),
                            torch.full_like(dag.pow_hash, -float("inf")))
        parent = torch.where(has, torch.argmax(score, dim=1).to(I32), pref)
        depth = torch.where(has, _at(dag.aux, parent) + 1, _c(pref, 1))
        height = _at(dag.height, pref)
        row = torch.full((dag.n_lanes, dag.max_parents), D.NONE, dtype=I32,
                         device=dag.device)
        row[:, 0] = parent
        return D.append_if(
            dag, cond, row, kind=VOTE, height=height, aux=depth,
            pow_hash=pow_hash, signer=pref, miner=voter, vis_a=True,
            vis_d=(voter == D.DEFENDER), time=time,
            progress=(height * self.k + depth).to(F32))

    # -- env API ------------------------------------------------------------

    def reset(self, keys, params):
        n, dev = keys.shape[0], keys.device
        dag = D.empty(n, self.capacity, self.max_parents, ring=self.ring,
                      anc_masks=self.anc_masks, device=dev)
        dag, root = D.append(
            dag, torch.full((n, self.max_parents), D.NONE, dtype=I32,
                            device=dev),
            kind=SUMMARY, height=0, miner=D.NONE, vis_a=True, vis_d=True,
            time=0.0, progress=0.0)
        z = torch.zeros(n, dtype=I32, device=dev)
        f = torch.zeros(n, dtype=F32, device=dev)
        state = State(
            dag=dag, public=root, private=root.clone(),
            event=z + EV_POW, pending_append=z + D.NONE, match_tgt=z + D.NONE,
            def_dirty=torch.zeros(n, dtype=torch.bool, device=dev),
            stale=torch.zeros((n, self.capacity), dtype=torch.bool,
                              device=dev),
            time=f, steps=z.clone(), n_activations=z.clone(),
            last_reward_attacker=f.clone(), last_reward_defender=f.clone(),
            last_progress=f.clone(), last_chain_time=f.clone(),
            last_sim_time=f.clone(), key=keys.clone())
        state = self._advance(state, params)
        return state, self.observe(state)

    def _advance(self, state: State, params) -> State:
        """tailstorm.py:443-536: the pending self-append, else a fresh
        defender summary, else (after adopting a duplicate summary) one
        mining draw. The key splits in five, and draws, only where a lane
        mines."""
        dag = state.dag
        att = _c(state.public, D.ATTACKER)
        dfd = _c(state.public, D.DEFENDER)
        has_pending = state.pending_append >= 0
        private = torch.where(
            has_pending,
            self.update_head(dag, state.private,
                             state.pending_append.clamp(min=0), dag.vis_a,
                             att),
            state.private)

        try_def = ~has_pending & state.def_dirty
        dag, s, fresh = self.append_summary(
            dag, state.public, dfd, dag.vis_d, dag.vis_d, state.time,
            cond=try_def)
        announced = try_def & fresh
        dup = try_def & ~fresh & (s >= 0)
        si = s.clamp(min=0)
        public = torch.where(
            announced, self.update_head(dag, state.public, si, dag.vis_d,
                                        dfd), state.public)
        stale = state.stale.clone()
        ln = D.lanes(dag)
        stale[ln, si] = torch.where(announced, torch.zeros_like(announced),
                                    stale[ln, si])
        vis_d = dag.vis_d.clone()
        vis_d[ln, si] = vis_d[ln, si] | dup
        dag = dag.replace(vis_d=vis_d)
        public = torch.where(
            dup, self.update_head(dag, public, si, dag.vis_d, dfd), public)

        mine = ~has_pending & ~announced
        def_dirty = torch.where(try_def, torch.zeros_like(try_def),
                                state.def_dirty)
        ks = random.threefry_plain(state.key, 5)  # [L, 5, 2]
        bits = random.threefry_plain(ks[:, 1:], 1, 0, random.MODE_BITS)[..., 0]
        dt = random.exponential_of_bits(bits[:, 0]) * params.activation_delay
        time = torch.where(mine, state.time + dt, state.time)
        attacker = random.uniform_of_bits(bits[:, 1]) < params.alpha
        powh = random.uniform_of_bits(bits[:, 2])
        tgt = state.match_tgt.clamp(min=0)
        still_tie = (~self.cmp_summaries(dag, public, tgt, dag.vis_d, dfd)
                     & ~self.cmp_summaries(dag, tgt, public, dag.vis_d, dfd))
        gamma_hit = (~attacker & (state.match_tgt >= 0) & still_tie
                     & (random.uniform_of_bits(bits[:, 3]) < params.gamma))
        public_m = torch.where(gamma_hit, tgt, public)
        match_tgt = torch.where(attacker, state.match_tgt,
                                _c(tgt, D.NONE))
        voter = torch.where(attacker, att, dfd)
        pref = torch.where(attacker, private, public_m)
        view = torch.where(attacker[:, None], dag.vis_a, dag.vis_d)
        dag, vidx = self.mine_vote(dag, pref, voter, view, time, powh, mine)
        vi = vidx.clamp(min=0)
        stale[ln, vi] = stale[ln, vi] & ~mine
        event = torch.where(
            has_pending, _c(tgt, EV_APPEND),
            torch.where(announced, _c(tgt, EV_NETWORK),
                        torch.where(attacker, _c(tgt, EV_POW),
                                    _c(tgt, EV_NETWORK))))
        return state.replace(
            dag=dag, private=private,
            public=torch.where(mine, public_m, public),
            match_tgt=torch.where(mine, match_tgt, state.match_tgt),
            event=event,
            pending_append=torch.where(has_pending, _c(tgt, D.NONE),
                                       state.pending_append),
            def_dirty=torch.where(mine, def_dirty | ~attacker, def_dirty),
            stale=stale, time=time,
            n_activations=state.n_activations + mine.to(I32),
            key=torch.where(mine[:, None], ks[:, 0], state.key))

    def obs_ints(self, state: State):
        """tailstorm_ssz.ml:262-290: the observation's natural-scale
        fields."""
        dag = state.dag
        ca = self.summary_lca(dag, state.public, state.private)

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
        dfd = _c(state.public, D.DEFENDER)

        def cmp(dag_, x, y, mask):
            return self.cmp_summaries(dag_, x, y, mask, dfd)

        cands = dag.exists() & ~dag.vis_d & ~state.stale
        return Q.prefix_release_sets(
            dag, state.public, state.private, cands, self.release_scan,
            self.last_summary_all(dag), cmp, extra_all=dag.auxg)

    def _apply(self, state: State, action) -> State:
        """tailstorm_ssz.ml:292-350."""
        dag = state.dag
        is_adopt = (action == ADOPT_PROLONG) | (action == ADOPT_PROCEED)
        is_override = (action == OVERRIDE_PROLONG) | \
            (action == OVERRIDE_PROCEED)
        is_match = (action == MATCH_PROLONG) | (action == MATCH_PROCEED)
        is_release = is_override | is_match
        proceed = action >= 4

        override_set, match_set, found, new_head = self._release_sets(state)
        mask = torch.where(is_override[:, None], override_set,
                           match_set & is_match[:, None])
        released = D.release(dag, mask, state.time)
        dag = D.select_vis(is_release, released, dag)
        public = torch.where(is_override & found, new_head, state.public)
        private = torch.where(is_adopt, public, state.private)
        def_dirty = state.def_dirty | (is_release & mask.any(1))
        stale = Q.stale_after_adopt(
            dag, public, state.stale, is_adopt, self.release_scan,
            self.STALE_WALK, self.last_summary_all(dag),
            lambda d, i: d.aux2.gather(1, i.long()))
        rel_tip = D.last_by_age(dag, match_set)
        match_tgt = torch.where(
            is_match & found & (rel_tip >= 0),
            self.last_summary(dag, rel_tip.clamp(min=0)),
            torch.where(is_adopt | is_override, _c(rel_tip, D.NONE),
                        state.match_tgt))
        vote_filter = torch.where(proceed[:, None], dag.exists(),
                                  dag.miner == D.ATTACKER)
        has_conf = self.confirming(dag, state.private).any(1)
        prev = self.prev_summary(dag, state.private)
        extend = torch.where(has_conf | (prev < 0), state.private, prev)
        dag, pending, fresh = self.append_summary(
            dag, extend, _c(extend, D.ATTACKER), vote_filter, dag.vis_a,
            state.time)
        pi = pending.clamp(min=0)
        ln = D.lanes(dag)
        stale = stale.clone()
        stale[ln, pi] = stale[ln, pi] & ~fresh
        pending = torch.where(fresh, pending, _c(pending, D.NONE))
        return state.replace(dag=dag, public=public, private=private,
                             match_tgt=match_tgt, def_dirty=def_dirty,
                             stale=stale, pending_append=pending)

    def step(self, state: State, action, params):
        state = self._apply(state, action.to(I32))
        state = self._advance(state, params)
        state = state.replace(steps=state.steps + 1)
        dag = state.dag
        if self.ring:
            # retire below the summary one behind the fork's LCA
            # (tailstorm.py:640-656)
            lca = self.summary_lca(dag, state.public, state.private)
            prev = self.prev_summary(dag, lca)
            anchor = torch.where(prev >= 0, prev, lca)
            dag = D.retire_below(dag, D.at(dag.gid, anchor))
            state = state.replace(
                dag=dag, match_tgt=D.drop_if_retired(dag, state.match_tgt))
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

    # -- policies (tailstorm_ssz.ml:365-472) --------------------------------

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
        if policy_id in (3, 5):  # avoid-loss, avoid-loss-b
            match = MATCH_PROCEED if policy_id == 3 else OVERRIDE_PROCEED
            hp = pub_b * k + pub_v
            ap = priv_b * k + priv_vi
            return w(pub_b == 0, c(WAIT_PROCEED),
                     w((pub_b == 1) & (hp == ap), c(match),
                       w(hp > ap, c(ADOPT_PROCEED),
                         w(hp == ap - 1, c(OVERRIDE_PROCEED),
                           w(pub_b < priv_b - 10, c(OVERRIDE_PROCEED),
                             c(WAIT_PROCEED))))))
        if policy_id == 4:  # avoid-loss-a (tailstorm_ssz.ml:407-422)
            return w(priv_b < pub_b, c(ADOPT_PROCEED),
                     w(pub_b == 0, c(WAIT_PROCEED),
                       w((priv_vi == 0) & (priv_b == pub_b + 1),
                         c(OVERRIDE_PROCEED),
                         w((pub_b == priv_b) & (priv_vi == pub_v + 1),
                           c(OVERRIDE_PROCEED),
                           w(priv_b - pub_b > 10, c(OVERRIDE_PROCEED),
                             c(WAIT_PROCEED))))))
        if policy_id == 6:  # long-delay
            return w(pub_b > priv_b, c(ADOPT_PROCEED),
                     w(pub_b == 0, c(WAIT_PROCEED),
                       w(pub_b + 10 < priv_b, c(OVERRIDE_PROCEED),
                         w(pub_b * k + pub_v + 1 < priv_b * k + priv_vi,
                           c(WAIT_PROCEED), c(OVERRIDE_PROCEED)))))
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
                                   self.release_scan, self.k)

    # -- kernel hooks (K10-ts) ----------------------------------------------

    def kernel_config(self):
        sel = SUBBLOCK_SELECTIONS.index(self.subblock_selection)
        return dict(k=self.k, scheme=INCENTIVE_SCHEMES.index(
            self.incentive_scheme), selection=sel, cmax=self.C_MAX,
            rscan=self.release_scan,
            opt_window=getattr(self, "opt_window", 0))
