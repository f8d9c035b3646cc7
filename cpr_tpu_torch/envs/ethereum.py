"""Ethereum PoW (uncle blocks) under the SSZ-like withholding attack
space, on the DAG substrate (port of cpr_tpu/envs/ethereum.py).

Reference counterparts:
- protocol: simulator/protocols/ethereum.ml — blocks with <= 2 uncles
  (Byzantium) or unbounded uncles (Whitepaper), uncle validity within 6
  generations (ethereum.ml:102-151), honest uncle selection with
  own-first, oldest-first preference (ethereum.ml:226-279), constant and
  discount reward schemes (ethereum.ml:174-198),
- attack space: simulator/protocols/ethereum_ssz.ml — the 10-field
  observation, actions {Adopt_discard, Adopt_release, Override, Match,
  Release1, Wait} x uncle mining rule {own, foreign}, the five policies
  (ethereum_ssz.ml:444-538),
- engine semantics: simulator/gym/engine.ml:97-273.

Parent slot 0 is the chain parent; slots 1..U hold uncle references.
One env step is one attacker action plus one Bernoulli(alpha) mining
draw (and the gamma race draw). The functions below are plain PyTorch
over all lanes at once and are the arithmetic of kernel K10-eth
(`csrc/ethereum_stream.cu`, ring mode with ancestry planes, one warp per
lane). The deviations from the reference are the JAX package's
(cpr_tpu/envs/ethereum.py:29-43).
"""

from __future__ import annotations

import dataclasses

import torch

from cpr_tpu_torch import obs as obslib
from cpr_tpu_torch import random
from cpr_tpu_torch.core import dag as D
from cpr_tpu_torch.envs.base import DagEnv

I32, F32 = torch.int32, torch.float32

# events: Discrete [`ProofOfWork; `Network] (ethereum_ssz.ml:39)
EV_POW, EV_NETWORK = 0, 1

# action ranks (ethereum_ssz.ml:172-221, declaration order)
ADOPT_DISCARD, ADOPT_RELEASE, OVERRIDE, MATCH, RELEASE1, WAIT = range(6)
# uncle mining rules, index = own * 2 + foreign (ethereum_ssz.ml:238-241)
N_UNCLE_RULES = 4

OBS_FIELDS = (
    obslib.Field("public_height", obslib.UINT, scale=1),
    obslib.Field("public_work", obslib.UINT, scale=1),
    obslib.Field("private_height", obslib.UINT, scale=1),
    obslib.Field("private_work", obslib.UINT, scale=1),
    obslib.Field("diff_height", obslib.INT, scale=1),
    obslib.Field("diff_work", obslib.INT, scale=1),
    obslib.Field("public_orphans", obslib.UINT, scale=1),
    obslib.Field("private_orphans_inclusive", obslib.UINT, scale=1),
    obslib.Field("private_orphans_exclusive", obslib.UINT, scale=1),
    obslib.Field("event", obslib.DISCRETE, n=2),
)

UNCLE_WINDOW = 6  # generations (ethereum.ml:112, 124-127)

# kernel policy ids (csrc/ethereum_stream.cu `policy`)
POLICY_NAMES = ("honest", "selfish_release", "selfish_discard", "fn19",
                "fn19pkel")


@dataclasses.dataclass
class State:
    """Per-lane env state; every field has a leading lane axis."""

    dag: D.Dag
    public: torch.Tensor  # int32, defender cloud's preferred block
    private: torch.Tensor  # int32, attacker's preferred block
    event: torch.Tensor  # int32, EV_POW | EV_NETWORK
    race_tip: torch.Tensor  # int32, released tip of a live tie race (-1)
    mining_own: torch.Tensor  # bool, current uncle mining rule
    mining_foreign: torch.Tensor  # bool
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
INT_FIELDS = ("public", "private", "event", "race_tip", "steps",
              "n_activations")
BOOL_FIELDS = ("mining_own", "mining_foreign")


def _c(ref, v, dtype=I32):
    return torch.full_like(ref, v, dtype=dtype)


class EthereumSSZ(DagEnv):
    """Ethereum withholding attack env, one step per attacker interaction."""

    n_actions = 6 * N_UNCLE_RULES
    obs_fields = OBS_FIELDS
    observation_length = len(OBS_FIELDS)
    scripted_policies = POLICY_NAMES
    state_cls = State
    int_fields = INT_FIELDS
    bool_fields = BOOL_FIELDS
    kernel_name, kernel_lib = "K10-eth", "eth"

    def __init__(self, preset: str = "byzantium", *,
                 preference: str | None = None, progress: str | None = None,
                 max_uncles: int | None = None,
                 incentive_scheme: str | None = None,
                 uncle_cap: int = 6, unit_observation: bool = True,
                 strict_match: bool = True, max_steps_hint: int = 256,
                 window: int | None = None,
                 anc_masks: bool | None = None):
        if preset == "whitepaper":
            defaults = dict(preference="work", progress="height",
                            max_uncles=None, incentive_scheme="constant")
        elif preset == "byzantium":
            defaults = dict(preference="height", progress="work",
                            max_uncles=2, incentive_scheme="discount")
        else:
            raise ValueError(f"unknown preset {preset!r}")
        self.preset = preset
        self.preference = preference or defaults["preference"]
        self.progress = progress or defaults["progress"]
        mu = max_uncles if max_uncles is not None else defaults["max_uncles"]
        self.max_uncles = min(mu, uncle_cap) if mu is not None else uncle_cap
        self.incentive_scheme = (incentive_scheme
                                 or defaults["incentive_scheme"])
        assert self.preference in ("height", "work")
        assert self.progress in ("height", "work")
        assert self.incentive_scheme in ("constant", "discount")
        self.unit_observation = unit_observation
        self.fields = OBS_FIELDS
        self.strict_match = strict_match
        self.capacity = max_steps_hint + 8
        if window is not None:
            self.capacity = max(window, UNCLE_WINDOW + 10)
        self.ring = window is not None
        self.anc_masks = self.ring if anc_masks is None else anc_masks
        assert self.anc_masks or not self.ring, \
            "ring windows require anc_masks (walks could cross reclaimed slots)"
        self.lift = not self.anc_masks
        self.max_parents = 1 + self.max_uncles
        self.low, self.high = obslib.low_high(OBS_FIELDS, unit_observation)
        self.policies = self._make_policies()

    # -- protocol primitives (ethereum.ml) ---------------------------------

    def pref_all(self, dag):
        return dag.height if self.preference == "height" else dag.aux

    def pref(self, dag, b):
        """Preference value of block b (ethereum.ml:80-84; aux = work)."""
        return D.at(self.pref_all(dag), b)

    def progress_of(self, dag, b):
        plane = dag.height if self.progress == "height" else dag.aux
        return D.at(plane, b).to(F32)

    def chain_window(self, dag, head):
        """(ancestors, in_chain) for the uncle window at `head`
        (ethereum.py:181-214): the up-to-6 proper chain ancestors [L, 6]
        (-1 past the walk) and the [L, B] mask of head, the walked
        blocks and their included uncles. Each level reads the walked
        block's whole parent row at once."""
        slots = dag.slots()[None, None, :]
        rows_all = torch.stack(dag.parents, 1)  # [L, P, B]
        P = rows_all.shape[1]
        in_chain = (slots[:, 0] == head.clamp(min=0)[:, None]) \
            & (head >= 0)[:, None]
        ancestors = []
        b = head
        for _ in range(UNCLE_WINDOW):
            bi = b.clamp(min=0)
            row = rows_all.gather(2, bi.long()[:, None, None].expand(
                -1, P, 1))[..., 0]  # [L, P]
            p0 = row[:, 0]
            has = (b >= 0) & (p0 >= 0)
            ancestors.append(torch.where(has, p0, torch.full_like(p0, -1)))
            ok = (row >= 0) & has[:, None]
            if dag.is_ring:
                g = dag.gid.gather(1, row.clamp(min=0).long())
                ok = ok & (g <= D.at(dag.gid, bi)[:, None])
            in_chain = in_chain | ((slots == row[:, :, None])
                                   & ok[:, :, None]).any(1)
            b = ancestors[-1]
        return torch.stack(ancestors, 1), in_chain

    def uncle_candidates(self, dag, head, view_mask, filter_mask,
                         window=None):
        """[L, B] includable uncles for a block on `head`
        (ethereum.ml:252-268)."""
        ancestors, in_chain = window or self.chain_window(dag, head)
        p0 = dag.parent0
        # newer_than each ancestor: a stale row's p0 aliasing a reclaimed
        # ancestor slot must not read as a candidate (ring wrap)
        on = (p0[:, :, None] == ancestors[:, None, :]) \
            & (ancestors >= 0)[:, None, :]
        if dag.is_ring:
            ga = dag.gid.gather(1, ancestors.clamp(min=0).long())
            on = on & (dag.gid[:, :, None] > ga[:, None, :])
        return (dag.exists() & view_mask & filter_mask & (p0 >= 0)
                & on.any(2) & ~in_chain)

    def select_uncles(self, dag, cand_mask, own_mask):
        """Top max_uncles candidates by (own first, lowest preference
        first) (ethereum.ml:226-232)."""
        score = (torch.where(own_mask, 0.0, 1e7).to(F32)
                 + self.pref_all(dag).to(F32))
        return D.top_k_by(score, cand_mask, self.max_uncles)

    def make_block(self, dag, head, view_mask, filter_mask, miner, time,
                   vis_d):
        """Append a block on `head` with its selected uncles, work, height
        and rewards (ethereum.ml:174-198, 270-277)."""
        cand = self.uncle_candidates(dag, head, view_mask, filter_mask)
        own = dag.miner == miner[:, None]
        uidx, uvalid = self.select_uncles(dag, cand, own)
        n_uncles = uvalid.sum(1).to(I32)
        height = D.at(dag.height, head) + 1
        work = D.at(dag.aux, head) + 1 + n_uncles
        uc = uidx.clamp(min=0).long()
        u_miner = dag.miner.gather(1, uc)
        zero = torch.zeros(uidx.shape, dtype=F32, device=uidx.device)
        if self.incentive_scheme == "constant":
            u_reward = torch.where(uvalid, zero + 0.9375, zero)
        else:
            delta = (height[:, None] - dag.height.gather(1, uc)).to(F32)
            u_reward = torch.where(uvalid, (8.0 - delta) / 8.0, zero)
        miner_reward = 1.0 + n_uncles.to(F32) * 0.03125
        z1 = torch.zeros_like(miner_reward)
        atk = (torch.where(u_miner == D.ATTACKER, u_reward, zero).sum(1)
               + torch.where(miner == D.ATTACKER, miner_reward, z1))
        dfn = (torch.where(u_miner == D.DEFENDER, u_reward, zero).sum(1)
               + torch.where(miner == D.DEFENDER, miner_reward, z1))
        row = torch.cat([head[:, None].to(I32),
                         torch.where(uvalid, uidx, _c(uidx, D.NONE))], 1)
        return D.append(
            dag, row, kind=0, height=height, aux=work, miner=miner,
            vis_a=True, vis_d=vis_d, time=time, reward_atk=atk,
            reward_def=dfn,
            progress=(height if self.progress == "height" else work).to(F32))

    def update_head(self, dag, old, candidate):
        """Strict preference improvement (ethereum.ml:281-285)."""
        better = self.pref(dag, candidate) > self.pref(dag, old)
        return torch.where(better, candidate, old)

    def common_ancestor(self, dag, a, b):
        if dag.has_masks:
            return D.common_ancestor_masked(dag, a, b)
        return D.common_ancestor_by_height(dag, a, b)

    # -- env API -----------------------------------------------------------

    def reset(self, keys, params):
        n, dev = keys.shape[0], keys.device
        dag = D.empty(n, self.capacity, self.max_parents,
                      anc_masks=self.anc_masks, lift=self.lift,
                      ring=self.ring, device=dev)
        dag, root = D.append(
            dag, torch.full((n, self.max_parents), D.NONE, dtype=I32,
                            device=dev),
            kind=0, height=0, aux=0, miner=D.NONE, vis_a=True, vis_d=True,
            time=0.0, progress=0.0)
        z = torch.zeros(n, dtype=I32, device=dev)
        f = torch.zeros(n, dtype=F32, device=dev)
        t = torch.ones(n, dtype=torch.bool, device=dev)
        state = State(
            dag=dag, public=root, private=root.clone(), event=z + EV_POW,
            race_tip=z - 1, mining_own=t, mining_foreign=t.clone(),
            time=f, steps=z.clone(), n_activations=z.clone(),
            last_reward_attacker=f.clone(), last_reward_defender=f.clone(),
            last_progress=f.clone(), last_chain_time=f.clone(),
            last_sim_time=f.clone(), key=keys.clone())
        state = self._mine(state, params)
        return state, self.observe(state)

    def _mine(self, state: State, params) -> State:
        """One activation (simulator.ml:465-472 collapsed): Bernoulli(alpha)
        miner; the defender cloud splits by gamma while a preference-tie
        race is live (ethereum.py:327-367)."""
        dag = state.dag
        ks = random.threefry_plain(state.key, 4)  # [L, 4, 2]
        bits = random.threefry_plain(ks[:, 1:], 1, 0, random.MODE_BITS)[..., 0]
        dt = random.exponential_of_bits(bits[:, 0]) * params.activation_delay
        time = state.time + dt
        attacker_mines = random.uniform_of_bits(bits[:, 1]) < params.alpha
        gamma_hit = random.uniform_of_bits(bits[:, 2]) < params.gamma

        rt = state.race_tip.clamp(min=0)
        race_live = (state.race_tip >= 0) & (
            self.pref(dag, rt) == self.pref(dag, state.public))
        def_parent = torch.where(race_live & gamma_hit, rt, state.public)
        no = torch.zeros_like(dag.vis_a)
        atk_filter = (torch.where(state.mining_own[:, None],
                                  dag.miner == D.ATTACKER, no)
                      | torch.where(state.mining_foreign[:, None],
                                    dag.miner == D.DEFENDER, no))
        am = attacker_mines[:, None]
        head = torch.where(attacker_mines, state.private, def_parent)
        view = torch.where(am, dag.vis_a, dag.vis_d)
        filt = torch.where(am, atk_filter, dag.exists())
        miner = torch.where(attacker_mines, _c(head, D.ATTACKER),
                            _c(head, D.DEFENDER))
        dag, blk = self.make_block(dag, head, view, filt, miner, time,
                                   vis_d=~attacker_mines)
        private = torch.where(attacker_mines, blk, state.private)
        public = torch.where(attacker_mines, state.public,
                             self.update_head(dag, state.public, blk))
        race_tip = torch.where(attacker_mines, state.race_tip,
                               _c(head, -1))
        return state.replace(
            dag=dag, private=private, public=public, race_tip=race_tip,
            event=torch.where(attacker_mines, _c(head, EV_POW),
                              _c(head, EV_NETWORK)),
            time=time, n_activations=state.n_activations + 1, key=ks[:, 0])

    def _release_upto(self, dag, private, target):
        """First block back from `private` with preference <= target
        (ethereum_ssz.ml:404-412)."""
        if dag.has_masks:
            return D.chain_first_at_most(dag, private, self.pref_all(dag),
                                         target)
        return D.walk_back(dag, private,
                           lambda d, i: self.pref(d, i) <= target)

    def _apply(self, state: State, action) -> State:
        """ethereum_ssz.ml:398-429."""
        dag = state.dag
        act = torch.div(action, N_UNCLE_RULES, rounding_mode="floor")
        uncle_rule = torch.remainder(action, N_UNCLE_RULES)
        mining_own = uncle_rule >= 2
        mining_foreign = (uncle_rule % 2) == 1
        is_adopt = (act == ADOPT_DISCARD) | (act == ADOPT_RELEASE)
        pub_pref = self.pref(dag, state.public)
        ca = self.common_ancestor(dag, state.public, state.private) \
            .clamp(min=0)
        target = torch.where(
            act == MATCH, pub_pref,
            torch.where(act == OVERRIDE, pub_pref + 1,
                        torch.where(act == RELEASE1, self.pref(dag, ca) + 1,
                                    torch.full_like(pub_pref, 1 << 30))))
        release_tip = torch.where(
            act == ADOPT_RELEASE, state.private,
            self._release_upto(dag, state.private, target))
        do_release = (act == ADOPT_RELEASE) | (act == OVERRIDE) \
            | (act == MATCH) | (act == RELEASE1)
        release_tip = torch.where(do_release, release_tip,
                                  torch.full_like(release_tip, -1))
        if dag.has_masks:
            released = D.release_masked(dag, release_tip, state.time)
        else:
            released = D.release_closure(dag, release_tip, state.time)
        dag = D.select_vis(do_release, released, dag)
        rt = release_tip.clamp(min=0)
        public = torch.where(do_release,
                             self.update_head(dag, state.public, rt),
                             state.public)
        private = torch.where(is_adopt, public, state.private)
        tie = do_release & (release_tip >= 0) & (
            self.pref(dag, rt) == self.pref(dag, public)) & (rt != public)
        if self.strict_match:
            tie = tie & (state.event == EV_NETWORK)
        race_tip = torch.where(tie, release_tip, state.race_tip)
        return state.replace(dag=dag, public=public, private=private,
                             race_tip=race_tip, mining_own=mining_own,
                             mining_foreign=mining_foreign)

    def obs_ints(self, state: State):
        """The observation's natural-scale fields (ethereum_ssz.ml:364-396)."""
        dag = state.dag
        ca = self.common_ancestor(dag, state.public, state.private) \
            .clamp(min=0)
        hc, wc = D.at(dag.height, ca), D.at(dag.aux, ca)
        ph = D.at(dag.height, state.public) - hc
        pw = D.at(dag.aux, state.public) - wc
        ah = D.at(dag.height, state.private) - hc
        aw = D.at(dag.aux, state.private) - wc
        win_priv = self.chain_window(dag, state.private)
        mu = self.max_uncles
        pub_orph = self.uncle_candidates(dag, state.public, dag.vis_a,
                                         dag.vis_d).sum(1).clamp(max=mu)
        inc = self.uncle_candidates(dag, state.private, dag.vis_a,
                                    dag.miner >= 0, win_priv
                                    ).sum(1).clamp(max=mu)
        exc = self.uncle_candidates(dag, state.private, dag.vis_a,
                                    dag.miner == D.ATTACKER, win_priv
                                    ).sum(1).clamp(max=mu)
        return (ph, pw, ah, aw, ah - ph, aw - pw, pub_orph, inc, exc,
                state.event)

    def observe(self, state: State):
        return obslib.encode(OBS_FIELDS, self.obs_ints(state),
                             self.unit_observation)

    def step(self, state: State, action, params):
        state = self._apply(state, action.to(I32))
        state = self._mine(state, params)
        state = state.replace(steps=state.steps + 1)
        dag = state.dag
        if self.ring:
            ca = D.common_ancestor_masked(dag, state.public,
                                          state.private).clamp(min=0)
            anchor = D.chain_first_at_most(
                dag, ca, dag.height, D.at(dag.height, ca) - UNCLE_WINDOW - 1)
            dag = D.retire_below(dag, torch.where(
                anchor >= 0, D.at(dag.gid, anchor.clamp(min=0)),
                torch.zeros_like(anchor)))
            state = state.replace(dag=dag, race_tip=D.drop_if_retired(
                dag, state.race_tip))
        pub_better = self.pref(dag, state.public) > \
            self.pref(dag, state.private)
        head = torch.where(pub_better, state.public, state.private)
        return self.finish_step(
            state, params,
            reward_attacker=D.at(dag.cum_atk, head),
            reward_defender=D.at(dag.cum_def, head),
            progress=self.progress_of(dag, head),
            chain_time=D.at(dag.born_at, head),
            extra_done=dag.overflow)

    # -- policies (ethereum_ssz.ml:444-538) --------------------------------

    def _policy_ints(self, policy_id: int, ph, pw, ah, aw, ev):
        ALL, OWN_ONLY = 3, 2
        c = lambda a, u: torch.full_like(ph, a * N_UNCLE_RULES + u)  # noqa
        w = torch.where
        if policy_id == 0:  # honest
            return w(pw > 0, c(ADOPT_RELEASE, ALL), c(OVERRIDE, ALL))
        if policy_id in (1, 2):  # selfish_release / selfish_discard
            adopt = ADOPT_RELEASE if policy_id == 1 else ADOPT_DISCARD
            priv, pub = (ah, ph) if self.preset == "whitepaper" else (aw, pw)
            return w(priv < pub, c(adopt, OWN_ONLY),
                     w(pub == 0, c(WAIT, OWN_ONLY), c(OVERRIDE, OWN_ONLY)))
        if policy_id in (3, 4):  # fn19 / fn19pkel
            adopt, rule = ((ADOPT_DISCARD, ALL) if policy_id == 3
                           else (ADOPT_RELEASE, OWN_ONLY))
            pow_branch = w((ah == 2) & (ph == 1), c(OVERRIDE, rule),
                           c(WAIT, rule))
            net_branch = w(ah < ph, c(adopt, rule),
                           w(ah == ph, c(MATCH, rule),
                             w(ah == ph + 1, c(OVERRIDE, rule),
                               c(RELEASE1, rule))))
            return w(ev == EV_POW, pow_branch, net_branch)
        raise ValueError(f"unknown policy id {policy_id}")

    def policy_from_ints(self, policy_id: int, state):
        ph, pw, ah, aw, *_ = self.obs_ints(state)
        return self._policy_ints(policy_id, ph, pw, ah, aw, state.event)

    def _make_policies(self):
        def make(pid, name):
            def policy(obs):
                ph, pw, ah, aw, _, _, _, _, _, ev = self.decode_obs(obs)
                return self._policy_ints(pid, ph, pw, ah, aw, ev)
            policy.policy_name = name
            policy.policy_owner = EthereumSSZ
            return policy

        return {name: make(i, name) for i, name in enumerate(POLICY_NAMES)}

    # -- kernel hooks (K10-eth) -------------------------------------------

    def kernel_config(self):
        return dict(max_uncles=self.max_uncles,
                    constant=int(self.incentive_scheme == "constant"),
                    pref_work=int(self.preference == "work"),
                    prog_work=int(self.progress == "work"),
                    whitepaper=int(self.preset == "whitepaper"),
                    strict=int(self.strict_match))
