"""Vote-quorum machinery of the parallel-PoW envs (port of
cpr_tpu/envs/quorum.py), shared by Tailstorm and Stree.

Reference counterparts: the closure-constrained sub-block selections
`acc_votes` / altruistic / heuristic / optimal quorum of
simulator/protocols/tailstorm.ml:134-506 and stree.ml:103-486, and the
release prefix of tailstorm_ssz.ml:292-314.

The candidates confirming a block are compacted into a frame of C
slot-ascending (age-ascending) indices; their ancestor relation is a
dense `[L, C, C]` bool matrix. Where the JAX package gathers candidate
values with one-hot matmuls (`frame_onehot`/`oh_gather`, quorum.py:26-53),
this module gathers directly and keeps the values those matmuls give:
a non-finite entry reads 0 and the row of a candidate outside the frame
reads 0 (`Frame.gather`). Every function works on lane-batched tensors
(`[L, B]` planes, `[L]` indices) and is the plain twin of kernel K9
(`csrc/quorum.cuh`), which runs the same selections one warp per lane
inside the Tailstorm and Stree stream kernels.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch

from cpr_tpu_torch.core import dag as D

I32, F32, BOOL = torch.int32, torch.float32, torch.bool
INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class Frame:
    """A compacted candidate frame: `cidx` [L, C] (NONE-padded), `gvalid`
    the slots the gathers read (the frame before escapes), `cvalid` the
    candidates left after escapes, `abits[l, i, j]`: candidate j lies in
    candidate i's vote closure (i == j included)."""

    cidx: torch.Tensor
    gvalid: torch.Tensor
    cvalid: torch.Tensor
    abits: torch.Tensor

    def gather(self, arr) -> torch.Tensor:
        """oh_gather (quorum.py:35): float32 candidate values of a per-slot
        plane, non-finite entries and rows outside the frame as 0."""
        return _gather(arr, self.cidx, self.gvalid)


def _gather(arr, idx, valid) -> torch.Tensor:
    v = arr.to(F32).gather(1, idx.clamp(min=0).long())
    v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
    return torch.where(valid, v, torch.zeros_like(v))


def fdiv(x, k) -> torch.Tensor:
    """float32 x / k, correctly rounded (a tensor divisor: a scalar one
    may become a multiply by its reciprocal on some devices)."""
    return x.to(F32) / torch.full_like(x, float(k), dtype=F32)


def last_of_kind_all(dag, kind: int) -> torch.Tensor:
    """[L, B] block/summary of every vertex (quorum.py:56): a vertex of
    `kind` is its own, anything else names it in `signer`."""
    return torch.where(dag.kind == kind, dag.slots()[None, :], dag.signer)


def candidate_frame(dag, cand, C: int, vote_kind: int,
                    max_vote_parents: int = 1) -> Frame:
    """quorum.py:65-150: the C oldest candidates of `cand` [L, B] and
    their vote-closure matrix; a candidate with a vote ancestor outside
    the frame is invalid, and so is its whole branch."""
    assert C < (1 << 8), "composite sort keys reserve 8 bits for C"
    cidx, gvalid = D.top_k_by(dag.age_key().to(F32), cand, C)
    cidx = torch.where(gvalid, cidx, torch.full_like(cidx, D.NONE))
    L, B = dag.n_lanes, dag.capacity
    ln = D.lanes(dag)[:, None]
    ci = cidx.clamp(min=0).long()

    def g(arr):
        return _gather(arr, cidx, gvalid)

    if dag.has_masks:
        rows = dag.closure[ln, ci] & gvalid[:, :, None]  # [L, C, B]
        if dag.is_ring:
            gid_c = g(dag.gid).to(I32)
            rows = rows & (dag.gid[:, None, :] <= gid_c[:, :, None])
        sig_c = torch.where(gvalid, g(dag.signer).to(I32),
                            torch.full_like(cidx, -2))
        anc = (rows & (dag.kind == vote_kind)[:, None, :]
               & (dag.signer[:, None, :] == sig_c[:, :, None]))
        if dag.is_ring:
            sv = gvalid & (sig_c >= 0)
            gid_sig = _gather(dag.gid, sig_c, sv).to(I32)
            anc = anc & (dag.gid[:, None, :] > gid_sig[:, :, None])
        frame_mask = D.mask_of(cidx, gvalid, B)
        escaped = (anc & ~frame_mask[:, None, :]).any(2)
        cvalid = gvalid & ~escaped
        abits = anc.gather(2, ci[:, None, :].expand(L, C, C)) \
            & gvalid[:, None, :]
        abits = abits & cvalid[:, :, None] & cvalid[:, None, :]
        return Frame(cidx, gvalid, cvalid, abits)

    adj = torch.zeros((L, C, C), dtype=BOOL, device=dag.device)
    escaped = torch.zeros((L, C), dtype=BOOL, device=dag.device)
    for p in range(max_vote_parents):
        par = g(dag.parents[p]).to(I32)
        par = torch.where(gvalid, par, torch.full_like(par, -1))
        match = (par[:, :, None] == cidx[:, None, :]) & (par >= 0)[:, :, None]
        par_in_frame = match.any(2)
        par_is_vote = gvalid & (par >= 0) & (
            dag.kind.gather(1, par.clamp(min=0).long()) == vote_kind)
        escaped = escaped | (par_is_vote & ~par_in_frame)
        adj = adj | (match & par_is_vote[:, :, None])
    eye = torch.eye(C, dtype=BOOL, device=dag.device)[None]
    reach = (adj | eye).to(F32)
    for _ in range(max(1, (C - 1).bit_length())):
        reach = torch.clamp(reach + torch.bmm(reach, reach), max=1.0)
    abits = reach > 0.0
    cvalid = gvalid & ~(abits & escaped[:, None, :]).any(2)
    abits = abits & cvalid[:, :, None]
    return Frame(cidx, gvalid, cvalid, abits)


def quorum_heuristic(f: Frame, own, q: int):
    """quorum.py:153: own-reward-first greedy branch selection, at most q
    rounds, DAG order on ties. Returns (found [L], leaves_c [L, C])."""
    L, C = f.cidx.shape
    own_c = (f.gather(own) > 0.5) & f.cvalid
    inc = torch.zeros((L, C), dtype=BOOL, device=own.device)
    leaves = torch.zeros_like(inc)
    n_rem = torch.full((L,), q, dtype=torch.int64, device=own.device)
    tie = (C - torch.arange(C, device=own.device))[None, :]
    ln = torch.arange(L, device=own.device)
    for _ in range(max(q, 1)):
        fresh = f.abits & ~inc[:, None, :]
        f_all = fresh.sum(2)
        f_own = (fresh & own_c[:, None, :]).sum(2)
        eligible = f.cvalid & ~inc & (f_all >= 1) & (f_all <= n_rem[:, None])
        score = ((f_own * (q + 2) + f_all) << 8) + tie
        score = torch.where(eligible & (n_rem > 0)[:, None], score,
                            torch.full_like(score, -1))
        c = torch.argmax(score, dim=1)
        ok = score[ln, c] >= 0
        inc = inc | (f.abits[ln, c] & ok[:, None])
        leaves[ln, c] = leaves[ln, c] | ok
        n_rem = n_rem - torch.where(ok, f_all[ln, c], torch.zeros_like(n_rem))
    return (n_rem == 0) & (f.cvalid.sum(1) >= q), leaves


def quorum_altruistic(f: Frame, own, seen, depth, q: int):
    """quorum.py:182: longest-branch-first greedy selection by (depth
    desc, own first, seen asc, DAG order). Returns (n, acc, leaves_c,
    n_cand), each per lane."""
    L, C = f.cidx.shape
    dev = own.device
    d_max = (1 << 12) - 1
    d = torch.clamp(f.gather(depth).to(torch.int64), max=d_max)
    own_c = f.gather(own) > 0.5
    seen_c = torch.where(f.cvalid, f.gather(seen),
                         torch.full((L, C), math.inf, device=dev))
    seen_rank = torch.argsort(torch.argsort(seen_c, dim=1, stable=True),
                              dim=1, stable=True)
    comp = (((((d_max - d) << 1) | (~own_c).to(torch.int64)) << 8)
            + seen_rank) << 8
    comp = comp + torch.arange(C, device=dev)[None, :]
    order = torch.argsort(torch.where(f.cvalid, comp,
                                      torch.full_like(comp, INT32_MAX)),
                          dim=1, stable=True)
    n_cand = f.cvalid.sum(1)
    acc = torch.zeros((L, C), dtype=BOOL, device=dev)
    leaves = torch.zeros_like(acc)
    n = torch.zeros(L, dtype=torch.int64, device=dev)
    ln = torch.arange(L, device=dev)
    for i in range(C):
        live = (n < q) & (i < n_cand)
        if not bool(live.any()):
            break
        c = order[:, i]
        row = f.abits[ln, c]
        fresh = (row & ~acc).sum(1)
        take = live & (fresh >= 1) & (n + fresh <= q)
        acc = acc | (row & take[:, None])
        leaves[ln, c] = leaves[ln, c] | take
        n = n + torch.where(take, fresh, torch.zeros_like(fresh))
    return n, acc, leaves, n_cand


def optimal_window(q: int, C: int, max_options: int = 100) -> int:
    """quorum.py:225: the largest window W with comb(W, q) <= max_options
    (the static form of the reference's 100-option cap)."""
    W = q
    while W + 1 <= C and math.comb(W + 1, q) <= max_options:
        W += 1
    return W


def optimal_combos(q: int, W: int) -> np.ndarray:
    """[n_opt, W] bool table of all size-q subsets of the window, in
    itertools.combinations order (quorum.py:239)."""
    rows = []
    for combo in itertools.combinations(range(W), q):
        row = np.zeros(W, bool)
        row[list(combo)] = True
        rows.append(row)
    return np.asarray(rows)


def quorum_optimal(f: Frame, own, depth, q: int, combos, *, k: int,
                   discount: bool, punish: bool, depth_plus: int = 0,
                   leaf_score=None, miner_share: int = 0):
    """quorum.py:253: every closed size-q subset of the window, the one
    paying the miner most (the first of equals in table order). Returns
    (found, leaves_c)."""
    L, C = f.cidx.shape
    dev = own.device
    W = combos.shape[1]
    sel = torch.zeros((combos.shape[0], C), dtype=BOOL, device=dev)
    sel[:, :W] = torch.from_numpy(np.asarray(combos)).to(dev)
    own_c = (f.gather(own) > 0.5) & f.cvalid
    depth_c = torch.where(f.cvalid, f.gather(depth).to(I32),
                          torch.full((L, C), -1, dtype=I32, device=dev))
    n_cand = f.cvalid.sum(1)
    ok_valid = (sel[None] & ~f.cvalid[:, None, :]).sum(2) == 0
    hit = torch.matmul(sel.to(F32), f.abits.to(F32)) > 0  # [L, n_opt, C]
    escape = (hit & ~sel[None]).any(2)
    valid = ok_valid & ~escape & (n_cand >= q)[:, None]
    score_c = torch.where(f.cvalid, f.gather(leaf_score),
                          torch.full((L, C), -math.inf, device=dev))
    deep_key = torch.where(sel[None], score_c[:, None, :],
                           torch.full((1, 1, 1), -math.inf, device=dev))
    deepest = torch.argmax(deep_key, dim=2)  # [L, n_opt]
    depth_max = torch.where(sel[None], depth_c[:, None, :],
                            torch.full((1, 1, 1), -1, dtype=I32,
                                       device=dev)).amax(2)
    r = (fdiv(depth_max + depth_plus, k) if discount
         else torch.ones_like(depth_max, dtype=F32))
    if punish:
        rewarded = f.abits.gather(
            1, deepest[:, :, None].expand(-1, -1, C))
    else:
        rewarded = sel[None].expand(L, -1, -1)
    count = ((rewarded & own_c[:, None, :]).sum(2) + miner_share).to(F32)
    score = torch.where(valid, r * count,
                        torch.full_like(r, -math.inf))
    best = torch.argmax(score, dim=1)
    found = valid.any(1)
    sel_best = sel[best] & found[:, None]
    eye = torch.eye(C, dtype=BOOL, device=dev)[None]
    desc = sel_best[:, :, None] & f.abits & ~eye
    return found, sel_best & ~desc.any(1)


def quorum_optimal_or_heuristic(f: Frame, own, depth, q: int, window: int,
                                combos, **kw):
    """quorum.py:309: the optimal selection, or the heuristic where a
    valid candidate lies beyond the window."""
    found_o, leaves_o = quorum_optimal(f, own, depth, q, combos, **kw)
    found_h, leaves_h = quorum_heuristic(f, own, q)
    C = f.cidx.shape[1]
    over = (f.cvalid & (torch.arange(C, device=own.device) >= window)
            [None, :]).any(1)
    return (torch.where(over, found_h, found_o),
            torch.where(over[:, None], leaves_h, leaves_o))


def leaves_to_row(dag, f: Frame, leaves_c, width: int, score):
    """quorum.py:343: the leaves as a parent row [L, width], sorted by
    `score` descending (ties to the lowest slot), NONE-padded."""
    leaves = D.mask_of(f.cidx, leaves_c & f.cvalid, dag.capacity)
    idx, valid = D.top_k_by(score, leaves, width, largest=True)
    return torch.where(valid, idx, torch.full_like(idx, D.NONE))


def prefix_release_sets(dag, public, private, cands, R: int, last_all,
                        cmp_fn, extra_all=None):
    """quorum.py:352-440: scan the withheld candidates in age order; the
    Override set is the shortest prefix whose release flips the
    defender's head by (height, confirming votes[, extra]), the Match set
    that prefix without its last vertex; with no flip, or more than R
    candidates, both release everything. Returns (override_set,
    match_set, found, new_head)."""
    L = dag.n_lanes
    dev = dag.device
    ridx, rvalid = D.top_k_by(dag.age_key().to(F32), cands, R)
    lb = torch.where(rvalid, _gather(last_all, ridx, rvalid).to(I32),
                     torch.zeros_like(ridx))
    csig = torch.where(rvalid, _gather(dag.signer, ridx, rvalid).to(I32),
                       torch.full_like(ridx, -1))
    is_conf = dag.exists() & (dag.signer >= 0)
    conf_rows = ((is_conf & dag.vis_d)[:, :, None]
                 & (dag.signer[:, :, None] == lb[:, None, :]))  # [L, B, R]
    lvalid = rvalid & (lb >= 0)
    if dag.is_ring:
        gid_lb = _gather(dag.gid, lb, lvalid).to(I32)
        conf_rows = conf_rows & (dag.gid[:, :, None] > gid_lb[:, None, :])
    conf_vis = conf_rows.sum(1)
    cand_vote = (csig >= 0) & rvalid
    cmat = cand_vote[:, :, None] & (csig[:, :, None] == lb[:, None, :])
    leq = torch.triu(torch.ones((R, R), dtype=BOOL, device=dev))
    nconf = conf_vis + (cmat & leq[None]).sum(1)
    pub_vis = (is_conf & dag.vis_d & (dag.signer == public[:, None])
               & D.newer_than(dag, public)).sum(1)
    npub = pub_vis[:, None] + torch.cumsum(
        (cand_vote & (csig == public[:, None])).to(torch.int64), dim=1)
    h_lb = torch.where(rvalid, _gather(dag.height, ridx, rvalid).to(I32),
                       torch.zeros_like(ridx))
    h_pub = D.at(dag.height, public)[:, None]
    flip = (h_lb > h_pub) | ((h_lb == h_pub) & (nconf > npub))
    if extra_all is not None:
        e_lb = _gather(extra_all, lb, lvalid)
        e_pub = D.at(extra_all, public.clamp(min=0))[:, None]
        flip = flip | ((h_lb == h_pub) & (nconf == npub) & (e_lb > e_pub))
    flip = flip & (lb != public[:, None]) & rvalid
    overflow = cands.sum(1) > R
    found = flip.any(1) & ~overflow
    j_stop = torch.argmax(flip.to(torch.int8), dim=1)
    pos = torch.arange(R, device=dev)[None, :]
    take_o = torch.where(found[:, None], pos <= j_stop[:, None], rvalid)
    take_m = torch.where(found[:, None], pos < j_stop[:, None], rvalid)
    override_set = D.mask_of(ridx, take_o & rvalid, dag.capacity)
    match_set = D.mask_of(ridx, take_m & rvalid, dag.capacity)
    ov = overflow[:, None]
    override_set = torch.where(ov, cands, override_set)
    match_set = torch.where(ov, cands, match_set)
    all_flip = cmp_fn(dag, private, public, dag.vis_d | cands)
    found = found | (overflow & all_flip)
    lb_stop = lb[torch.arange(L, device=dev), j_stop]
    new_head = torch.where(overflow, torch.where(all_flip, private, public),
                           torch.where(found, lb_stop, public))
    return override_set, match_set, found, new_head


def stale_after_adopt(dag, public, stale, is_adopt, R: int, walk: int,
                      last_all, prev_fn):
    """quorum.py:443-471: at an Adopt, every withheld vertex that does not
    descend from `public` turns stale; the descent test is one chain
    column with ancestry planes, else a `walk`-level descent of the
    compacted withheld set (`prev_fn(dag, idx [L, R])`)."""
    withheld = ~dag.vis_d & dag.exists() & ~stale
    if dag.has_masks:
        keep = D.descendants_mask(dag, public)
    else:
        widx, wvalid = D.top_k_by(dag.age_key().to(F32), withheld, R)
        cur = torch.where(wvalid, _gather(last_all, widx, wvalid).to(I32),
                          torch.full_like(widx, -1))
        keeps = torch.zeros_like(wvalid)
        for _ in range(walk):
            keeps = keeps | (cur == public[:, None])
            cur = torch.where(cur >= 0, prev_fn(dag, cur.clamp(min=0)),
                              torch.full_like(cur, -1))
        keep = D.mask_of(widx, keeps & wvalid, dag.capacity)
    return torch.where(is_adopt[:, None], stale | (withheld & ~keep), stale)


# -- K9's check ---------------------------------------------------------------
#
# Every function above on one batch of lane DAGs and selector inputs, as
# K9's check kernel (csrc/quorum_check.cu) computes them: the candidate
# frame of `cand`, the heuristic, altruistic and optimal (with its
# fallback) selections with their parent rows, the release sets of the
# withheld non-stale vertices against (pub, priv) under the env's
# preference, and the stale plane after an Adopt to pub.

STALE_WALK = 4  # the envs' summary/block-chain descent depth (full mode)


def check_cfg(env) -> dict:
    """The check's options for a Tailstorm (env 0) or Stree (env 1)
    instance: its frame, quorum size, leaves, scheme and scan."""
    stree = hasattr(env, "q")
    q = env.q if stree else env.k
    return dict(env=int(stree), C=env.C_MAX, q=q, k=env.k, width=q,
                window=optimal_window(q, env.C_MAX),
                discount=int(env.discount), punish=int(env.punish),
                depth_plus=int(stree), miner_share=int(stree),
                R=env.release_scan)


def check_inputs(env, state) -> dict:
    """Selector inputs from a Tailstorm or Stree state: lane i asks for the
    quorum on its private tip (i % 4 == 0), its public tip (1) or the block
    with the most confirming votes (2, 3), for the attacker (i % 8 < 4) or
    the defender, with the exclusive vote filter on every third lane, each
    through the voter's view."""
    dag = state.dag
    L, dev = dag.n_lanes, dag.device
    i = torch.arange(L, device=dev)
    sig = dag.signer.clamp(min=0).long()
    ak = dag.age_key()
    votes = (dag.exists() & (dag.kind == 1) & (dag.signer >= 0)
             & (ak > ak.gather(1, sig)))
    n_conf = torch.zeros_like(dag.signer).scatter_add_(1, sig,
                                                       votes.to(I32))
    best = torch.argmax(n_conf, dim=1).to(I32)
    b = torch.where(i % 4 == 0, state.private,
                    torch.where(i % 4 == 1, state.public, best))
    att = i % 8 < 4
    voter = torch.where(att, torch.zeros_like(b), torch.ones_like(b))
    filt = torch.where((i % 3 == 0)[:, None], dag.miner == D.ATTACKER,
                       dag.exists())
    view = torch.where(att[:, None], dag.vis_a, dag.vis_d)
    return dict(
        cand=env.confirming(dag, b) & filt & view,
        own=dag.miner == voter[:, None],
        seen=torch.where(att[:, None], dag.born_at, dag.vis_d_since),
        score=env.vote_order(dag), stale=state.stale.clone(),
        pub=state.public.clone(), priv=state.private.clone())


def prefers(dag, x, y, mask, own=None):
    """x strictly preferred over y, [L] bool (Tailstorm's `cmp_summaries`,
    Stree's `cmp_blocks`): by height, then by the votes confirming each
    in `mask`, then, where `own` is given (s -> [L] values, Tailstorm's
    own reward), by own(x) > own(y)."""
    def n(s):
        return (dag.exists() & (dag.kind == 1) & (dag.signer == s[:, None])
                & D.newer_than(dag, s) & mask).sum(1)

    hx, hy = (D.at(dag.height, s.clamp(min=0)) for s in (x, y))
    nx, ny = n(x), n(y)
    gt = (hx > hy) | ((hx == hy) & (nx > ny))
    if own is not None:
        gt = gt | ((hx == hy) & (nx == ny) & (own(x) > own(y)))
    return gt & (x != y)


def check_plain(dag, inputs: dict, cfg: dict) -> dict:
    """Plain twin of K9's check kernel (see above); `cfg` as `check_cfg`
    gives it. Returns cidx, cvalid [L, C], abits [L, C, C], found [3, L],
    leaves [3, L, C], row [3, L, width] (heuristic, altruistic, optimal),
    ovr, mat [L, W], rfound, head [L] and stale [L, W]. Ring and full mode (the
    kernel: ring windows with ancestry planes)."""
    q, score = cfg["q"], inputs["score"]
    f = candidate_frame(dag, inputs["cand"], cfg["C"], 1)
    own = inputs["own"]
    found_h, leaves_h = quorum_heuristic(f, own, q)
    n, _, leaves_a, n_cand = quorum_altruistic(f, own, inputs["seen"],
                                               dag.aux, q)
    found_o, leaves_o = quorum_optimal_or_heuristic(
        f, own, dag.aux, q, cfg["window"], optimal_combos(q, cfg["window"]),
        k=cfg["k"], discount=bool(cfg["discount"]),
        punish=bool(cfg["punish"]), depth_plus=cfg["depth_plus"],
        leaf_score=score, miner_share=cfg["miner_share"])
    leaves = (leaves_h, leaves_a, leaves_o)
    pub, priv = inputs["pub"], inputs["priv"]
    stale = inputs["stale"]
    cands = dag.exists() & ~dag.vis_d & ~stale
    env = cfg["env"]
    ovr, mat, rfound, head = prefix_release_sets(
        dag, pub, priv, cands, cfg["R"], last_of_kind_all(dag, 0),
        lambda d, x, y, m: prefers(
            d, x, y, m,
            (lambda s: D.at(d.auxg, s.clamp(min=0))) if env == 0 else None),
        extra_all=dag.auxg if env == 0 else None)
    return dict(
        cidx=f.cidx, cvalid=f.cvalid, abits=f.abits,
        found=torch.stack([found_h, (n == q) & (n_cand >= q), found_o]),
        leaves=torch.stack(leaves),
        row=torch.stack([leaves_to_row(dag, f, lv, cfg["width"], score)
                         for lv in leaves]),
        ovr=ovr, mat=mat, rfound=rfound, head=head,
        stale=stale_after_adopt(
            dag, pub, stale, torch.ones_like(pub, dtype=BOOL), cfg["R"],
            STALE_WALK, last_of_kind_all(dag, 0),
            lambda d, i: (d.aux2 if env == 0 else d.parent0).gather(
                1, i.long())))


def quorum_check(dag, inputs: dict, cfg: dict) -> dict:
    """K9's check: its kernel on CUDA (ring windows with ancestry planes),
    `check_plain` on the CPU."""
    if dag.device.type == "cuda":
        from cpr_tpu_torch import kernels
        return kernels.quorum_check(dag, inputs, cfg)
    if dag.device.type != "cpu":
        raise ValueError(f"unsupported device {dag.device}")
    return check_plain(dag, inputs, cfg)
