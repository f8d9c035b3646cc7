"""The multi-node network simulator (port of cpr_tpu/netsim/engine.py).

One lane is one honest-node simulation from one (seed, activation
delay) pair; `Engine.run` executes a batch of lanes. Two modes, as in
the JAX package:

* `scan`, for simple dissemination: every block is sent once per link
  at mint, so activation times, miners and arrival times are
  state-independent draws, and the only sequential part is each miner's
  preference at its activation instant, over a window of `lookback`
  blocks plus a running best of the blocks older than the window.
  Kernel K12-scan (`csrc/netsim_scan.cu`), plain version `scan_plain`.
* `event`: the general discrete-event loop over a fixed-capacity message
  queue, delivery waves of every entry at (earliest time, block), a
  pending buffer for blocks whose parent is not yet visible (re-queued
  at the delivering time when it lands), flooding re-shares on first
  delivery, and a drain that stops at the first never-executed
  activation. Nakamoto runs kernel K12-event (`csrc/netsim_event.cu`),
  the Bk, Ethereum (whitepaper and Byzantium) and Spar branches kernels
  K12-event-bk, K12-event-eth and K12-event-spar
  (`csrc/netsim_event_{bk,eth,spar}.cu`), all over one engine
  (`csrc/netsim_event.cuh`); plain version `event_plain` for every
  protocol.

Both keep the JAX package's semantics, RNG stream and outputs. Times are
float64 (the JAX package runs the netsim under 64-bit mode, so the lane
keys are 64-bit mode keys and the clocks are float64 draws). The
activation times are a sequential running sum in both the kernel and
the plain version; XLA:CPU's float64 cumsum adds in another order, so
they equal the JAX package's only to a relative 1e-12 or so, and an
integer output can differ only where a decision compared two times
closer than that (the plain versions return that smallest gap as
`margin`).

Under CPR_DEVICE_METRICS=1 `Engine.run` emits the reference's
`device_metrics` event of scope `netsim` (steps and drop counters over
the lanes); `AttackEngine.run` runs as without it, as the reference's
does.

Not ported: `x64=False` (float32 clocks, ROADMAP item 11b) and `mesh=`
(item 13): each raises, naming its item. The kernels hold a lane in one
warp, node n on thread n % 32 in slot n / 32 of up to 8 (`node_slots`):
they take up to 256 nodes, fewer where a lane's queue and pending
buffers outgrow a block's shared memory (`check_kernel_nodes` names the
limit and item 11b); the plain versions take any N. Launches past 32
nodes count under the kernel's name and its node bucket
(`kernel_name`: K12-event-n128 for 100 nodes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cpr_tpu_torch import _device, telemetry
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.netsim.compile import (CompiledNet, clamp_uniform,
                                          compile_network, delay_of_draws,
                                          sample_delay_matrix)

SUPPORTED_PROTOCOLS = ("nakamoto", "bk", "ethereum-whitepaper",
                       "ethereum-byzantium", "spar")
_SCHEMES = ("constant", "block")
_ETH = ("ethereum-whitepaper", "ethereum-byzantium")
# nodes a thread of the kernels' warp holds (csrc/netsim.cuh node_slots)
KERNEL_NODE_SLOTS = (1, 2, 4, 8)
KERNEL_MAX_NODES = 32 * KERNEL_NODE_SLOTS[-1]
# a queue entry packs block << 8 | node (csrc/netsim_event.cuh)
KERNEL_MAX_BLOCKS = 1 << 23

F64, F32, I32 = torch.float64, torch.float32, torch.int32
INT_MAX = 2**31 - 1
# steps whose draws the plain event engines take at once (`EventLedger.run`)
DRAW_CHUNK = 64


def supports(protocol: str, k: int = 1, scheme: str = "constant") -> bool:
    """True when the engine implements this protocol config."""
    if protocol == "nakamoto" or protocol in _ETH:
        return True
    return (protocol in ("bk", "spar") and k >= 1
            and (scheme or "constant") in _SCHEMES)


def uniform_const_delay(cn: CompiledNet):
    """D where every off-diagonal link is the same constant delay (the
    symmetric cliques), else None."""
    off = ~np.eye(cn.n, dtype=bool)
    if (np.all((cn.kind >= 0) == off) and np.all(cn.kind[off] == 0)
            and np.unique(cn.p0[off]).size == 1):
        return float(cn.p0[0, 1])
    return None


def log_compute(cn: CompiledNet, device) -> torch.Tensor:
    """The miner draw's float32 logits, log(compute)."""
    return torch.log(torch.as_tensor(cn.compute, dtype=F32, device=device))


def planes(cn: CompiledNet, device):
    """(kind i32, p0 f64, p1 f64) [N, N] on `device`."""
    return (torch.as_tensor(cn.kind, dtype=I32, device=device),
            torch.as_tensor(cn.p0, dtype=F64, device=device),
            torch.as_tensor(cn.p1, dtype=F64, device=device))


def running_sum(x: torch.Tensor) -> torch.Tensor:
    """Sequential prefix sum over the last axis, left to right (the
    order K12-scan adds in)."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x[..., 0])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


# -- plain version of K12-scan ------------------------------------------------

def scan_draws(cn: CompiledNet, A: int, keys, delays):
    """The scan path's state-independent draws for keys [Ln, 2] and
    activation delays [Ln] f64: mint times t [Ln, A + 1] (the last one the
    first never-executed activation), miners m [Ln, A] and arrival times
    arr [Ln, A, N]."""
    N = cn.n
    dev = keys.device
    ks = rnd.split(keys, 3)
    gaps = rnd.exponential(ks[:, 0], (A + 1,), dtype=F64)
    t = running_sum(gaps) * delays[:, None]
    m = rnd.categorical(ks[:, 1], log_compute(cn, dev), shape=(A,))
    own = torch.arange(N, device=dev) == m[..., None]
    tm = t[:, :A, None]
    D = uniform_const_delay(cn)
    if D is not None:
        arr = tm + torch.where(own, 0.0, D)
    else:
        kind, p0, p1 = planes(cn, dev)
        delay = sample_delay_matrix(ks[:, 2], kind[m], p0[m], p1[m])
        arr = torch.where(kind[m] >= 0, tm + delay, torch.inf)
        arr = torch.where(own, tm, arr)
    return t, m, arr


def scan_plain(cn: CompiledNet, A: int, L: int, keys, delays) -> dict:
    """Plain version of K12-scan: the JAX package's `_scan_lane_fn`
    (engine.py:716-918) over lanes, from the same draws. Also returns
    `margin` [Ln]: the smallest gap a decision turned on, between two
    distinct finite preference keys or between an arrival and the time
    it was tested against."""
    N = cn.n
    dev = keys.device
    L = min(int(L), A)
    Ln = keys.shape[0]
    t, m, arr = scan_draws(cn, A, keys, delays)
    lanes = torch.arange(Ln, device=dev)
    big = 2.0 * t[:, A] + 4.0          # height dominates the (h, -arr) key
    ninf = torch.tensor(-torch.inf, dtype=F64, device=dev)

    def pref_key(h, a):
        return h.to(F64) * big.view(-1, *([1] * (h.dim() - 1))) - a

    ring_h = torch.zeros((Ln, L), dtype=I32, device=dev)
    hmax_old = torch.zeros(Ln, dtype=I32, device=dev)
    bidx_old = torch.zeros(Ln, dtype=I32, device=dev)
    hs = torch.zeros((Ln, A), dtype=I32, device=dev)
    ps = torch.zeros((Ln, A), dtype=I32, device=dev)
    margin = torch.full((Ln,), torch.inf, dtype=F64, device=dev)
    arangeL = torch.arange(L, device=dev)
    for i in range(A):
        t_i, mi = t[:, i], m[:, i]
        start = max(i - L, 0)
        gidx = start + arangeL
        h_w = ring_h[:, gidx % L]
        col = arr[lanes[:, None], gidx[None, :], mi[:, None]]
        old_row = torch.clamp(bidx_old - 1, min=0).long()
        arr_old = torch.where(bidx_old == 0, 0.0, arr[lanes, old_row, mi])
        key_w = torch.where(col < t_i[:, None], pref_key(h_w, col), ninf)
        kw = key_w.max(1).values
        atmax = key_w == kw[:, None]
        sel_g = torch.where(atmax, gidx, A).min(1).values
        sel_h = torch.where(atmax & (gidx == sel_g[:, None]), h_w, 0).sum(1)
        k_old = pref_key(hmax_old, arr_old)
        use_old = k_old >= kw
        margin = torch.minimum(margin, torch.minimum(
            _key_gap(torch.cat([key_w, k_old[:, None]], 1)),
            _time_gap(col, t_i[:, None])))
        parent = torch.where(use_old, bidx_old, (sel_g + 1).to(I32))
        h_i = torch.where(use_old, hmax_old, sel_h.to(I32)) + 1
        if i >= L:
            # the block leaving the window folds into the old best
            h_leave = ring_h[:, i % L]
            upd = h_leave > hmax_old
            hmax_old = torch.where(upd, h_leave, hmax_old)
            bidx_old = torch.where(upd, i - L + 1, bidx_old)
        ring_h[:, i % L] = h_i
        hs[:, i], ps[:, i] = h_i, parent

    # every block must have landed everywhere before it leaves the window
    if A > L:
        late = torch.isfinite(arr[:, :A - L]) & (arr[:, :A - L]
                                                 > t[:, L:A, None])
        miss = late.any(2).sum(1).to(I32)
    else:
        miss = torch.zeros(Ln, dtype=I32, device=dev)

    # drain + winner: one per-node fold at the cutoff t[A]
    start = max(A - L, 0)
    gidx = start + arangeL
    arr_w = arr[:, start:start + L]                          # [Ln, L, N]
    h_w = ring_h[:, gidx % L][..., None]
    key_w = torch.where(arr_w < t[:, A, None, None], pref_key(h_w, arr_w),
                        ninf)
    kw = key_w.max(1).values                                 # [Ln, N]
    atmax = key_w == kw[:, None]
    sel_g = torch.where(atmax, gidx[None, :, None], A).min(1).values
    sel_h = torch.where(atmax & (gidx[None, :, None] == sel_g[:, None]),
                        h_w, 0).sum(1)
    old_row = torch.clamp(bidx_old - 1, min=0).long()
    arr_old = torch.where(bidx_old[:, None] == 0, 0.0, arr[lanes, old_row])
    k_old = pref_key(hmax_old[:, None], arr_old)
    use_old = k_old >= kw
    margin = torch.minimum(margin, _key_gap(
        torch.cat([key_w, k_old[:, None]], 1).transpose(1, 2)
        .reshape(Ln * N, L + 1)).view(Ln, N).min(1).values)
    margin = torch.minimum(margin, _time_gap(
        arr.reshape(Ln, -1), t[:, A, None]))
    bh = torch.where(use_old, hmax_old[:, None], sel_h.to(I32))
    bidx = torch.where(use_old, bidx_old[:, None], (sel_g + 1).to(I32))
    j_star = torch.argmax(bh, 1)
    head = bidx[lanes, j_star]
    head_height = bh.max(1).values

    # on-chain by a reverse walk over mint order (parents precede children)
    on_chain = torch.zeros((Ln, A), dtype=torch.bool, device=dev)
    cur = head.clone()
    for idx in range(A, 0, -1):
        hit = cur == idx
        on_chain[:, idx - 1] = hit
        cur = torch.where(hit, ps[:, idx - 1], cur)
    reward = torch.zeros((Ln, N + 1), dtype=F32, device=dev).scatter_add_(
        1, torch.where(on_chain, m, N), torch.ones((Ln, A), dtype=F32,
                                                   device=dev))[:, :N]
    node_act = torch.zeros((Ln, N + 1), dtype=I32, device=dev).scatter_add_(
        1, m, torch.ones((Ln, A), dtype=I32, device=dev))[:, :N]
    fin = torch.where(torch.isfinite(arr) & (arr < t[:, A, None, None]), arr,
                      ninf)
    sim_time = torch.maximum(t[:, A - 1], fin.view(Ln, -1).max(1).values)
    z = torch.zeros(Ln, dtype=I32, device=dev)
    full = torch.full((Ln,), A, dtype=I32, device=dev)
    return dict(head=head.to(I32), head_height=head_height.to(I32),
                sim_time=sim_time, n_blocks=full, n_act=full.clone(),
                node_act=node_act, reward=reward, steps=full.clone(),
                drop_q=z, drop_p=z.clone(), drop_b=z.clone(), win_miss=miss,
                exhausted=torch.zeros(Ln, dtype=torch.bool, device=dev),
                margin=margin)


def _time_gap(times: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Smallest |time - ref| over finite times that differ from ref, along
    the last axis."""
    d = (times - ref).abs()
    return torch.where(torch.isfinite(d) & (d > 0), d, torch.inf).min(-1).values


def _key_gap(keys: torch.Tensor) -> torch.Tensor:
    """Smallest gap between distinct finite values along the last axis."""
    s = torch.sort(torch.where(torch.isfinite(keys), keys, torch.nan),
                   dim=-1).values
    d = s[..., 1:] - s[..., :-1]
    d = torch.where(torch.isnan(d) | (d == 0), torch.inf, d)
    return d.min(-1).values


# -- plain versions of K12-event, K12-event-bk, -eth and -spar -----------------

@dataclass(frozen=True)
class Proto:
    """A protocol's configuration as the event engines read it: `W` the
    ledger window of the Bk/Spar quorum search and the Ethereum uncle
    scan, `U` the Ethereum uncle capacity a block (Engine sizes both as
    the JAX package does)."""
    protocol: str = "nakamoto"
    k: int = 1
    scheme: str = "constant"
    W: int = 0
    U: int = 8

    @property
    def is_bk(self) -> bool:
        return self.protocol == "bk"

    @property
    def is_eth(self) -> bool:
        return self.protocol in _ETH

    @property
    def byz(self) -> bool:
        return self.protocol == "ethereum-byzantium"

    @property
    def is_spar(self) -> bool:
        return self.protocol == "spar"

    @property
    def QW(self) -> int:
        """Width of a block's stored quorum row: Bk's k votes, Spar's
        k - 1 (at least one slot, -1 where k = 1)."""
        return self.k if self.is_bk else max(self.k - 1, 1)


NAKAMOTO = Proto()


def rank_pick(sel, limit, j):
    """For each lane and each j in `j` [Ln, Q]: the window offset of the
    entry of rank j (1-based, window order) among the entries of `sel`
    [Ln, W] of rank <= `limit` [Ln], else 0 (the JAX package's
    rank-to-offset scatter into zeros, read at j)."""
    r = torch.cumsum(sel.to(I32), 1)
    ok = sel & (r <= limit[:, None])
    hit = ok[:, None, :] & (r[:, None, :] == j[:, :, None])
    return torch.where(hit.any(2), torch.argmax(hit.to(I32), 2), 0)


class EventLedger:
    """The plain event engines' per-lane state: the block ledger (parent,
    height, miner, per-node visibility and first-arrival bits), node
    preferences, the message queue and the pending buffers, plus the
    protocol's planes: Bk's and Spar's votes (`is_vote`, the per-(node,
    block) confirming tallies `conf`/`conf_own`, the stored quorums),
    Bk's hashes and proposal state (`powh`, `lhash`, `mybest`, `repl`,
    `noprop`), Ethereum's `work` and `uncles`. Field names follow the
    JAX package's state dict. The JAX package also carries per-node
    arrival times `vis_at`, which nothing reads; the port drops them, and
    it keeps `powh` for Bk only (Ethereum and Spar write it and never
    read it)."""

    def __init__(self, cn, A, B, M, F, keys, delays, proto=NAKAMOTO):
        N = cn.n
        dev = keys.device
        Ln = keys.shape[0]
        self.cn, self.A, self.B, self.M, self.F = cn, A, B, M, F
        self.proto = proto
        self.dev, self.Ln = dev, Ln
        self.delays = delays
        self.kind, self.p0, self.p1 = planes(cn, dev)
        self.has_link = self.kind >= 0
        self.arangeN = torch.arange(N, device=dev)
        self.lanes = torch.arange(Ln, device=dev)
        # constants of a step, made here: `run` may capture the steps in
        # a CUDA graph, where no host value may be copied to the card
        self.counters = torch.cat([self.arangeN, torch.tensor(
            [0, 0, 1] + ([0] if proto.is_bk else []), device=dev)])
        self.c_dst = torch.cat([self.arangeN.repeat_interleave(F),
                                self.arangeN.repeat(N)]).to(I32)
        self.c_ids = torch.arange(N * F + N * N, device=dev)
        W = proto.W
        self.arW = torch.arange(W, device=dev)
        self.iq = torch.arange(proto.QW, device=dev)
        self.iu = torch.arange(proto.U, device=dev)
        ks = rnd.split(keys)
        self.key = ks[:, 0]     # the carry's key (`run` splits it a step)
        i32 = dict(dtype=I32, device=dev)
        self.st = dict(
            now=torch.zeros(Ln, dtype=F64, device=dev),
            next_act=rnd.exponential(ks[:, 1], (), dtype=F64) * delays,
            n_act=torch.zeros(Ln, **i32),
            nb=torch.ones(Ln, **i32),
            seq=torch.zeros(Ln, **i32),
            steps=torch.zeros(Ln, **i32),
            live=torch.ones(Ln, dtype=torch.bool, device=dev),
            parent0=torch.full((Ln, B), -1, **i32),
            height=torch.zeros((Ln, B), **i32),
            miner=torch.full((Ln, B), -1, **i32),
            pref=torch.zeros((Ln, N), **i32),
            vis=torch.zeros((Ln, N, B), dtype=torch.bool, device=dev),
            known=torch.zeros((Ln, N, B), dtype=torch.bool, device=dev),
            node_act=torch.zeros((Ln, N), **i32),
            q_time=torch.full((Ln, M), torch.inf, dtype=F64, device=dev),
            q_dst=torch.zeros((Ln, M), **i32),
            q_blk=torch.zeros((Ln, M), **i32),
            q_seq=torch.zeros((Ln, M), **i32),
            pend=torch.full((Ln, N, F), -1, **i32),
            drop_q=torch.zeros(Ln, **i32),
            drop_p=torch.zeros(Ln, **i32),
            drop_b=torch.zeros(Ln, **i32),
            margin=torch.full((Ln,), torch.inf, dtype=F64, device=dev),
        )
        self.st["vis"][:, :, 0] = True
        self.st["known"][:, :, 0] = True
        st = self.st
        if proto.protocol != "nakamoto":
            st["win_miss"] = torch.zeros(Ln, **i32)
        if proto.is_bk or proto.is_spar:
            st["is_vote"] = torch.zeros((Ln, B), dtype=torch.bool,
                                        device=dev)
            st["conf"] = torch.zeros((Ln, N, B), **i32)
            st["conf_own"] = torch.zeros((Ln, N, B), **i32)
            st["quorum"] = torch.full((Ln, B, proto.QW), -1, **i32)
        if proto.is_bk:
            f32 = dict(dtype=F32, device=dev)
            st["powh"] = torch.full((Ln, B), 2.0, **f32)
            st["lhash"] = torch.full((Ln, B), 2.0, **f32)
            st["mybest"] = torch.full((Ln, N, B), 2.0, **f32)
            st["repl"] = torch.full((Ln, N, B), 2.0, **f32)
            st["noprop"] = torch.zeros((Ln, N, B), dtype=torch.bool,
                                       device=dev)
        if proto.is_eth:
            st["work"] = torch.zeros((Ln, B), **i32)
            st["uncles"] = torch.full((Ln, B, proto.U), -1, **i32)

    # -- pieces of one step, on the state `st` before the step ----------

    def timing(self, st, new):
        """(tmin, act_now, recv_ok); also lowers `margin` in `new`, the
        smallest gap between the earliest queue time and the next
        activation or the next later queue time (a decision that a
        difference of rounding in the clocks could turn)."""
        q = st["q_time"]
        tmin = q.amin(1)
        can_act = st["n_act"] < self.A
        act_now = can_act & (st["next_act"] <= tmin)
        recv_ok = torch.isfinite(tmin) & ~(~can_act
                                           & (tmin >= st["next_act"]))
        later = torch.where(q > tmin[:, None], q, torch.inf).amin(1)
        gaps = torch.stack([(st["next_act"] - tmin).abs(), later - tmin])
        live = st["live"] & torch.isfinite(tmin)
        new["margin"] = torch.where(
            live, torch.minimum(st["margin"], torch.nan_to_num(
                gaps, nan=torch.inf).amin(0)), st["margin"])
        return tmin, act_now, recv_ok

    def deliver_wave(self, st, new, is_recv, tmin):
        """The delivery wave: every queue entry at (tmin, b), b the block
        of the earliest-sequenced entry at tmin; writes known/vis/pend/
        pref/q_time (and the protocol's tallies, `prefer`) into `new` and
        returns (b, deliver [Ln, N], pend2, unl [Ln, N, F])."""
        N, Ln = self.cn.n, self.Ln
        lanes, dev = self.lanes, self.dev
        wave0 = is_recv[:, None] & (st["q_time"] == tmin[:, None])
        seqs = torch.where(wave0, st["q_seq"], INT_MAX)
        i0 = torch.argmin(seqs, 1)
        b = torch.where(is_recv, st["q_blk"][lanes, i0], 0).long()
        wave = wave0 & (st["q_blk"] == b[:, None])
        dvec = torch.zeros((Ln, N + 1), dtype=torch.bool, device=dev)
        dvec.scatter_(1, torch.where(wave, st["q_dst"], N).long(),
                      torch.ones_like(wave))
        dmask = dvec[:, :N]
        new["q_time"] = torch.where(wave, torch.inf, st["q_time"])

        pb = st["parent0"][lanes, b]
        pbc = torch.clamp(pb, min=0).long()
        pv = (pb < 0)[:, None] | st["vis"][lanes, :, pbc]
        known_b = st["known"][lanes, :, b]
        vis_b = st["vis"][lanes, :, b]
        deliver = dmask & ~vis_b & pv
        blocked = dmask & ~known_b & ~pv
        known = st["known"].clone()
        known[lanes, :, b] = known_b | dmask
        vis = st["vis"].clone()
        vis[lanes, :, b] = vis_b | deliver

        # a first arrival whose parent is invisible parks; overflow counts
        occ = st["pend"] >= 0
        has_free = ~occ.all(2)
        slot = torch.argmin(occ.to(I32), 2, keepdim=True)
        park = blocked & has_free
        pend2 = st["pend"].clone()
        pend2.scatter_(2, slot, torch.where(
            park, b[:, None].to(I32), st["pend"].gather(2, slot)[..., 0])
            [..., None])
        new["drop_p"] = st["drop_p"] + (blocked & ~has_free).sum(1).to(I32)
        self.prefer(st, new, b, pbc, deliver)

        # unlock: parked children whose parent just became visible
        pc = torch.clamp(pend2, min=0).long()
        par_p = st["parent0"].gather(1, pc.view(Ln, -1)).view(pc.shape)
        vis_par = (par_p < 0) | vis.gather(2, torch.clamp(par_p, min=0)
                                           .long())
        unl = (pend2 >= 0) & deliver[..., None] & vis_par
        new["pend"] = torch.where(unl, -1, pend2)
        new["known"], new["vis"] = known, vis
        return b, deliver, pend2, unl

    def prefer(self, st, new, b, pbc, deliver):
        """The delivering nodes' preference (engine.py:245-286), into
        `new["pref"]`: Nakamoto by height; Ethereum by height (Byzantium)
        or work (whitepaper), strictly; Bk and Spar move to the chain
        block (a vote's parent) by height, then visible confirming votes,
        then (Bk) the lower leader hash, after tallying a delivered vote
        into `conf` (and, Bk, clearing `noprop` and lowering `repl` by a
        delivered proposal's hash)."""
        p, lanes = self.proto, self.lanes
        H = st["height"]
        pref = st["pref"].long()
        if not (p.is_bk or p.is_spar):
            key = st["work"] if p.is_eth and not p.byz else H
            better = key[lanes, b][:, None] > key.gather(1, pref)
            new["pref"] = torch.where(deliver & better, b[:, None].to(I32),
                                      st["pref"])
            return
        is_v = st["is_vote"][lanes, b]
        dv = deliver & is_v[:, None]
        conf = st["conf"].clone()
        conf[lanes, :, pbc] += dv.to(I32)
        new["conf"] = conf
        bb = torch.where(is_v, pbc, b)
        hb, hp = H[lanes, bb][:, None], H.gather(1, pref)
        cb = conf[lanes, :, bb]
        cp = conf.gather(2, pref[..., None])[..., 0]
        tie = cb > cp
        if p.is_bk:
            dp = deliver & ~is_v[:, None]
            noprop = st["noprop"].clone()
            noprop[lanes, :, pbc] &= ~dv
            repl = st["repl"].clone()
            repl[lanes, :, pbc] = torch.minimum(
                repl[lanes, :, pbc],
                torch.where(dp, st["lhash"][lanes, b][:, None], 3.0))
            new["noprop"], new["repl"] = noprop, repl
            lh = st["lhash"]
            tie = tie | ((cb == cp) & (lh[lanes, bb][:, None]
                                       < lh.gather(1, pref)))
        better = (hb > hp) | ((hb == hp) & tie)
        new["pref"] = torch.where(deliver & better, bb[:, None].to(I32),
                                  st["pref"])

    def draws(self, k_mine, k_next, k_delay, logw, k_pow=None):
        """Steps' draws from their keys [..., Ln, 2]: the miner (Gumbel
        over the nodes' logits `logw`, [N] or [Ln, N]), the next
        activation's float64 exponential, the [N, N] link delays of
        k_delay (`sample_delay_matrix`) and, given k_pow, Bk's vote hash
        (a float32 uniform, which 64-bit mode draws as without it). The
        same bits as drawing each apart, taken in two threefry passes."""
        N, dev = self.cn.n, self.dev
        lead = k_mine.shape[:-1]
        ar = torch.arange(N * N, device=dev)
        ks = [k_mine[..., None, :].expand(*lead, N, 2), k_next[..., None, :],
              k_delay[..., None, :].expand(*lead, 2, 2)]
        if k_pow is not None:
            ks.append(k_pow[..., None, :])
        x0, x1 = rnd.threefry_words(torch.cat(ks, -2), self.counters)
        m = torch.argmax(rnd.gumbel_of_bits(rnd.from_words(
            x0[..., :N] ^ x1[..., :N])) + logw, -1)
        e_next = -torch.log1p(-rnd.uniform64_of_words(x0[..., N],
                                                      x1[..., N]))
        k_ue = rnd.from_words(torch.stack([x0[..., N + 1:N + 3],
                                           x1[..., N + 1:N + 3]], -1))
        y0, y1 = rnd.threefry_words(
            k_ue[..., None, :].expand(*lead, 2, N * N, 2)
            .reshape(*lead, 2 * N * N, 2), ar.repeat(2))
        u = clamp_uniform(rnd.uniform64_of_words(y0[..., :N * N],
                                                 y1[..., :N * N]))
        e = -torch.log1p(-rnd.uniform64_of_words(y0[..., N * N:],
                                                 y1[..., N * N:]))
        delay = delay_of_draws(self.kind, self.p0, self.p1,
                               u.view(*lead, N, N), e.view(*lead, N, N))
        if k_pow is None:
            return m, e_next, delay
        powh = rnd.uniform_of_bits(rnd.from_words(x0[..., N + 3]
                                                  ^ x1[..., N + 3]))
        return m, e_next, delay, powh

    def append(self, st, new, ok, parent, m):
        """Append one block per lane where `ok` (which implies room):
        parent, height, miner, visible and known at its miner."""
        self.append_at(st, new, ok, parent, st["height"][self.lanes, parent]
                       + 1, m)
        new["nb"] = st["nb"] + ok.to(I32)

    def append_at(self, st, new, ok, parent, height, src, **fields):
        """Write block nb's parent, height, miner (`src`) and `fields`
        (name -> [Ln] or [Ln, row] values) where `ok`, and make it visible
        and known at `src`; `new[f]` starts from `st[f]`."""
        lanes = self.lanes
        idx = torch.clamp(st["nb"], max=self.B - 1).long()
        fields = dict(fields, parent0=parent.to(I32), height=height.to(I32),
                      miner=src.to(I32))
        for f, v in fields.items():
            if new[f] is st[f]:
                new[f] = st[f].clone()
            old = new[f][lanes, idx]
            okv = ok.view(-1, *([1] * (old.dim() - 1)))
            new[f][lanes, idx] = torch.where(okv, v.to(old.dtype), old)
        for f in ("vis", "known"):
            new[f][lanes, src, idx] |= ok

    def push(self, st, new, delay, now2, send_src, s_blk, pend2, unl):
        """Queue the unlock re-queues (at now2) and the link sends of
        `s_blk` from each node in `send_src` (at now2 + the link's delay in
        `delay` [Ln, N, N]), in that order, into the free slots;
        candidates beyond the free slots are dropped and counted."""
        N, F, M, Ln = self.cn.n, self.F, self.M, self.Ln
        dev = self.dev
        C = N * F + N * N
        s_valid = send_src[..., None] & self.has_link
        s_time = now2[:, None, None] + delay
        c_valid = torch.cat([unl.reshape(Ln, -1), s_valid.reshape(Ln, -1)], 1)
        c_time = torch.cat([now2[:, None].expand(Ln, N * F),
                            s_time.reshape(Ln, -1)], 1)
        c_blk = torch.cat([torch.clamp(pend2, min=0).reshape(Ln, -1),
                           s_blk[:, None].to(I32).expand(Ln, N * N)], 1)
        free = ~torch.isfinite(new["q_time"])
        rank = torch.cumsum(c_valid.to(I32), 1, dtype=I32)
        n_valid = rank[:, -1]
        frank = torch.cumsum(free.to(I32), 1, dtype=I32)
        n_place = torch.minimum(n_valid, frank[:, -1])
        placed = c_valid & (rank <= n_place[:, None])
        r2c = torch.zeros((Ln, max(C, M) + 1), dtype=torch.long, device=dev)
        r2c.scatter_(1, torch.where(placed, rank, 0).long(),
                     self.c_ids.expand(Ln, C).contiguous())
        fill = free & (frank <= n_place[:, None])
        cidx = r2c.gather(1, torch.clamp(frank, 0, C).long())
        new["q_time"] = torch.where(fill, c_time.gather(1, cidx),
                                    new["q_time"])
        new["q_dst"] = torch.where(fill, self.c_dst[cidx], st["q_dst"])
        new["q_blk"] = torch.where(fill, c_blk.gather(1, cidx), st["q_blk"])
        new["q_seq"] = torch.where(fill, st["seq"][:, None] + frank,
                                   st["q_seq"])
        new["seq"] = st["seq"] + n_valid
        new["drop_q"] = st["drop_q"] + (n_valid - n_place)

    def flood_src(self, st, b, deliver):
        if not self.cn.flooding:
            return torch.zeros_like(deliver)
        return deliver & (st["miner"][self.lanes, b][:, None]
                          != self.arangeN)

    # -- the protocols' decisions ----------------------------------------

    def window(self, start):
        """Ledger slots [start, start + W) of each lane, [Ln, W]."""
        return start[:, None] + self.arW

    def bk_want(self, st):
        """[Ln, N]: node n wants to propose on its preferred block: a
        visible quorum (>= k confirming votes), an own vote among them, its
        best own hash below the best visible replacement's, and no failed
        attempt since its last vote landed (engine.py:181-188)."""
        pref = st["pref"].long()[..., None]

        def at(f):
            return st[f].gather(2, pref)[..., 0]

        return ((at("conf") >= self.proto.k) & (at("conf_own") >= 1)
                & (at("mybest") < at("repl")) & ~at("noprop"))

    def bk_proposal(self, st, want):
        """Bk's proposal step (engine.py:409-458): the proposer (lowest node
        that wants), its block, the quorum search over the W slots after
        it. Returns (jstar, pjs, mb, feasible, quorum row [Ln, k], count
        miss)."""
        p, lanes, B, W = self.proto, self.lanes, self.B, self.proto.W
        k = p.k
        jstar = torch.argmax(want.to(I32), 1)
        pjs = st["pref"][lanes, jstar].long()
        start = torch.clamp(pjs + 1, 0, max(B - W, 0))
        gi = self.window(start)
        ph = st["powh"].gather(1, gi)
        mn = st["miner"].gather(1, gi)
        onpar = ((st["parent0"].gather(1, gi) == pjs[:, None])
                 & st["is_vote"].gather(1, gi)
                 & st["vis"][lanes, jstar].gather(1, gi))
        mine = onpar & (mn == jstar[:, None])
        theirs = onpar & (mn != jstar[:, None])
        mb = st["mybest"][lanes, jstar, pjs]
        cand = theirs & (ph > mb[:, None])
        n_mine, n_cand = mine.sum(1), cand.sum(1)
        feasible = (n_mine >= k) | (n_mine + n_cand >= k)
        conf = st["conf"][lanes, jstar, pjs]
        own = st["conf_own"][lanes, jstar, pjs]
        miss = ~((n_mine == own) & (theirs.sum(1) == conf - own))
        # k smallest own hashes (a stable sort: ties by slot), padded with
        # candidate votes in ledger order
        mine_ord = torch.argsort(torch.where(mine, ph, 3.0), dim=1,
                                 stable=True)
        take = torch.clamp(n_mine, max=k)
        need = torch.clamp(k - n_mine, 0, k)
        iq = self.iq
        own_part = mine_ord[:, torch.clamp(iq, 0, W - 1)]
        their_part = rank_pick(cand, need, torch.clamp(
            iq[None, :] - take[:, None] + 1, 0, W))
        q_row = start[:, None] + torch.where(iq < take[:, None], own_part,
                                             their_part)
        return jstar, pjs, mb, feasible, q_row, miss

    def spar_quorum(self, st, m, pj):
        """Spar's draft at a mint (engine.py:368-407): a block iff the
        miner sees k - 1 confirming votes on its preferred block, and then
        its quorum, own votes first, each group in ledger order. Returns
        (can_block, quorum row [Ln, QW], count miss)."""
        p, lanes, B, W = self.proto, self.lanes, self.B, self.proto.W
        kq = p.k - 1
        conf = st["conf"][lanes, m, pj]
        own = st["conf_own"][lanes, m, pj]
        can_block = conf >= kq
        start = torch.clamp(pj + 1, 0, max(B - W, 0))
        gi = self.window(start)
        mn = st["miner"].gather(1, gi)
        onpar = ((st["parent0"].gather(1, gi) == pj[:, None])
                 & st["is_vote"].gather(1, gi)
                 & st["vis"][lanes, m].gather(1, gi))
        mine = onpar & (mn == m[:, None])
        theirs = onpar & (mn != m[:, None])
        n_mine, n_their = mine.sum(1), theirs.sum(1)
        miss = ~((n_mine == own) & (n_their == conf - own))
        take = torch.clamp(n_mine, max=kq)
        need = torch.clamp(kq - n_mine, 0, kq)
        iq = self.iq[None, :]
        own_part = rank_pick(mine, torch.full_like(n_mine, kq),
                             torch.clamp(iq + 1, 0, W).expand(len(m), -1))
        their_part = rank_pick(theirs, need, torch.clamp(
            iq - take[:, None] + 1, 0, W))
        q_row = start[:, None] + torch.where(iq < take[:, None], own_part,
                                             their_part)
        return can_block, torch.where(iq < kq, q_row, -1), miss

    def eth_uncles(self, st, m, tip):
        """Ethereum's uncle selection at a mint (engine.py:311-366): the
        miner's 6-generation chain window from `tip`, candidates in a
        W-slot ledger window from its deepest ancestor (visible to the
        miner, child of a window ancestor, not in the chain set), own
        first then the lower preference key, the first U taken. Returns
        (uncle row [Ln, U], n_unc, miss)."""
        p, lanes, B, W, U = (self.proto, self.lanes, self.B, self.proto.W,
                             self.proto.U)
        par = st["parent0"]
        ancs, cur = [], tip
        for _ in range(6):
            cur = torch.where(cur > 0, par[lanes, torch.clamp(cur, min=0)]
                              .long(), -1)
            ancs.append(cur)
        anc = torch.stack(ancs, 1)
        winb = torch.stack([tip] + ancs[:5], 1)
        in_chain = torch.cat([tip[:, None], anc, st["uncles"][
            lanes[:, None], torch.clamp(winb, min=0)].reshape(self.Ln, -1)],
            1)
        nb = st["nb"].long()
        start = torch.clamp(torch.minimum(
            torch.where(anc >= 0, anc, B).amin(1), nb), 0, max(B - W, 0))
        gi = self.window(start)
        key = (st["height"] if p.byz else st["work"]).gather(1, gi)
        par_in_anc = ((par.gather(1, gi)[:, :, None] == anc[:, None, :])
                      & (anc[:, None, :] >= 0)).any(2)
        not_chain = (gi[:, :, None] != in_chain[:, None, :]).all(2)
        cand = (st["vis"][lanes, m].gather(1, gi) & par_in_anc & not_chain
                & (gi < nb[:, None]))
        skey = torch.where(cand, torch.where(
            st["miner"].gather(1, gi) == m[:, None], 0.0, 1e6)
            + key.to(F32), 1e9)
        order = torch.argsort(skey, dim=1, stable=True)
        n_cand = cand.sum(1)
        n_unc = torch.clamp(n_cand, max=U)
        row = torch.where(self.iu < n_unc[:, None], start[:, None] + order[
            :, torch.clamp(self.iu, 0, W - 1)], -1)
        miss = (nb > start + W) | ((not p.byz) & (n_cand > U))
        return row, n_unc, miss

    def run(self, body, S, n_split, slots, logw):
        """Step every lane with `body(st, *draws) -> new state` while it is
        live and under S steps; a finished lane keeps its state. A step
        splits the carry's key `n_split` ways, carries the first and draws
        (`draws`) from the subkeys at `slots` (miner, next activation,
        link delays[, Bk's vote hash]). A chunk of steps splits its keys
        one step after another, then draws from all of them at once: the
        same bits as drawing step by step, in two threefry passes a chunk
        instead of two a step. On the card a chunk is captured once as a
        CUDA graph and replayed (a step is a few hundred small launches,
        which the host cannot launch as fast as the card runs them)."""

        def steps(st, key):
            ks = []
            for _ in range(DRAW_CHUNK):
                ks.append(rnd.split(key, n_split))
                key = ks[-1][:, 0]
            ks = torch.stack(ks)
            d = self.draws(*(ks[:, :, j] for j in slots[:3]), logw,
                           *(ks[:, :, j] for j in slots[3:]))
            for t in range(DRAW_CHUNK):
                go = st["live"] & (st["steps"] < S)
                new = body(st, *(x[t] for x in d))
                st = {k: torch.where(go.view(-1, *([1] * (v.dim() - 1))),
                                     new[k], v) for k, v in st.items()}
            return st, key

        def going(st):
            return bool((st["live"] & (st["steps"] < S)).any())

        st, key = self.st, self.key
        if st["live"].is_cuda:
            st, key = self._graphed(steps, st, key, going)
        while going(st):
            st, key = steps(st, key)
        self.st, self.key = st, key
        return st

    @staticmethod
    def _graphed(steps, st, key, going):
        """Run `steps` (functional: it reads its inputs and returns new
        tensors) as one CUDA graph over static copies of (st, key) until
        no lane goes; returns the copies."""
        st = {k: v.clone() for k, v in st.items()}
        key = key.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up, as graph capture asks
            steps({k: v.clone() for k, v in st.items()}, key.clone())
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            new, new_key = steps(st, key)
            for k, v in new.items():
                st[k].copy_(v)
            key.copy_(new_key)
        while going(st):
            graph.replay()
        return st, key

    def reward_walk(self, head, length):
        """float32 reward per node along head's chain, at most `length`
        blocks, and (Ethereum) the blocks plus uncles on it [Ln] int32
        (engine.py:638-689): Nakamoto 1 a block; Bk and Spar k a block
        (`block`) or 1 a quorum vote and (Spar) 1 the block (`constant`);
        Ethereum 1 + 1/32 an uncle to the miner and (8 - depth) / 8
        (Byzantium) or 15/16 (whitepaper) to each uncle's miner."""
        st, lanes, p = self.st, self.lanes, self.proto
        N = self.cn.n
        rew = torch.zeros((self.Ln, N + 1), dtype=F32, device=self.dev)
        onc = torch.zeros(self.Ln, dtype=I32, device=self.dev)
        miner, H = st["miner"], st["height"]
        cur = head.long()
        for _ in range(length):
            ok = cur > 0
            if not bool(ok.any()):
                break
            mn = torch.where(ok, miner[lanes, cur].long(), N)
            if p.protocol == "nakamoto":
                rew[lanes, mn] += 1.0
            elif (p.is_bk or p.is_spar) and p.scheme == "block":
                rew[lanes, mn] += float(p.k)
            elif p.is_bk or p.is_spar:
                if p.is_spar:
                    rew[lanes, mn] += 1.0
                qr = st["quorum"][lanes, cur]
                vm = miner.gather(1, torch.clamp(qr, min=0).long())
                rew.scatter_add_(1, torch.where(ok[:, None] & (qr >= 0),
                                                vm.long(), N),
                                 torch.ones(qr.shape, dtype=F32,
                                            device=self.dev))
            else:
                urow = st["uncles"][lanes, cur]
                nu = (urow >= 0).sum(1).to(I32)
                rew[lanes, mn] += 1.0 + nu.to(F32) * 0.03125
                uc = torch.clamp(urow, min=0).long()
                if p.byz:
                    amt = (8.0 - (H[lanes, cur][:, None] - H.gather(1, uc))
                           .to(F32)) / 8.0
                else:
                    amt = torch.full(urow.shape, 0.9375, dtype=F32,
                                     device=self.dev)
                rew.scatter_add_(1, torch.where(
                    ok[:, None] & (urow >= 0), miner.gather(1, uc).long(),
                    N), amt)
                onc = onc + torch.where(ok, 1 + nu, 0)
            cur = torch.where(ok, st["parent0"][lanes, cur].long(), 0)
        return rew[:, :N], onc


def event_plain(cn: CompiledNet, A: int, B: int, M: int, F: int, S: int,
                keys, delays, proto: Proto = NAKAMOTO) -> dict:
    """Plain version of K12-event (Nakamoto) and of K12-event-bk, -eth and
    -spar (`proto`): the JAX package's `_lane_fn` (engine.py:92-713) over
    lanes, same RNG stream (5-way split a step: carry, miner, Bk's vote
    hash, next activation, link delays). A step is a Bk proposal (no time
    advance) when some node wants to propose, else an activation or a
    delivery wave; a mint drafts the protocol's block (Nakamoto: a child
    of the miner's preference; Bk: a vote; Ethereum: a block with its
    uncles; Spar: a block with its k - 1 vote quorum, or a vote). Also
    returns `margin` [Ln] (`EventLedger.timing`), and for the protocols
    other than Nakamoto `progress` and `on_chain`."""
    led = EventLedger(cn, A, B, M, F, keys, delays, proto)
    logw = log_compute(cn, led.dev)
    lanes, dev = led.lanes, led.dev
    p = proto
    false = torch.zeros(led.Ln, dtype=torch.bool, device=dev)

    def body(st, m, e_next, delay, powh_new=None):
        new = dict(st)
        tmin, act_now, recv_ok = led.timing(st, new)
        if p.is_bk:
            want = led.bk_want(st)
            is_prop = want.any(1)
        else:
            is_prop = false
        is_act = ~is_prop & act_now
        is_recv = ~is_prop & ~act_now & recv_ok
        now2 = torch.where(is_act, st["next_act"],
                           torch.where(is_recv, tmin, st["now"]))
        b, deliver, pend2, unl = led.deliver_wave(st, new, is_recv, tmin)

        new["next_act"] = torch.where(
            is_act, st["next_act"] + e_next * led.delays, st["next_act"])
        parent_act = st["pref"][lanes, m].long()
        h_parent = st["height"][lanes, parent_act]
        new["n_act"] = st["n_act"] + is_act.to(I32)
        new["node_act"] = st["node_act"].clone()
        new["node_act"][lanes, m] += is_act.to(I32)
        nb = st["nb"].long()
        win_miss = st.get("win_miss")
        ok_act = is_act & (nb < B)
        if p.is_eth:
            u_row, n_unc, miss = led.eth_uncles(st, m, parent_act)
            win_miss = win_miss + (is_act & miss).to(I32)
            a_work = st["work"][lanes, parent_act] + 1 + n_unc
        if p.is_spar:
            can_block, q_row, miss = led.spar_quorum(st, m, parent_act)
            win_miss = win_miss + (is_act & can_block & miss).to(I32)
        if p.is_bk:
            jstar, pjs, mb, feasible, q_row, miss = led.bk_proposal(st, want)
            win_miss = win_miss + (is_prop & miss).to(I32)
            ok_prop = is_prop & feasible & (nb < B)
            fail = is_prop & ~(feasible & (nb < B))
        else:
            ok_prop = false
        app = ok_act | ok_prop
        new["drop_b"] = st["drop_b"] + ((is_act | ok_prop)
                                        & (nb >= B)).to(I32)
        if win_miss is not None:
            new["win_miss"] = win_miss

        src = m
        if p.is_bk:
            src = torch.where(is_act, m, jstar)
            led.append_at(
                st, new, app, torch.where(is_act, parent_act, pjs),
                torch.where(is_act, h_parent,
                            st["height"][lanes, pjs] + 1), src,
                is_vote=is_act,
                powh=torch.where(is_act, powh_new, 2.0),
                lhash=torch.where(is_act, 2.0, mb),
                quorum=torch.where(is_act[:, None], -1, q_row))
            # a failed attempt marks (proposer, block); a vote clears it
            # (and any mark of its miner on its parent) and tallies
            noprop = new["noprop"].clone()
            noprop[lanes, jstar, pjs] |= fail
            noprop[lanes, m, parent_act] &= ~ok_act
            new["noprop"] = noprop
            for f in ("conf", "conf_own"):
                plane = new[f].clone()
                plane[lanes, m, parent_act] += ok_act.to(I32)
                new[f] = plane
            mybest = st["mybest"].clone()
            mybest[lanes, m, parent_act] = torch.minimum(
                mybest[lanes, m, parent_act],
                torch.where(ok_act, powh_new, 3.0))
            new["mybest"] = mybest
            repl = new["repl"].clone()
            repl[lanes, jstar, pjs] = torch.where(
                ok_prop, torch.minimum(repl[lanes, jstar, pjs], mb),
                repl[lanes, jstar, pjs])
            new["repl"] = repl
            moved = (led.arangeN == jstar[:, None]) & ok_prop[:, None]
        elif p.is_spar:
            vote = ok_act & ~can_block
            led.append_at(st, new, app, parent_act,
                          h_parent + can_block.to(I32), m,
                          is_vote=~can_block,
                          quorum=torch.where(can_block[:, None], q_row, -1))
            for f in ("conf", "conf_own"):
                plane = new[f].clone()
                plane[lanes, m, parent_act] += vote.to(I32)
                new[f] = plane
            moved = (led.arangeN == m[:, None]) & (ok_act
                                                   & can_block)[:, None]
        else:
            led.append_at(st, new, app, parent_act, h_parent + 1, m,
                          **(dict(work=a_work, uncles=u_row) if p.is_eth
                             else {}))
            moved = (led.arangeN == m[:, None]) & ok_act[:, None]
        new["pref"] = torch.where(moved, st["nb"][:, None], new["pref"])
        new["nb"] = st["nb"] + app.to(I32)

        sent = (led.arangeN == src[:, None]) & app[:, None]
        send = torch.where(is_recv[:, None], led.flood_src(st, b, deliver),
                           sent)
        s_blk = torch.where(is_recv, b, nb)
        led.push(st, new, delay, now2, send, s_blk, pend2, unl)
        new.update(now=now2, steps=st["steps"] + 1)
        tmin2 = new["q_time"].amin(1)
        live = (new["n_act"] < A) | ((tmin2 < new["next_act"])
                                     & torch.isfinite(tmin2))
        if p.is_bk:
            live = live | led.bk_want(new).any(1)
        new["live"] = live
        return new

    # a step splits 5 ways: carry, miner, Bk's vote hash, next activation,
    # delays
    st = led.run(body, S, 5, (1, 3, 4, 2) if p.is_bk else (1, 3, 4), logw)
    return _finalize(led, st, A, S)


def _finalize(led, st, A, S):
    """The winner, the reward walk and (but Nakamoto) progress and
    on_chain (engine.py:599-704): Nakamoto scores a node's preferred block
    by its height, Bk and Spar by h * (A + 1) + its votes in float64,
    Ethereum by the preference key; the head is the first maximum's
    block. The walk covers A // k + 3 blocks under Bk and Spar, A + 2
    otherwise."""
    p, lanes = led.proto, led.lanes
    H = st["height"]
    pref = st["pref"].long()
    if p.is_bk or p.is_spar:
        votes = torch.zeros_like(H).scatter_add_(
            1, torch.clamp(st["parent0"], min=0).long(),
            st["is_vote"].to(I32))
        score = (H.gather(1, pref).to(F64) * (A + 1.0)
                 + votes.gather(1, pref).to(F64))
        walk = A // max(p.k, 1) + 3
    else:
        key = st["work"] if p.is_eth and not p.byz else H
        score = key.gather(1, pref)
        walk = A + 2
    head = st["pref"][lanes, torch.argmax(score, 1)]
    hh = H[lanes, head.long()]
    reward, onc = led.reward_walk(head, walk)
    out = dict(head=head, head_height=hh, sim_time=st["now"],
               n_blocks=st["nb"] - 1, n_act=st["n_act"],
               node_act=st["node_act"], reward=reward, steps=st["steps"],
               drop_q=st["drop_q"], drop_p=st["drop_p"], drop_b=st["drop_b"],
               win_miss=st.get("win_miss", torch.zeros_like(st["drop_b"])),
               exhausted=st["live"] & (st["steps"] >= S),
               margin=st["margin"])
    if p.is_bk:
        progress, on_chain = hh * p.k, hh * (p.k + 1)
    elif p.is_spar:
        progress, on_chain = hh * p.k, hh * p.k
    elif p.is_eth:
        progress = st["work"][lanes, head.long()] if p.byz else hh
        on_chain = onc
    else:
        return out  # `finish` gives both as the head's height
    out.update(progress=progress.to(F64), on_chain=on_chain.to(F64))
    return out


# -- the engine ---------------------------------------------------------------

def node_slots(n: int) -> int:
    """The kernels' node bucket of an n-node network: nodes a thread of
    the lane's warp holds (csrc/netsim.cuh `node_slots`); 0 past
    KERNEL_MAX_NODES."""
    return next((s for s in KERNEL_NODE_SLOTS if n <= 32 * s), 0)


def kernel_name(base: str, n: int) -> str:
    """The launch counter of kernel `base` on n nodes: `base` up to 32
    nodes, `base-n<32 * slots>` past them (K13-n128 for 101 nodes).
    K12-scan has one build past 32 nodes, its 8-slot one
    (csrc/netsim_scan.cu): K12-scan-n256 from 33 nodes."""
    s = node_slots(n)
    if base == "K12-scan" and s > 1:
        s = KERNEL_NODE_SLOTS[-1]
    return base if s == 1 else f"{base}-n{32 * max(s, 1)}"


def kernel_node_limit(lane=None, smem=None) -> int:
    """The most nodes a netsim kernel takes: KERNEL_MAX_NODES (8 node
    slots a thread); for an event kernel whose lane holds `lane` = (queue
    M, F pending blocks a node, protocol scratch bytes), the largest n
    whose lane's shared memory (`kernels.event_smem` at n's node slots,
    plus the scratch) fits a block beside the kernel's static shared
    memory: `smem(slots)` gives (static bytes, a block's bytes) of the
    compiled kernel on the current card (`kernels.netsim_smem`); without
    it, none static and an H100's 227 KB a block."""
    if lane is None:
        return KERNEL_MAX_NODES
    from cpr_tpu_torch.kernels import SMEM_PER_BLOCK, event_smem
    M, F, extra = lane
    n = KERNEL_MAX_NODES
    while n > 0:
        static, block = (smem(node_slots(n)) if smem is not None
                         else (0, SMEM_PER_BLOCK))
        if static + event_smem(M, F, node_slots(n)) + extra <= block:
            break
        n -= 1
    return n


def check_kernel_nodes(n: int, what: str, lane=None, smem=None,
                       B=None) -> None:
    """Refuses before any launch: NotImplementedError naming `what`, the
    limit and ROADMAP item 11b where n nodes exceed `kernel_node_limit(
    lane, smem)`; ValueError where a ledger of B blocks outgrows a queue
    entry's block field."""
    limit = kernel_node_limit(lane, smem)
    if n > limit:
        why = ("8 node slots a thread of the lane's warp"
               if limit == KERNEL_MAX_NODES else
               "the lane's queue and pending buffers in a block's shared "
               "memory")
        raise NotImplementedError(
            f"{what} on the card takes at most {limit} nodes ({why}); "
            f"{n} nodes are queued (ROADMAP item 11b); device='cpu' runs "
            f"the plain version")
    if B is not None and B >= KERNEL_MAX_BLOCKS:
        raise ValueError(f"{what}: a ledger of {B} blocks exceeds the "
                         f"queue's block field (< {KERNEL_MAX_BLOCKS})")


def lane_keys(seeds, device) -> torch.Tensor:
    """64-bit mode PRNG keys [L, 2] of the seeds."""
    words = np.array([[(int(s) & (2**64 - 1)) >> 32, int(s) & 0xFFFFFFFF]
                      for s in seeds], dtype=np.uint32).reshape(-1, 2)
    return rnd.from_numpy_words(words, device)


def finish(out: dict) -> dict:
    """Numpy arrays of the lanes' outputs. The Nakamoto paths (K12-scan,
    K12-event, K13 and their plain versions) leave out progress and
    on_chain, which are the head's height there; the other protocols'
    finalize returns its own."""
    if "progress" not in out:
        hh = out["head_height"].to(F64)
        out = dict(out, progress=hh, on_chain=hh.clone())
    return {k: v.cpu().numpy() for k, v in out.items()}


def load_kernels(tele, name: str, seen: set, lanes: int, device) -> None:
    """The `<name>:compile` span the first time an engine runs `lanes`
    lanes (the JAX package compiles a program per lane count): on the
    card it covers building and loading the kernels, which happens once
    a process."""
    if lanes in seen:
        return
    with tele.span(f"{name}:compile", lanes=lanes):
        if device.type == "cuda":
            from cpr_tpu_torch import kernels
            kernels._load()
    seen.add(lanes)


class Engine:
    """One netsim configuration: fixed topology, protocol and activation
    target; `run()` executes a batch of lanes (independent seed /
    activation-delay pairs) on the card, or with `device="cpu"` through
    the plain versions.

        eng = Engine(net, protocol="nakamoto", activations=10_000)
        out = eng.run(seeds=[0, 1, 2], activation_delays=[60.0] * 3)

    Returns numpy arrays keyed like the JAX package's (head, head_height,
    progress, on_chain, sim_time, n_blocks, n_act, node_act, reward,
    steps, drop_q, drop_p, drop_b, win_miss, exhausted) with a leading
    lane axis; the capacity counters and `exhausted` are zero on a
    healthy run.
    """

    def __init__(self, net, *, protocol: str = "nakamoto", k: int = 1,
                 scheme: str = "constant", activations: int,
                 block_cap: int | None = None,
                 queue_cap: int | None = None, pend_cap: int = 8,
                 window: int | None = None, uncle_cap: int | None = None,
                 max_steps: int | None = None, x64: bool = True,
                 mode: str = "auto", lookback: int = 32,
                 mesh=None, mesh_axis: str = "d", device=None):
        if protocol not in SUPPORTED_PROTOCOLS:
            raise ValueError(
                f"netsim supports protocols {SUPPORTED_PROTOCOLS}, "
                f"not '{protocol}'")
        scheme = scheme or "constant"
        if protocol in ("bk", "spar") and (k < 1
                                           or scheme not in _SCHEMES):
            raise ValueError(
                f"{protocol} needs k >= 1 and scheme in {_SCHEMES} "
                f"(got k={k}, scheme='{scheme}')")
        self.net = (net if isinstance(net, CompiledNet)
                    else compile_network(net))
        if mode not in ("auto", "event", "scan"):
            raise ValueError(f"mode must be auto/event/scan, not '{mode}'")
        scan_ok = protocol == "nakamoto" and not self.net.flooding
        if mode == "scan" and not scan_ok:
            raise ValueError(
                "scan mode needs nakamoto + simple dissemination "
                "(state-independent arrival times); use mode='event'")
        if not x64:
            raise NotImplementedError(
                "the port's netsim keeps float64 clocks; x64=False is "
                "queued (ROADMAP item 11b)")
        if mesh is not None:
            raise NotImplementedError(
                "netsim mesh= (lanes sharded over devices) is not ported "
                "yet (ROADMAP item 13)")
        del mesh_axis
        self.protocol = protocol
        self.k = int(k)
        self.scheme = scheme
        self.activations = int(activations)
        n, a = self.net.n, self.activations
        if protocol == "bk":
            # per chain height up to min(N, k) nodes hold own votes and may
            # each propose (plus replacements) before the winner spreads
            self.B = block_cap or (
                a + min(n, self.k) * (a // max(self.k, 1) + 2) + 64)
        else:
            # every activation appends one PoW item (Spar votes included)
            self.B = block_cap or a + 2
        # Byzantium's uncle cap of 2 is the protocol's; the whitepaper's is
        # unbounded, so a fixed budget applies and overflow counts as a
        # window miss
        self.U = int(uncle_cap or (2 if protocol == "ethereum-byzantium"
                                   else 8))
        self.M = queue_cap or max(256, 16 * n)
        self.F = int(pend_cap)
        self.W = min(self.B, window or max(256, 32 * (self.k + n)))
        self.S = max_steps or a * (n + 4) + 4096
        self.proto = Proto(protocol, self.k, scheme, self.W, self.U)
        self.x64 = True
        self.mode = "scan" if (mode == "auto" and scan_ok) or \
            mode == "scan" else "event"
        self.lookback = int(lookback)
        self.device = _device.resolve(device)
        if self.device.type == "cuda":
            check_kernel_nodes(n, self.kernel, self.kernel_lane(),
                               B=None if self.mode == "scan" else self.B)
        self._seen = set()  # lane counts run

    @property
    def kernel(self) -> str:
        """The kernel this engine launches on the card (its base name)."""
        if self.mode == "scan":
            return "K12-scan"
        if self.protocol == "nakamoto":
            return "K12-event"
        from cpr_tpu_torch.kernels import PROTOCOL_KERNELS
        return f"K12-event-{PROTOCOL_KERNELS[self.protocol]}"

    def kernel_lane(self):
        """What sizes the event kernels' shared memory a lane at this
        engine's sizing (`kernel_node_limit`'s `lane`): the queue, the
        pending blocks a node and the protocol's scratch bytes; None for
        the scan kernel, which takes none."""
        if self.mode == "scan":
            return None
        from cpr_tpu_torch import kernels
        return (self.M, self.F, 0 if self.protocol == "nakamoto" else
                kernels.proto_smem(self.W, self.proto.QW, self.U))

    def run(self, seeds, activation_delays) -> dict:
        """Execute len(seeds) lanes (paired with activation_delays);
        returns numpy arrays with lane axis 0."""
        seeds = list(seeds)
        delays = list(activation_delays)
        if len(seeds) != len(delays):
            raise ValueError("seeds and activation_delays must pair up")
        L = len(seeds)
        tele = telemetry.current()
        keys = lane_keys(seeds, self.device)
        dl = torch.tensor(delays, dtype=F64, device=self.device)
        load_kernels(tele, "netsim", self._seen, L, self.device)
        with tele.span("netsim:run", lanes=L,
                       activations=L * self.activations) as sp:
            out = sp.fence(self.lanes(keys, dl))
        out = finish(out)
        tele.event("netsim", protocol=self.protocol, lanes=L,
                   activations=int(np.sum(out["n_act"])),
                   steps=int(np.max(out["steps"])),
                   drops=int(out["drop_q"].sum() + out["drop_p"].sum()
                             + out["drop_b"].sum()
                             + out["win_miss"].sum()))
        self._emit_device_metrics(out)
        return out

    def _emit_device_metrics(self, out):
        """The run's cells under CPR_DEVICE_METRICS=1 (the reference's
        engine.py:1084-1097): steps and the three drop counters summed
        over the lanes' outputs. Those are host arrays in both packages,
        so the fold is the plain one, on a CPU accumulator."""
        from cpr_tpu_torch import device_metrics as dm

        if not dm.enabled():
            return
        spec = (dm.MetricsSpec().counter("steps").counter("queue_drops")
                .counter("pending_drops").counter("ledger_drops"))
        acc = spec.fold(spec.init("cpu"), [
            dm.count_op(cell, torch.from_numpy(np.asarray(out[k])))
            for cell, k in (("steps", "steps"), ("queue_drops", "drop_q"),
                            ("pending_drops", "drop_p"),
                            ("ledger_drops", "drop_b"))])
        dm.emit("netsim", spec, acc, protocol=self.protocol)

    def lanes(self, keys, delays) -> dict:
        """The lanes' outputs as tensors on the keys' device: K12-scan,
        K12-event or the protocol's K12-event-bk/-eth/-spar on CUDA, the
        plain versions on the CPU."""
        A = self.activations
        if keys.is_cuda:
            from cpr_tpu_torch import kernels
            if self.mode == "scan":
                return kernels.netsim_scan(self.net, A, self.lookback, keys,
                                           delays)
            if self.protocol == "nakamoto":
                return kernels.netsim_event(self.net, A, self.B, self.M,
                                            self.F, self.S, keys, delays)
            return kernels.netsim_event_protocol(
                self.net, self.proto, A, self.B, self.M, self.F, self.S,
                keys, delays)
        if self.mode == "scan":
            out = scan_plain(self.net, A, self.lookback, keys, delays)
        else:
            out = event_plain(self.net, A, self.B, self.M, self.F, self.S,
                              keys, delays, self.proto)
        out.pop("margin")
        return out


def grid(seeds, activation_delays):
    """Cartesian (delay-major) lane grid: returns (seed_list,
    delay_list) ready for `Engine.run`."""
    ss, dd = [], []
    for d in activation_delays:
        for s in seeds:
            ss.append(int(s))
            dd.append(float(d))
    return ss, dd
