"""The multi-node network simulator (port of cpr_tpu/netsim/engine.py),
Nakamoto only.

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
  activation. Kernel K12-event (`csrc/netsim_event.cu` over
  `csrc/netsim_event.cuh`), plain version `event_plain`.

Both keep the JAX package's semantics, RNG stream and outputs. Times are
float64 (the JAX package runs the netsim under 64-bit mode, so the lane
keys are 64-bit mode keys and the clocks are float64 draws). The
activation times are a sequential running sum in both the kernel and
the plain version; XLA:CPU's float64 cumsum adds in another order, so
they equal the JAX package's only to a relative 1e-12 or so, and an
integer output can differ only where a decision compared two times
closer than that (the plain versions return that smallest gap as
`margin`).

Not ported: the bk, Ethereum and Spar event branches (ROADMAP item 11b),
`x64=False` (float32 clocks, item 11b), `mesh=` (item 13) and the
CPR_DEVICE_METRICS cells (item 14): each raises, naming its item. The
kernels hold one node per thread of a warp, so they take N <= 32 nodes
(item 11b); the plain versions take any N.
"""

from __future__ import annotations

import os

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
# the kernels hold one node per thread of a warp (csrc/netsim.cuh)
KERNEL_MAX_NODES = 32

F64, F32, I32 = torch.float64, torch.float32, torch.int32
INT_MAX = 2**31 - 1
# steps whose draws the plain event engines take at once (`EventLedger.run`)
DRAW_CHUNK = 64


def supports(protocol: str, k: int = 1, scheme: str = "constant") -> bool:
    """True when the JAX package's engine implements this protocol config
    (the port runs Nakamoto; the others raise, naming ROADMAP item
    11b)."""
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


# -- plain version of K12-event -----------------------------------------------

class EventLedger:
    """The plain event engines' per-lane state: the block ledger (parent,
    height, miner, per-node visibility and first-arrival bits), node
    preferences, the message queue and the pending buffers. Field names
    follow the JAX package's state dict. The JAX package also carries
    per-node arrival times `vis_at`, which nothing reads; the port drops
    them."""

    def __init__(self, cn, A, B, M, F, keys, delays):
        N = cn.n
        dev = keys.device
        Ln = keys.shape[0]
        self.cn, self.A, self.B, self.M, self.F = cn, A, B, M, F
        self.dev, self.Ln = dev, Ln
        self.delays = delays
        self.kind, self.p0, self.p1 = planes(cn, dev)
        self.has_link = self.kind >= 0
        self.arangeN = torch.arange(N, device=dev)
        self.lanes = torch.arange(Ln, device=dev)
        # constants of a step, made here: `run` may capture the steps in
        # a CUDA graph, where no host value may be copied to the card
        self.counters = torch.cat([self.arangeN, torch.tensor(
            [0, 0, 1], device=dev)])          # the first draw pass's
        self.c_dst = torch.cat([self.arangeN.repeat_interleave(F),
                                self.arangeN.repeat(N)]).to(I32)
        self.c_ids = torch.arange(N * F + N * N, device=dev)
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
        pref/q_time into `new` and returns (b, deliver [Ln, N], pend2,
        unl [Ln, N, F])."""
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

        better = (st["height"][lanes, b][:, None]
                  > st["height"].gather(1, st["pref"].long()))
        new["pref"] = torch.where(deliver & better, b[:, None].to(I32),
                                  st["pref"])

        # unlock: parked children whose parent just became visible
        pc = torch.clamp(pend2, min=0).long()
        par_p = st["parent0"].gather(1, pc.view(Ln, -1)).view(pc.shape)
        vis_par = (par_p < 0) | vis.gather(2, torch.clamp(par_p, min=0)
                                           .long())
        unl = (pend2 >= 0) & deliver[..., None] & vis_par
        new["pend"] = torch.where(unl, -1, pend2)
        new["known"], new["vis"] = known, vis
        return b, deliver, pend2, unl

    def draws(self, k_mine, k_next, k_delay, logw):
        """Steps' draws from their keys [..., Ln, 2]: the miner (Gumbel
        over the nodes' logits `logw`, [N] or [Ln, N]), the next
        activation's float64 exponential, and the [N, N] link delays of
        k_delay (`sample_delay_matrix`). The same bits as drawing each
        apart, taken in two threefry passes."""
        N, dev = self.cn.n, self.dev
        lead = k_mine.shape[:-1]
        ar = torch.arange(N * N, device=dev)
        ks = torch.cat([k_mine[..., None, :].expand(*lead, N, 2),
                        k_next[..., None, :],
                        k_delay[..., None, :].expand(*lead, 2, 2)], -2)
        x0, x1 = rnd.threefry_words(ks, self.counters)
        m = torch.argmax(rnd.gumbel_of_bits(rnd.from_words(
            x0[..., :N] ^ x1[..., :N])) + logw, -1)
        e_next = -torch.log1p(-rnd.uniform64_of_words(x0[..., N],
                                                      x1[..., N]))
        k_ue = rnd.from_words(torch.stack([x0[..., N + 1:], x1[..., N + 1:]],
                                          -1))
        y0, y1 = rnd.threefry_words(
            k_ue[..., None, :].expand(*lead, 2, N * N, 2)
            .reshape(*lead, 2 * N * N, 2), ar.repeat(2))
        u = clamp_uniform(rnd.uniform64_of_words(y0[..., :N * N],
                                                 y1[..., :N * N]))
        e = -torch.log1p(-rnd.uniform64_of_words(y0[..., N * N:],
                                                 y1[..., N * N:]))
        delay = delay_of_draws(self.kind, self.p0, self.p1,
                               u.view(*lead, N, N), e.view(*lead, N, N))
        return m, e_next, delay

    def append(self, st, new, ok, parent, m):
        """Append one block per lane where `ok` (which implies room):
        parent, height, miner, visible and known at its miner."""
        lanes = self.lanes
        idx = torch.clamp(st["nb"], max=self.B - 1).long()
        for f, v in (("parent0", parent.to(I32)),
                     ("height", st["height"][lanes, parent] + 1),
                     ("miner", m.to(I32))):
            new[f] = st[f].clone()
            new[f][lanes, idx] = torch.where(ok, v, st[f][lanes, idx])
        for f in ("vis", "known"):
            new[f][lanes, m, idx] |= ok
        new["nb"] = st["nb"] + ok.to(I32)

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

    def run(self, body, S, n_split, slots, logw):
        """Step every lane with `body(st, m, e_next, delay) -> new state`
        while it is live and under S steps; a finished lane keeps its
        state. A step splits the carry's key `n_split` ways, carries the
        first and draws (`draws`) from the subkeys at `slots` (miner,
        next activation, link delays). A chunk of steps splits its keys
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
            m, e_next, delay = self.draws(*(ks[:, :, j] for j in slots),
                                          logw)
            for t in range(DRAW_CHUNK):
                go = st["live"] & (st["steps"] < S)
                new = body(st, m[t], e_next[t], delay[t])
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
        """float32 reward per node along head's chain."""
        st, lanes = self.st, self.lanes
        N = self.cn.n
        rew = torch.zeros((self.Ln, N + 1), dtype=F32, device=self.dev)
        cur = head.long()
        for _ in range(length):
            ok = cur > 0
            if not bool(ok.any()):
                break
            rew[lanes, torch.where(ok, st["miner"][lanes, cur].long(), N)] \
                += 1.0
            cur = torch.where(ok, st["parent0"][lanes, cur].long(), 0)
        return rew[:, :N]


def event_plain(cn: CompiledNet, A: int, B: int, M: int, F: int, S: int,
                keys, delays) -> dict:
    """Plain version of K12-event: the JAX package's Nakamoto `_lane_fn`
    (engine.py:92-715 without the bk, Ethereum and Spar branches) over
    lanes, same RNG stream (5-way split a step: carry, miner, unused,
    next activation, link delays). Also returns `margin` [Ln]
    (`EventLedger.timing`)."""
    led = EventLedger(cn, A, B, M, F, keys, delays)
    logw = log_compute(cn, led.dev)
    lanes = led.lanes

    def body(st, m, e_next, delay):
        new = dict(st)
        tmin, act_now, recv_ok = led.timing(st, new)
        is_act, is_recv = act_now, ~act_now & recv_ok
        now2 = torch.where(is_act, st["next_act"],
                           torch.where(is_recv, tmin, st["now"]))
        b, deliver, pend2, unl = led.deliver_wave(st, new, is_recv, tmin)

        new["next_act"] = torch.where(
            is_act, st["next_act"] + e_next * led.delays, st["next_act"])
        parent_act = st["pref"][lanes, m].long()
        new["n_act"] = st["n_act"] + is_act.to(I32)
        new["node_act"] = st["node_act"].clone()
        new["node_act"][lanes, m] += is_act.to(I32)
        ok_act = is_act & (st["nb"] < B)
        new["drop_b"] = st["drop_b"] + (is_act & (st["nb"] >= B)).to(I32)
        led.append(st, new, ok_act, parent_act, m)
        mine = (led.arangeN == m[:, None]) & ok_act[:, None]
        new["pref"] = torch.where(mine, st["nb"][:, None], new["pref"])

        send = torch.where(is_recv[:, None], led.flood_src(st, b, deliver),
                           mine)
        s_blk = torch.where(is_recv, b, st["nb"].long())
        led.push(st, new, delay, now2, send, s_blk, pend2, unl)
        new.update(now=now2, steps=st["steps"] + 1)
        tmin2 = new["q_time"].amin(1)
        new["live"] = (new["n_act"] < A) | ((tmin2 < new["next_act"])
                                            & torch.isfinite(tmin2))
        return new

    # a step splits 5 ways: carry, miner, unused, next activation, delays
    st = led.run(body, S, 5, (1, 3, 4), logw)
    hp = st["height"].gather(1, st["pref"].long())
    head = st["pref"][lanes, torch.argmax(hp, 1)]
    out = dict(head=head, head_height=st["height"][lanes, head.long()],
               sim_time=st["now"], n_blocks=st["nb"] - 1, n_act=st["n_act"],
               node_act=st["node_act"],
               reward=led.reward_walk(head, A + 2), steps=st["steps"],
               drop_q=st["drop_q"], drop_p=st["drop_p"],
               drop_b=st["drop_b"],
               win_miss=torch.zeros_like(st["drop_b"]),
               exhausted=st["live"] & (st["steps"] >= S),
               margin=st["margin"])
    return out


# -- the engine ---------------------------------------------------------------

def check_kernel_nodes(n: int, what: str) -> None:
    if n > KERNEL_MAX_NODES:
        raise NotImplementedError(
            f"{what} on the card holds one node per thread of a warp: "
            f"{n} nodes exceed {KERNEL_MAX_NODES} (ROADMAP item 11b); "
            f"device='cpu' runs the plain version")


def lane_keys(seeds, device) -> torch.Tensor:
    """64-bit mode PRNG keys [L, 2] of the seeds."""
    words = np.array([[(int(s) & (2**64 - 1)) >> 32, int(s) & 0xFFFFFFFF]
                      for s in seeds], dtype=np.uint32).reshape(-1, 2)
    return rnd.from_numpy_words(words, device)


def finish(out: dict) -> dict:
    """Derived keys (progress, on_chain) and numpy arrays."""
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


def refuse_device_metrics() -> None:
    if os.environ.get("CPR_DEVICE_METRICS") == "1":
        raise NotImplementedError(
            "CPR_DEVICE_METRICS=1: the netsim's device-metrics cells are "
            "not ported yet (ROADMAP item 14, K17)")


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
        if protocol != "nakamoto":
            raise NotImplementedError(
                f"the port's netsim runs nakamoto; the '{protocol}' event "
                f"branches are queued (ROADMAP item 11b)")
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
        self.B = block_cap or a + 2
        self.M = queue_cap or max(256, 16 * n)
        self.F = int(pend_cap)
        # reserved for item 11b: the bk/Ethereum branches' quorum window
        # and uncle capacity, sized as the JAX package sizes them; nothing
        # reads them until those branches are ported
        self.W = min(self.B, window or max(256, 32 * (self.k + n)))
        self.U = int(uncle_cap or 8)
        self.S = max_steps or a * (n + 4) + 4096
        self.x64 = True
        self.mode = "scan" if (mode == "auto" and scan_ok) or \
            mode == "scan" else "event"
        self.lookback = int(lookback)
        self.device = _device.resolve(device)
        if self.device.type == "cuda":
            check_kernel_nodes(n, "the netsim")
        self._seen = set()  # lane counts run

    def run(self, seeds, activation_delays) -> dict:
        """Execute len(seeds) lanes (paired with activation_delays);
        returns numpy arrays with lane axis 0."""
        seeds = list(seeds)
        delays = list(activation_delays)
        if len(seeds) != len(delays):
            raise ValueError("seeds and activation_delays must pair up")
        refuse_device_metrics()
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
        return out

    def lanes(self, keys, delays) -> dict:
        """The lanes' outputs as tensors on the keys' device: K12-scan or
        K12-event on CUDA, the plain versions on the CPU."""
        A = self.activations
        if keys.is_cuda:
            from cpr_tpu_torch import kernels
            if self.mode == "scan":
                return kernels.netsim_scan(self.net, A, self.lookback, keys,
                                           delays)
            return kernels.netsim_event(self.net, A, self.B, self.M, self.F,
                                        self.S, keys, delays)
        if self.mode == "scan":
            out = scan_plain(self.net, A, self.lookback, keys, delays)
        else:
            out = event_plain(self.net, A, self.B, self.M, self.F, self.S,
                              keys, delays)
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
