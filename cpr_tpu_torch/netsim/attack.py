"""Adversary in the network: withholding attacks inside the netsim (port
of cpr_tpu/netsim/attack.py).

Node 0 of a topology runs a withholding policy over the SSZ observation
while the other nodes mine and flood honestly through the event engine's
queue, pending buffers and flooding (`netsim/engine.py`). Semantics as
in the JAX package (nakamoto):

* node 0 mines on its private tip and never announces at mint;
* it keeps a public view `pub` (the highest block delivered to it) and a
  private tip `priv`; after an own mint (event PoW) or a public-view
  advance (event Network) it finds the common ancestor by a bounded
  two-pointer height walk (cap `walk_cap`, overflow counted in
  `win_miss`), encodes `(h, a, a - h, event)` as the unit observation and
  applies the lane's policy: Adopt | Override | Match | Wait;
* a release sends the withheld blocks lowest id first, one per engine
  step at the decision time, ahead of any activation or delivery.

Per-lane alpha enters as node 0's compute share, the honest nodes
sharing the rest in their declared proportions; alpha and the policy id
are lane inputs. The kernel is K13 (`csrc/netsim_attack.cu` over
`csrc/netsim_event.cuh`), its plain version `attack_plain`. The scripted
policies are the port's Nakamoto ones (`envs/nakamoto.py`, K2's device
functions in the kernel), computed from the integer fork lengths; they
equal the decoded unit observation's while both lengths stay below 1696
(ROADMAP §3, "Unit observations"), which an attack lane of fewer
activations always does.

On the card a lane's policy is one of the four scripted ones; a callable
in `extra_policies` (obs [lanes, 4] -> actions [lanes]) runs in the plain
version on the CPU and raises on the card (ROADMAP item 12).
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from cpr_tpu_torch import _device, telemetry
from cpr_tpu_torch import obs as obslib
from cpr_tpu_torch.envs.nakamoto import (ADOPT, EV_NETWORK, EV_POW, MATCH,
                                         OBS_FIELDS, OVERRIDE, POLICY_NAMES,
                                         NakamotoSSZ)
from cpr_tpu_torch.netsim.compile import CompiledNet, compile_network
from cpr_tpu_torch.netsim.engine import (F32, F64, I32, EventLedger,
                                         check_kernel_nodes, finish,
                                         lane_keys, load_kernels,
                                         refuse_device_metrics)

ATTACK_PROTOCOLS = ("nakamoto",)
SCRIPTED_POLICIES = POLICY_NAMES
DEFAULT_ATTACK_POLICIES = ("honest", "eyal-sirer-2014",
                           "sapirshtein-2016-sm1")
DEFAULT_ALPHAS = (0.15, 0.25, 0.33, 0.4, 0.45)


def attack_supports(protocol: str, k: int = 1,
                    scheme: str = "constant") -> bool:
    """True when the attack lane implements this protocol config (only
    nakamoto, as in the JAX package)."""
    return protocol in ATTACK_PROTOCOLS


def attack_logits(cn: CompiledNet, alphas) -> torch.Tensor:
    """Per-lane float32 miner logits [L, N]: log of node 0's alpha and of
    the honest nodes' declared shares renormalized to 1 - alpha."""
    wh = np.asarray(cn.compute[1:], np.float64)
    whon = torch.as_tensor(wh / wh.sum(), dtype=F32, device=alphas.device)
    a = alphas.to(F32)[:, None]
    return torch.log(torch.cat([a, (1.0 - a) * whon], 1))


class AncestorLift:
    """The plain version's common-ancestor walk (attack.py:264-281): two
    pointers step to their parents, the higher one (both at equal
    heights), until they meet or WA steps are taken. Binary lifting gives
    the same end points in O(log B) gathers a lane instead of one step a
    fork block: the table `up` [Ln, log, B] (a state field) holds at
    `up[:, k, b]` b's 2**k-th ancestor (genesis its own), filled at
    append."""

    def __init__(self, Ln, B, WA, dev):
        self.log = max(1, (B - 1).bit_length())
        self.B, self.dev = B, dev
        self.lanes = torch.arange(Ln, device=dev)
        self.WA = WA

    def empty(self):
        return torch.zeros((len(self.lanes), self.log, self.B),
                           dtype=torch.long, device=self.dev)

    def append(self, up, ok, ids, parent):
        """`up` with block ids[l] (child of parent[l]) entered where ok."""
        lanes, up = self.lanes, up.clone()
        b = torch.clamp(ids, max=self.B - 1).long()
        anc = torch.clamp(parent, min=0).long()
        for k in range(self.log):
            up[lanes, k, b] = torch.where(ok, anc, up[lanes, k, b])
            anc = up[lanes, k, anc]
        return up

    def ancestor(self, up, v, d):
        for k in range(self.log):
            v = torch.where((d >> k) & 1 == 1, up[self.lanes, k, v], v)
        return v

    def walk(self, up, x, y, height):
        """Where the two pointers from x and y stop: both at their common
        ancestor if it is at most WA steps away, else where WA steps
        left them."""
        lanes = self.lanes
        hx, hy = height[lanes, x].long(), height[lanes, y].long()
        d = (hx - hy).abs()
        xs = self.ancestor(up, torch.where(hx >= hy, x, y), d)  # the higher
        ys = torch.where(hx >= hy, y, x)
        for k in range(self.log - 1, -1, -1):
            ux, uy = up[lanes, k, xs], up[lanes, k, ys]
            move = ux != uy
            xs, ys = torch.where(move, ux, xs), torch.where(move, uy, ys)
        ca = torch.where(xs == ys, xs, up[lanes, 0, xs])
        met = torch.maximum(hx, hy) - height[lanes, ca].long() <= self.WA
        # not met: the higher pointer took WA steps, the other the steps
        # left after the heights equalized
        rest = torch.clamp(self.WA - d, min=0)
        xf = self.ancestor(up, x, torch.where(hx >= hy, self.WA, rest))
        yf = self.ancestor(up, y, torch.where(hy >= hx, self.WA, rest))
        return torch.where(met, ca, xf), torch.where(met, ca, yf)


def attack_plain(cn: CompiledNet, A: int, B: int, M: int, F: int, S: int,
                 WA: int, keys, delays, alphas, policies, pids,
                 strict_match: bool = True) -> dict:
    """Plain version of K13: the JAX package's `_attack_lane_fn`
    (attack.py:81-408) over lanes. `policies` are obs -> action callables
    (unit observations [L, 4]), `pids` [L] each lane's index into them.
    Also returns `margin` [L] (`EventLedger.timing`)."""
    N = cn.n
    led = EventLedger(cn, A, B, M, F, keys, delays)
    dev, lanes = led.dev, led.lanes
    logw = attack_logits(cn, alphas)
    ids = torch.arange(B, device=dev)
    lift = AncestorLift(led.Ln, B, WA, dev)
    st = led.st
    st.update(up=lift.empty(),
              priv=torch.zeros(led.Ln, dtype=I32, device=dev),
              pub=torch.zeros(led.Ln, dtype=I32, device=dev),
              withheld=torch.zeros((led.Ln, B), dtype=torch.bool,
                                   device=dev),
              rel_h=torch.full((led.Ln,), -1, dtype=I32, device=dev),
              win_miss=torch.zeros(led.Ln, dtype=I32, device=dev))

    def h_of(height, x):
        return height[lanes, x.long()]

    def body(st, m, e_next, delay):
        height = st["height"]
        new = dict(st)
        tmin, act_now, recv_ok = led.timing(st, new)
        wh_ok = st["withheld"] & (height <= st["rel_h"][:, None])
        is_rel = wh_ok.any(1)
        is_act = ~is_rel & act_now
        is_recv = ~is_rel & ~act_now & recv_ok
        now2 = torch.where(is_act, st["next_act"],
                           torch.where(is_recv, tmin, st["now"]))
        b, deliver, pend2, unl = led.deliver_wave(st, new, is_recv, tmin)
        pub_gain = is_recv & deliver[:, 0] & (height[lanes, b]
                                              > h_of(height, st["pub"]))
        pub2 = torch.where(pub_gain, b.to(I32), st["pub"])

        # release: the lowest-id withheld block at height <= rel_h
        rb = torch.clamp(torch.where(wh_ok, ids, B).min(1).values, 0, B - 1)
        withheld = st["withheld"].clone()
        withheld[lanes, rb] &= ~is_rel
        rel_done = is_rel & (wh_ok.sum(1) <= 1)
        rel_h = torch.where(rel_done, -1, st["rel_h"])
        pub3 = torch.where(is_rel & (height[lanes, rb] > h_of(height, pub2)),
                           rb.to(I32), pub2)

        # activation: node 0 mines privately, honest nodes on pref
        new["next_act"] = torch.where(
            is_act, st["next_act"] + e_next * led.delays, st["next_act"])
        atk_mine = m == 0
        parent_act = torch.where(atk_mine, st["priv"],
                                 st["pref"][lanes, m]).long()
        new["n_act"] = st["n_act"] + is_act.to(I32)
        new["node_act"] = st["node_act"].clone()
        new["node_act"][lanes, m] += is_act.to(I32)
        ok_act = is_act & (st["nb"] < B)
        new["drop_b"] = st["drop_b"] + (is_act & (st["nb"] >= B)).to(I32)
        led.append(st, new, ok_act, parent_act, m)
        hon_mint = (led.arangeN == m[:, None]) & (ok_act & ~atk_mine)[:, None]
        new["pref"] = torch.where(hon_mint, st["nb"][:, None], new["pref"])
        atk_new = ok_act & atk_mine
        priv2 = torch.where(atk_new, st["nb"], st["priv"])
        withheld[lanes, torch.clamp(st["nb"], max=B - 1).long()] |= atk_new

        # SSZ handle on an own PoW or a public-view advance
        height3, parent3 = new["height"], new["parent0"]
        ev = torch.where(atk_new, EV_POW, EV_NETWORK).to(I32)
        do_handle = atk_new | pub_gain
        new["up"] = lift.append(st["up"], ok_act, st["nb"], parent_act)
        x, y = lift.walk(new["up"], torch.where(do_handle, priv2, 0).long(),
                         torch.where(do_handle, pub3, 0).long(), height3)
        new["win_miss"] = st["win_miss"] + (do_handle & (x != y)).to(I32)
        h_ca = height3[lanes, x]
        a_rel = h_of(height3, priv2) - h_ca
        h_rel = h_of(height3, pub3) - h_ca
        obs = obslib.encode(OBS_FIELDS, (h_rel, a_rel, a_rel - h_rel, ev),
                            True)
        action = torch.zeros(led.Ln, dtype=I32, device=dev)
        for i, fn in enumerate(policies):
            action = torch.where(pids == i, torch.as_tensor(
                fn(obs)).to(dev, I32), action)
        adopt = do_handle & (action == ADOPT)
        override_eff = do_handle & (action == OVERRIDE) & (a_rel > h_rel)
        match_eff = (do_handle & (action == MATCH) & (a_rel >= h_rel)
                     & (h_rel > 0))
        if strict_match:
            match_eff = match_eff & (ev == EV_NETWORK)
        new["priv"] = torch.where(adopt, pub3, priv2)
        new["withheld"] = withheld & ~adopt[:, None]
        h_pub = h_of(height3, pub3)
        new["rel_h"] = torch.where(override_eff, h_pub + 1,
                                   torch.where(match_eff, h_pub, rel_h))
        new["pub"] = pub3

        send = torch.where(is_recv[:, None], led.flood_src(st, b, deliver),
                           torch.where(is_rel[:, None], led.arangeN == 0,
                                       hon_mint))
        s_blk = torch.where(is_recv, b,
                            torch.where(is_rel, rb, st["nb"].long()))
        led.push(st, new, delay, now2, send, s_blk, pend2, unl)
        new.update(now=now2, steps=st["steps"] + 1)
        tmin2 = new["q_time"].amin(1)
        rel_pending = (new["withheld"]
                       & (height3 <= new["rel_h"][:, None])).any(1)
        new["live"] = (rel_pending | (new["n_act"] < A)
                       | ((tmin2 < new["next_act"]) & torch.isfinite(tmin2)))
        return new

    # a step splits 4 ways: carry, miner, next activation, delays
    st = led.run(body, S, 4, (1, 2, 3), logw)
    height = st["height"]
    hp = height.gather(1, st["pref"].long())
    h_hon = torch.where(led.arangeN >= 1, hp, -1)
    jb = torch.argmax(h_hon, 1)
    best_h = h_hon.max(1).values
    h_priv = h_of(height, st["priv"])
    # the withheld suffix competes at the end; ties go to the attacker
    head = torch.where(h_priv >= best_h, st["priv"], st["pref"][lanes, jb])
    reward = led.reward_walk(head, A + 2)[0]
    return dict(head=head, head_height=h_of(height, head),
                reward=reward, reward_attacker=reward[:, 0],
                reward_defender=reward[:, 1:].sum(1),
                sim_time=st["now"], n_blocks=st["nb"] - 1,
                n_act=st["n_act"], node_act=st["node_act"],
                steps=st["steps"], drop_q=st["drop_q"], drop_p=st["drop_p"],
                drop_b=st["drop_b"], win_miss=st["win_miss"],
                exhausted=st["live"] & (st["steps"] >= S),
                margin=st["margin"])


class AttackEngine:
    """One attacker-in-the-network configuration: fixed topology and
    activation target; `run()` executes a batch of lanes, each an
    independent (seed, activation_delay, alpha, policy_id), on the card
    (K13), or with `device="cpu"` through the plain version.

        eng = AttackEngine(net, activations=2000,
                           policies=("honest", "sapirshtein-2016-sm1"))
        out = eng.run(seeds=[0, 1], activation_delays=[60.0, 60.0],
                      alphas=[0.33, 0.33], policy_ids=[0, 1])
    """

    def __init__(self, net, *, protocol: str = "nakamoto", k: int = 1,
                 scheme: str = "constant", activations: int,
                 policies=DEFAULT_ATTACK_POLICIES, extra_policies=None,
                 strict_match: bool = True, topology: str = "custom",
                 block_cap: int | None = None,
                 queue_cap: int | None = None, pend_cap: int = 8,
                 walk_cap: int | None = None,
                 max_steps: int | None = None,
                 x64: bool = True, mesh=None, mesh_axis: str = "d",
                 device=None):
        if not attack_supports(protocol, k, scheme):
            raise ValueError(
                f"netsim attack supports protocols {ATTACK_PROTOCOLS}, "
                f"not '{protocol}'")
        extra_policies = dict(extra_policies or {})
        bad = [p for p in policies
               if p not in SCRIPTED_POLICIES and p not in extra_policies]
        if bad:
            raise ValueError(
                f"unknown attack policies {bad}; scripted: "
                f"{SCRIPTED_POLICIES}, extra: "
                f"{sorted(extra_policies)}")
        if not x64:
            raise NotImplementedError(
                "the port's netsim keeps float64 clocks; x64=False is "
                "queued (ROADMAP item 11b)")
        if mesh is not None:
            raise NotImplementedError(
                "attack lanes sharded over devices (mesh=) are not ported "
                "yet (ROADMAP item 13)")
        del mesh_axis
        self.net = (net if isinstance(net, CompiledNet)
                    else compile_network(net))
        self.protocol = protocol
        self.topology = str(topology)
        self.activations = int(activations)
        self.policies = tuple(policies)
        self.extra_policies = extra_policies
        # extras not named in `policies` ride along after them
        self.policy_names = self.policies + tuple(
            nm for nm in extra_policies if nm not in self.policies)
        self.strict_match = bool(strict_match)
        n, a = self.net.n, self.activations
        self.B = block_cap or a + 2
        # releases re-send the withheld chain: up to 2x the mint sends
        self.M = queue_cap or max(256, 32 * n)
        self.F = int(pend_cap)
        # the common-ancestor walk's cap: no chain outgrows the ledger
        self.WA = int(walk_cap or a + 2)
        self.S = max_steps or a * (n + 5) + 4096
        self.x64 = True
        self.n_devices = 1
        self.device = _device.resolve(device)
        if self.device.type == "cuda":
            check_kernel_nodes(n, "the attack netsim")
        self._seen = set()  # lane counts run

    def _branches(self):
        env = NakamotoSSZ(unit_observation=True,
                          strict_match=self.strict_match)
        return [self.extra_policies.get(nm) or env.policies[nm]
                for nm in self.policy_names]

    def kernel_policy_ids(self, pids: torch.Tensor) -> torch.Tensor:
        """Each lane's scripted policy as K2's device-function id
        (`POLICY_NAMES` order); raises for a callable (ROADMAP item 12)."""
        table = []
        for nm in self.policy_names:
            if nm in self.extra_policies:
                raise NotImplementedError(
                    f"attack policy '{nm}' is a callable: on the card a "
                    f"lane runs one of the scripted policies "
                    f"{SCRIPTED_POLICIES}; policy nets in attack sweeps "
                    f"come with serve/learn (ROADMAP item 12)")
            table.append(POLICY_NAMES.index(nm))
        t = torch.tensor(table, dtype=I32, device=pids.device)
        return t[torch.clamp(pids, 0, len(table) - 1).long()]

    def run(self, seeds, activation_delays, alphas, policy_ids) -> dict:
        """Execute len(seeds) attack lanes; returns numpy arrays with lane
        axis 0 and emits the `attack_sweep` telemetry event."""
        seeds = list(seeds)
        delays = list(activation_delays)
        alphas = [float(a) for a in alphas]
        pids = [int(p) for p in policy_ids]
        L = len(seeds)
        if not (len(delays) == len(alphas) == len(pids) == L):
            raise ValueError(
                "seeds, activation_delays, alphas, policy_ids must "
                "pair up")
        bad_a = [a for a in alphas if not 0.0 < a < 1.0]
        if bad_a:
            raise ValueError(f"alphas must lie in (0, 1), got {bad_a}")
        refuse_device_metrics()
        tele = telemetry.current()
        dev = self.device
        keys = lane_keys(seeds, dev)
        dl = torch.tensor(delays, dtype=F64, device=dev)
        al = torch.tensor(alphas, dtype=F32, device=dev)
        pi = torch.tensor(pids, dtype=I32, device=dev)
        load_kernels(tele, "attack", self._seen, L, dev)
        with tele.span("attack:run", lanes=L,
                       activations=L * self.activations) as sp:
            out = sp.fence(self.lanes(keys, dl, al, pi))
        out = finish(out)
        drops = int(out["drop_q"].sum() + out["drop_p"].sum()
                    + out["drop_b"].sum() + out["win_miss"].sum())
        tele.event("attack_sweep", protocol=self.protocol,
                   topology=self.topology, lanes=L,
                   policies=len(self.policy_names), drops=drops,
                   activations=int(np.sum(out["n_act"])),
                   n_devices=self.n_devices,
                   sweep_s=round(sp.dur_s, 6),
                   lanes_per_sec=round(L / max(sp.dur_s, 1e-9), 3))
        return out

    def lanes(self, keys, delays, alphas, pids) -> dict:
        """The lanes' outputs as tensors on the keys' device: K13 on
        CUDA, the plain version on the CPU."""
        args = (self.net, self.activations, self.B, self.M, self.F, self.S,
                self.WA, keys, delays, alphas)
        if keys.is_cuda:
            from cpr_tpu_torch import kernels
            return kernels.netsim_attack(*args, self.kernel_policy_ids(pids),
                                         self.strict_match)
        pids = torch.clamp(pids, 0, len(self.policy_names) - 1)
        out = attack_plain(*args, self._branches(), pids, self.strict_match)
        out.pop("margin")
        return out


def attack_sweep(topologies, *, protocols=(("nakamoto", {}),),
                 policies=DEFAULT_ATTACK_POLICIES, extra_policies=None,
                 alphas=DEFAULT_ALPHAS, activation_delays=(60.0,),
                 activations: int = 2000, reps: int = 4, seed: int = 0,
                 strict_match: bool = True, mesh=None,
                 engine_kwargs=None) -> list[dict]:
    """The attack grid: protocols x topologies x delays x alphas x
    policies, one engine per (protocol, topology), every other axis a
    lane input. Rows use the withholding schema (protocol, attack, alpha,
    gamma, reward_attacker, reward_defender, relative_reward, ...) plus
    topology/activation_delay/n_nodes; gamma reports -1.0 because the
    communication advantage emerges from message racing. Unsupported
    protocols and failed runs become error rows with a `reason`."""
    items = (list(topologies.items()) if isinstance(topologies, dict)
             else list(topologies))
    pols = list(policies) + [nm for nm in (extra_policies or {})
                             if nm not in policies]
    grid_pts = [(d, a, pi) for d in activation_delays for a in alphas
                for pi in range(len(pols))]
    rows: list[dict] = []
    for proto, kw in protocols:
        kk = int(kw.get("k", 1))
        scheme = kw.get("scheme", "constant")
        for tname, net in items:
            ident = {"protocol": proto, "topology": str(tname),
                     "engine": "netsim-attack"}
            t0 = telemetry.now()
            if not attack_supports(proto, kk, scheme):
                rows.append({
                    **ident,
                    "error": (f"netsim attack supports protocols "
                              f"{ATTACK_PROTOCOLS}, not '{proto}'"),
                    "reason": "unsupported-protocol",
                    "machine_duration_s": telemetry.now() - t0,
                })
                continue
            try:
                eng = AttackEngine(
                    net, protocol=proto, k=kk, scheme=scheme,
                    activations=activations, policies=policies,
                    extra_policies=extra_policies,
                    strict_match=strict_match, topology=str(tname),
                    mesh=mesh, **(engine_kwargs or {}))
                ss, dd, aa, pp = [], [], [], []
                for gi, (d, a, pi) in enumerate(grid_pts):
                    for r in range(reps):
                        ss.append(seed + gi * reps + r)
                        dd.append(float(d))
                        aa.append(float(a))
                        pp.append(pi)
                out = eng.run(ss, dd, aa, pp)
            except Exception as e:  # one row per failed configuration
                rows.append({
                    **ident,
                    "error": f"{type(e).__name__}: {e}",
                    "reason": "runtime-error",
                    "machine_duration_s": telemetry.now() - t0,
                })
                continue
            dt = telemetry.now() - t0
            atk = out["reward_attacker"].reshape(len(grid_pts), reps)
            dfn = out["reward_defender"].reshape(len(grid_pts), reps)
            prg = np.asarray(out["progress"]).reshape(len(grid_pts), reps)
            for gi, (d, a, pi) in enumerate(grid_pts):
                ra = float(atk[gi].mean())
                rd = float(dfn[gi].mean())
                pg = float(prg[gi].mean())
                total = ra + rd
                rows.append({
                    **ident,
                    "attack": f"{proto}-{pols[pi]}",
                    "alpha": float(a),
                    "gamma": -1.0,
                    "episode_len": int(activations),
                    "reps": int(reps),
                    "reward_attacker": ra,
                    "reward_defender": rd,
                    "relative_reward": ra / total if total else 0.0,
                    "reward_per_progress": ra / pg if pg else 0.0,
                    "machine_duration_s": dt / len(grid_pts),
                    "activation_delay": float(d),
                    "n_nodes": int(eng.net.n),
                })
    return rows


def _cache_dir() -> str:
    """Sweep-cache directory: CPR_ATTACK_CACHE >
    <CPR_TPU_CACHE>/attack_sweep > ~/.cache/cpr_tpu/attack_sweep (delete
    it to empty the cache)."""
    d = os.environ.get("CPR_ATTACK_CACHE")
    if d:
        return d
    base = os.environ.get("CPR_TPU_CACHE")
    if base:
        return os.path.join(base, "attack_sweep")
    return os.path.join(os.path.expanduser("~"), ".cache", "cpr_tpu",
                        "attack_sweep")


def attack_sweep_cached(net, topology: str, *,
                        protocol: str = "nakamoto", k: int = 1,
                        scheme: str = "constant",
                        policies=DEFAULT_ATTACK_POLICIES,
                        alphas=DEFAULT_ALPHAS,
                        activation_delays=(60.0,),
                        activations: int = 2000, reps: int = 4,
                        seed: int = 0, strict_match: bool = True,
                        cache: bool = True, mesh=None,
                        extra_policies=None,
                        extra_fingerprint: str = "", device=None) -> dict:
    """`attack_sweep` for one (protocol, topology), the result cached on
    disk under the topology's GraphML fingerprint and every sweep knob;
    a damaged entry is quarantined and recomputed. `extra_fingerprint`
    must name any extra policy's content (callables cannot be hashed).
    `device` is the engines' (the card unless "cpu"); it is not part of
    the key, the two give the same rows."""
    import cpr_tpu_torch
    from cpr_tpu_torch import integrity, resilience
    from cpr_tpu_torch.network import to_graphml

    topo_fp = hashlib.sha256(to_graphml(net).encode()).hexdigest()[:16]
    pols = list(policies) + [nm for nm in (extra_policies or {})
                             if nm not in policies]
    key = dict(kind="attack_sweep", protocol=protocol, k=int(k),
               scheme=scheme, topology=str(topology), topo_fp=topo_fp,
               policies=pols, alphas=[float(a) for a in alphas],
               activation_delays=[float(d) for d in activation_delays],
               activations=int(activations), reps=int(reps),
               seed=int(seed), strict_match=bool(strict_match),
               extra_fingerprint=str(extra_fingerprint),
               _version=cpr_tpu_torch.__version__)
    h = hashlib.sha256(
        json.dumps(key, sort_keys=True).encode()).hexdigest()[:24]
    path = os.path.join(_cache_dir(), h + ".json")
    if cache and os.path.exists(path):
        try:
            data, tag = resilience.sealed_read_json(
                path, kind="attack_cache", action="regenerated")
            return dict(data["value"], cached=True, integrity=tag)
        except resilience.IntegrityError:
            pass
        except (OSError, KeyError, TypeError):
            integrity.quarantine(path, kind="attack_cache",
                                 reason="truncated", action="regenerated")
    t0 = telemetry.now()
    rows = attack_sweep(
        [(topology, net)], protocols=((protocol, dict(k=k,
                                                      scheme=scheme)),),
        policies=policies, extra_policies=extra_policies,
        alphas=alphas, activation_delays=activation_delays,
        activations=activations, reps=reps, seed=seed,
        strict_match=strict_match, mesh=mesh,
        engine_kwargs=dict(device=device))
    value = dict(
        protocol=protocol, topology=str(topology),
        topo_fingerprint=topo_fp, policies=pols,
        alphas=[float(a) for a in alphas],
        activation_delays=[float(d) for d in activation_delays],
        activations=int(activations), reps=int(reps), seed=int(seed),
        rows=rows, sweep_s=round(telemetry.now() - t0, 6),
        cached=False)
    if cache:
        resilience.sealed_write_json(path, {"key": key, "value": value},
                                     site="cache")
    return value
