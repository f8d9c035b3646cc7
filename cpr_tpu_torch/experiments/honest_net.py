"""Honest-network sweep (port of cpr_tpu/experiments/honest_net.py, its
batch-engine half).

Reference counterpart: experiments/simulate/honest_net.ml:4-49: honest
cliques, protocols x activation delays, orphan-rate and efficiency rows
into TSV. `engine="jax"` (the JAX package's name for its batch engine,
kept so rows read the same) runs the port's netsim `Engine`: all
activation delays of a protocol as lanes of one call, on the card
(K12-scan for Nakamoto, K12-event-eth/-bk/-spar for the others) or, with
`device="cpu"`, through the plain versions. Protocols the netsim lacks
(Tailstorm) become error rows with `reason="unsupported-protocol"`, as
in the JAX package. `engine="oracle"` (the serial C++ oracle engine) is
not ported (ROADMAP item 9) and raises before any task runs.

Every row carries `machine_duration_s` (a lane's share of its batched
call) and the run manifest's engine, backend and git SHA.
"""

from __future__ import annotations

from cpr_tpu_torch import telemetry
from cpr_tpu_torch.experiments.sweep import run_task

DEFAULT_PROTOCOLS = (
    ("nakamoto", {}),
    ("ethereum-whitepaper", {}),
    ("ethereum-byzantium", {}),
    ("bk", dict(k=4, scheme="constant")),
    ("bk", dict(k=8, scheme="constant")),
    ("bk", dict(k=8, scheme="block")),
    # Tailstorm rows feed the reference report's second pivot; the netsim
    # has no Tailstorm, so they are error rows
    ("tailstorm", dict(k=8, scheme="constant")),
    ("tailstorm", dict(k=8, scheme="discount")),
)

DEFAULT_ACTIVATION_DELAYS = (30.0, 60.0, 120.0, 300.0, 600.0)


def _manifest_fields(tele, engine: str, config: dict) -> dict:
    """Emit a run manifest into the telemetry stream and return the
    compact per-row provenance columns derived from it."""
    man = tele.manifest(config=config)
    return {
        "engine": engine,
        "backend": man.get("backend", ""),
        "git_sha": man.get("git_sha", "") or "",
    }


def _row(*, n_nodes, proto, kw, ad, n_activations, sim_time,
         head_height, progress, n_blocks, on_chain, rewards,
         activations, duration_s, stamp):
    return {
        "network": f"honest_clique_{n_nodes}",
        "protocol": proto,
        "k": kw.get("k", 1),
        "incentive_scheme": kw.get("scheme", "constant"),
        "activation_delay": ad,
        "activations": n_activations,
        "sim_time": sim_time,
        "head_height": head_height,
        "head_progress": progress,
        "n_blocks": n_blocks,
        "on_chain": on_chain,
        # the reference battery's definition (cpr_protocols.ml:504-509):
        # PoW not reflected in head progress, over PoW spent
        "orphan_rate": max(0.0, 1.0 - progress / n_activations),
        "reward_total": sum(rewards),
        "reward_min": min(rewards),
        "reward_max": max(rewards),
        # per-node arrays, "|"-joined like the reference TSV
        # (csv_runner.ml:43-48,77-78); honest cliques weight compute
        # uniformly
        "compute": "|".join("1" for _ in range(n_nodes)),
        "node_activations": "|".join(str(a) for a in activations),
        "reward": "|".join(f"{r:.6g}" for r in rewards),
        "machine_duration_s": duration_s,
        **stamp,
    }


def _netsim_rows(protocols, activation_delays, *, n_nodes,
                 n_activations, propagation_delay, seed, tele, stamp,
                 device):
    """One netsim call per protocol config: each activation delay is a
    lane, so a column of the sweep grid is one batch."""
    from cpr_tpu_torch import netsim
    from cpr_tpu_torch.network import symmetric_clique

    delays = [float(a) for a in activation_delays]
    net = symmetric_clique(n_nodes, activation_delay=delays[0],
                           propagation_delay=propagation_delay)

    def batch(proto, kw):
        k = kw.get("k", 1)
        scheme = kw.get("scheme", "constant")
        if not netsim.supports(proto, k, scheme):
            err = ValueError(
                f"netsim supports protocols {netsim.SUPPORTED_PROTOCOLS}"
                f", not '{proto}' (k={k}, scheme='{scheme}')")
            err.reason = "unsupported-protocol"
            raise err
        eng = netsim.Engine(net, protocol=proto, k=k, scheme=scheme,
                            activations=n_activations, device=device)
        with tele.span("honest_net:netsim", lanes=len(delays),
                       activations=len(delays) * n_activations) as sp:
            out = eng.run([seed] * len(delays), delays)
        # a lane's share of the one batched call
        share = sp.dur_s / max(len(delays), 1)
        rows = []
        for i, ad in enumerate(delays):
            rewards = [float(r) for r in out["reward"][i]]
            activations = [int(a) for a in out["node_act"][i]]
            rows.append(_row(
                n_nodes=n_nodes, proto=proto, kw=kw, ad=ad,
                n_activations=n_activations,
                sim_time=float(out["sim_time"][i]),
                head_height=int(out["head_height"][i]),
                progress=float(out["progress"][i]),
                n_blocks=int(out["n_blocks"][i]),
                on_chain=float(out["on_chain"][i]),
                rewards=rewards, activations=activations,
                duration_s=share, stamp=stamp))
        return rows

    rows = []
    for proto, kw in protocols:
        rows.extend(run_task(
            lambda p=proto, k=kw: batch(p, k),
            {"network": f"honest_clique_{n_nodes}", "protocol": proto,
             "k": kw.get("k", 1),
             "incentive_scheme": kw.get("scheme", "constant"), **stamp}))
    return rows


def honest_net_rows(protocols=DEFAULT_PROTOCOLS,
                    activation_delays=DEFAULT_ACTIVATION_DELAYS,
                    *, n_nodes: int = 10, n_activations: int = 10_000,
                    propagation_delay: float = 1.0, seed: int = 0,
                    engine: str = "oracle", device=None):
    """One row per (protocol, activation_delay) honest clique run;
    `device` goes to the netsim `Engine` (None: the card)."""
    if engine not in ("oracle", "jax"):
        raise ValueError(f"engine must be 'oracle' or 'jax', not "
                         f"'{engine}'")
    if engine == "oracle":
        raise NotImplementedError(
            "honest_net_rows(engine='oracle'): the serial oracle engine is "
            "not ported yet (ROADMAP item 9); engine='jax' runs the batch "
            "netsim")
    tele = telemetry.current()
    stamp = _manifest_fields(tele, engine, dict(
        sweep="honest_net", engine=engine, n_nodes=n_nodes,
        n_activations=n_activations, seed=seed))
    with tele.span("honest_net:sweep", tasks=len(protocols)
                   * len(activation_delays)):
        return _netsim_rows(protocols, activation_delays, n_nodes=n_nodes,
                            n_activations=n_activations,
                            propagation_delay=propagation_delay, seed=seed,
                            tele=tele, stamp=stamp, device=device)
