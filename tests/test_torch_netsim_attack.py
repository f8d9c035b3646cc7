"""The port's attacker in the network (K13's plain version) against
`cpr_tpu.netsim.attack` on the CPU: every scripted policy on clique-4
and on `two_agents`, integers exact, times within TIME_RTOL; plus the
reference's own properties on the port alone: validation, invariants,
the sweep's row schema and cache, and the degenerate two-party anchor
held against the port's Nakamoto env at gamma = 0.

The reference is wrapped in the `jax_x64` stand-in of
test_torch_netsim.py (jax 0.9.0 has no jax.experimental.enable_x64).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cpr_tpu import netsim as jnetsim
from cpr_tpu import network as jnetwork
from cpr_tpu_torch import convert, netsim, network
from cpr_tpu_torch.netsim import attack as AT
from cpr_tpu_torch.netsim import engine as E
from test_torch_netsim import (TIME_RTOL, assert_parity,  # noqa: F401
                               jax_x64, one_torch_thread)

POLICIES = AT.SCRIPTED_POLICIES
ATTACK_INT_KEYS = ("head", "head_height", "n_blocks", "n_act", "node_act",
                   "reward", "reward_attacker", "reward_defender", "steps",
                   "drop_q", "drop_p", "drop_b", "win_miss", "exhausted")


def lane_grid(alphas, n_pol, reps, seed=7, delay=60.0):
    ss, dd, aa, pp = [], [], [], []
    for ai, a in enumerate(alphas):
        for pi in range(n_pol):
            for r in range(reps):
                ss.append(seed + 1000 * ai + 100 * pi + r)
                dd.append(delay)
                aa.append(float(a))
                pp.append(pi)
    return ss, dd, aa, pp


def port_attack(tcn, A, lanes, policies=POLICIES, **kw):
    """The port's plain run: (Engine.run-shaped outputs, margin)."""
    ss, dd, aa, pp = lanes
    eng = netsim.AttackEngine(tcn, activations=A, policies=policies,
                              device="cpu", **kw)
    out = AT.attack_plain(
        tcn, A, eng.B, eng.M, eng.F, eng.S, eng.WA, E.lane_keys(ss, "cpu"),
        torch.tensor(dd, dtype=torch.float64), torch.tensor(aa),
        eng._branches(), torch.tensor(pp, dtype=torch.int32),
        eng.strict_match)
    margin = float(out.pop("margin").min())
    return E.finish(out), margin


def assert_clean(out):
    for key in ("drop_q", "drop_p", "drop_b", "win_miss"):
        assert not np.any(out[key]), (key, out[key])
    assert not np.any(out["exhausted"]), out["steps"]


@pytest.mark.parametrize("topology", ["clique4", "two_agents"])
def test_attack_matches_reference(topology):
    if topology == "clique4":
        jnet = jnetwork.symmetric_clique(4, activation_delay=30.0,
                                         propagation_delay=10.0)
        A, delay = 300, 30.0
    else:
        jnet = jnetwork.two_agents(alpha=0.3, activation_delay=60.0)
        A, delay = 300, 60.0
    lanes = lane_grid((0.3, 0.45), len(POLICIES), 1, delay=delay)
    jcn = jnetsim.compile_network(jnet)
    ref = jnetsim.AttackEngine(jcn, activations=A, policies=POLICIES).run(
        *lanes)
    out, margin = port_attack(convert.compiled_net(jcn), A, lanes)
    print(f"attack {topology}: smallest decision margin {margin:.3e}")
    assert margin > TIME_RTOL * float(ref["sim_time"].max())
    assert_parity(out, ref, f"attack {topology}", ATTACK_INT_KEYS)
    assert_clean(out)
    # every policy acted: the withholding ones release and orphan blocks
    hh = out["head_height"].reshape(2, len(POLICIES))
    assert np.all(hh > 0)


def test_attack_walk_cap_misses_as_reference():
    # a common-ancestor walk capped at 2 steps: the deep forks of
    # withholding at alpha 0.45 miss, counted in win_miss, and the lane
    # goes on from where the pointers stopped, as in the reference
    jnet = jnetwork.symmetric_clique(4, activation_delay=30.0,
                                     propagation_delay=10.0)
    lanes = lane_grid((0.45,), 2, 2, delay=30.0)
    pols = ("eyal-sirer-2014", "sapirshtein-2016-sm1")
    jcn = jnetsim.compile_network(jnet)
    ref = jnetsim.AttackEngine(jcn, activations=200, policies=pols,
                               walk_cap=2).run(*lanes)
    assert np.all(ref["win_miss"] > 0)
    out, _ = port_attack(convert.compiled_net(jcn), 200, lanes, pols,
                         walk_cap=2)
    assert_parity(out, ref, "attack walk cap 2", ATTACK_INT_KEYS)


def test_attack_engine_validation():
    net = network.two_agents(alpha=0.3, activation_delay=60.0)
    with pytest.raises(ValueError, match="netsim attack supports"):
        netsim.AttackEngine(net, protocol="tailstorm", activations=100,
                            device="cpu")
    with pytest.raises(ValueError, match="unknown attack policies"):
        netsim.AttackEngine(net, activations=100,
                            policies=("honest", "nope"), device="cpu")
    eng = netsim.AttackEngine(net, activations=100, device="cpu")
    with pytest.raises(ValueError, match="alphas must lie"):
        eng.run([0], [60.0], [1.5], [0])
    with pytest.raises(ValueError, match="pair up"):
        eng.run([0, 1], [60.0], [0.3], [0])
    assert not netsim.attack_supports("spar", k=4)
    assert netsim.attack_supports("nakamoto")
    assert netsim.ATTACK_PROTOCOLS == jnetsim.ATTACK_PROTOCOLS
    assert netsim.DEFAULT_ATTACK_POLICIES == \
        jnetsim.DEFAULT_ATTACK_POLICIES
    with pytest.raises(NotImplementedError, match="item 13"):
        netsim.AttackEngine(net, activations=100, mesh=object(),
                            device="cpu")
    # a callable policy runs in the plain version; the card takes the
    # scripted ids only
    always_adopt = {"adopt": lambda obs: torch.zeros(obs.shape[0],
                                                     dtype=torch.int32)}
    eng = netsim.AttackEngine(net, activations=100, policies=("honest",),
                              extra_policies=always_adopt, device="cpu")
    assert eng.policy_names == ("honest", "adopt")
    out = eng.run([0, 1], [60.0, 60.0], [0.4, 0.4], [0, 1])
    assert out["reward_attacker"][1] == 0.0  # adopting never wins a block
    with pytest.raises(NotImplementedError, match="item 12"):
        eng.kernel_policy_ids(torch.tensor([0, 1], dtype=torch.int32))
    ids = netsim.AttackEngine(
        net, activations=10, policies=("sapirshtein-2016-sm1", "honest"),
        device="cpu").kernel_policy_ids(torch.tensor([1, 0, 5],
                                                     dtype=torch.int32))
    assert ids.tolist() == [0, 3, 0]


def test_attack_engine_invariants():
    """On a multi-node clique: overflow-free, rewards conserved (1 a
    block: attacker + defender revenue == head height), all activations
    accounted for."""
    net = network.symmetric_clique(4, activation_delay=30.0,
                                   propagation_delay=10.0)
    eng = netsim.AttackEngine(net, activations=400, topology="clique-4",
                              policies=("honest", "sapirshtein-2016-sm1"),
                              device="cpu")
    out = eng.run(*lane_grid((0.3,), 2, 2))
    assert_clean(out)
    assert np.all(out["node_act"].sum(axis=1) == 400)
    hh = np.asarray(out["head_height"], np.float64)
    total = (np.asarray(out["reward_attacker"], np.float64)
             + np.asarray(out["reward_defender"], np.float64))
    np.testing.assert_allclose(total, hh, atol=1e-4)
    np.testing.assert_allclose(out["reward"].sum(axis=1), hh, atol=1e-4)
    assert np.all(hh > 0)


def test_attack_engine_emits_spans_and_event():
    import io
    import json

    from cpr_tpu_torch import telemetry
    buf = io.StringIO()
    telemetry.configure(stream=buf)
    try:
        eng = netsim.AttackEngine(
            network.two_agents(alpha=0.3, activation_delay=60.0),
            activations=50, topology="two-agents", device="cpu")
        eng.run([0, 1], [60.0, 60.0], [0.3, 0.4], [0, 1])
        eng.run([0, 1], [60.0, 60.0], [0.3, 0.4], [0, 1])
    finally:
        telemetry.configure()
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    names = [e["name"] for e in events]
    assert names.count("attack:compile") == 1
    assert names.count("attack:run") == 2
    point = [e for e in events if e["name"] == "attack_sweep"][0]
    for field in ("protocol", "topology", "lanes", "policies", "drops",
                  "activations", "n_devices", "sweep_s", "lanes_per_sec"):
        assert field in point, field
    assert point["topology"] == "two-agents" and point["lanes"] == 2


def test_attack_sweep_rows_schema():
    """Supported protocols give withholding-schema rows; unsupported ones
    error rows with a machine-readable reason."""
    net = network.two_agents(alpha=0.3, activation_delay=60.0)
    rows = netsim.attack_sweep(
        [("two-agents", net)],
        protocols=(("nakamoto", {}), ("tailstorm", {"k": 8})),
        policies=("honest",), alphas=(0.3,), activation_delays=(60.0,),
        activations=200, reps=2, seed=3,
        engine_kwargs=dict(device="cpu"))
    good = [r for r in rows if "error" not in r]
    bad = [r for r in rows if "error" in r]
    assert len(good) == 1 and len(bad) == 1
    row = good[0]
    for key in ("protocol", "attack", "alpha", "gamma", "episode_len",
                "reps", "reward_attacker", "reward_defender",
                "relative_reward", "reward_per_progress",
                "machine_duration_s", "topology", "activation_delay",
                "n_nodes", "engine"):
        assert key in row, key
    assert row["attack"] == "nakamoto-honest"
    assert row["gamma"] == -1.0
    assert row["engine"] == "netsim-attack"
    assert 0.0 < row["relative_reward"] < 1.0
    assert bad[0]["reason"] == "unsupported-protocol"
    assert "netsim attack supports protocols" in bad[0]["error"]


def test_attack_sweep_cached(tmp_path, monkeypatch):
    monkeypatch.setenv("CPR_ATTACK_CACHE", str(tmp_path))
    net = network.two_agents(alpha=0.3, activation_delay=60.0)
    kw = dict(policies=("honest",), alphas=(0.3,),
              activation_delays=(60.0,), activations=150, reps=2, seed=3,
              device="cpu")
    first = netsim.attack_sweep_cached(net, "two-agents", **kw)
    assert first["cached"] is False and len(first["rows"]) == 1
    assert "error" not in first["rows"][0]
    second = netsim.attack_sweep_cached(net, "two-agents", **kw)
    assert second["cached"] is True
    assert second["rows"] == first["rows"]
    third = netsim.attack_sweep_cached(net, "two-agents",
                                       **{**kw, "seed": 4})
    assert third["cached"] is False
    # a damaged entry is quarantined and recomputed
    for entry in tmp_path.glob("*.json"):
        entry.write_bytes(b"torn")
    again = netsim.attack_sweep_cached(net, "two-agents", **kw)
    assert again["cached"] is False

    def results(rows):
        return [{k: v for k, v in r.items() if k != "machine_duration_s"}
                for r in rows]
    assert results(again["rows"]) == results(first["rows"])


def test_degenerate_two_party_equivalence():
    """On a zero-delay two-node network a Match never splits the single
    honest miner, so the attacker in the network plays the two-party
    Nakamoto env at gamma = 0: per (policy, alpha) mean relative revenue
    within 0.05 of the port's env (the reference's anchor and band: env
    512 steps x 64 reps, its keys; netsim 1500 activations). The netsim
    side runs 16 reps a cell where the reference runs 6: with jax 0.9.0's
    threefry stream both packages read a gap of 0.0507 at SM1, alpha 0.45
    from those 6 (the cell's standard error is ~0.02 there), and 0.016
    from 16."""
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import stack_params

    alphas = (0.2, 0.33, 0.45)
    pols = ("honest", "eyal-sirer-2014", "sapirshtein-2016-sm1")
    env = NakamotoSSZ()
    env_rel = {}
    # withholding_rows' keys and stream: split(fold_in(PRNGKey(7),
    # policy), (alphas, reps)), one lane a (alpha, rep) with its alpha,
    # episode_len + 8 steps a lane
    params = stack_params([dict(alpha=a, gamma=0.0, max_steps=512)
                           for a in alphas for _ in range(64)])
    for pi, p in enumerate(pols):
        keys = rnd.split(rnd.fold_in(rnd.PRNGKey(7, device="cpu"), pi),
                         len(alphas) * 64)
        st = env.make_episode_stats_fn(params, p, 512 + 8)(keys)
        atk = st["episode_reward_attacker"].view(len(alphas), 64).mean(1)
        dfn = st["episode_reward_defender"].view(len(alphas), 64).mean(1)
        for ai, a in enumerate(alphas):
            env_rel[(p, a)] = float(atk[ai]) / float(atk[ai] + dfn[ai])

    net = network.two_agents(alpha=0.33, activation_delay=60.0)
    eng = netsim.AttackEngine(net, activations=1500, topology="two-agents",
                              policies=pols, device="cpu")
    reps = 16
    out = eng.run(*lane_grid(alphas, len(pols), reps))
    assert_clean(out)
    ra = out["reward_attacker"].reshape(len(alphas), len(pols), reps)
    rd = out["reward_defender"].reshape(len(alphas), len(pols), reps)
    rel = (ra / (ra + rd)).mean(-1)
    for ai, a in enumerate(alphas):
        for pi, p in enumerate(pols):
            gap = abs(float(rel[ai, pi]) - env_rel[(p, a)])
            assert gap < 0.05, (p, a, float(rel[ai, pi]), env_rel[(p, a)])
    # the physics: honest tracks alpha, selfish mining at gamma 0 loses at
    # alpha 1/3 and wins big at 0.45
    assert abs(float(rel[0, 0]) - 0.2) < 0.03
    assert float(rel[1, 1]) < 0.34
    assert float(rel[2, 2]) > 0.55
