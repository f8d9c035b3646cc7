"""The port's netsim past 32 nodes (the widened K12-scan, K12-event and
its Bk, Ethereum and Spar branches, K13) against `cpr_tpu.netsim` on the
CPU, and the committed JAX fixture the kernels are held to on the card.

The kernels hold node n on thread n % 32 in slot n / 32 of a lane's warp
(`netsim.engine.node_slots`: 2, 4 or 8 slots past 32 nodes); the plain
versions, which these tests run (`device="cpu"`), take any N. Each case
runs the JAX package and the port's plain version on the same
numpy-built topology, seeds and activation delays:

  scan_clique40     K12-scan's path on a 40-node clique, 3 lanes x 300;
  event_clique40    the Nakamoto event engine there, 3 x 120;
  bk4_clique40      Bk k=4 (constant), 3 x 80;
  ethbyz_clique64   Ethereum Byzantium on a 64-node clique at activation
                    delay 30 (the honest-net sweep's smallest), 3 x 150:
                    cpr_tpu's witness that there every orphan but the
                    newest becomes an uncle (an orphan rate of 0 or 1/A);
  spar4_clique40    Spar k=4 (constant), 3 x 200;
  flood_pa40        flooding on preferential_attachment(40, 2,
                    distribution="uniform"), 2 x 6 (about 155 delivery
                    steps an activation over its 154 directed links);
  attack_sm35       the attacker on selfish_mining(gamma=0.97,
                    defenders=34), 35 nodes, honest and SM1 at alpha 0.25
                    and 0.4, 4 x 40;
  attack_sm35_q64   the same at queue 64, honest and SM1 at alpha 0.25,
                    2 x 40: both lanes overflow the queue and the pending
                    buffers (the drop counters, the full queue's ranking);
  scan_clique130    K12-scan's widest bucket (8 slots), 3 x 300;
  event_clique100   the event engine at 4 slots, 2 x 40.

Tolerances (test_torch_netsim.py): integer outputs exact, float64 times
within TIME_RTOL relative; each case prints the plain run's smallest
decision margin. `tests/fixtures/torch_port_netsim_wide_golden.npz`
holds cpr_tpu's outputs of every case with its topology planes and lane
inputs, so a machine without jax replays it (`chip_smoke.py` through the
kernels); each test also holds the fixture to the live run. `python
tests/test_torch_netsim_wide.py` rewrites it (~40 s).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

if __name__ == "__main__":  # the XLA flags tests/conftest.py sets
    os.environ.setdefault("XLA_FLAGS", "--xla_backend_optimization_level=0")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_netsim import (INT_KEYS, TIME_KEYS,  # noqa: E402,F401
                               TIME_RTOL, enter_x64_standin, jax_x64,
                               one_torch_thread)

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_netsim_wide_golden.npz")
ATTACK_POLICIES = ("honest", "sapirshtein-2016-sm1")
CASES = {
    "scan_clique40": dict(net="clique40", mode="scan", lanes=3, A=300),
    "event_clique40": dict(net="clique40", mode="event", lanes=3, A=120),
    "bk4_clique40": dict(net="clique40", mode="event", lanes=3, A=80,
                         protocol="bk", k=4),
    "ethbyz_clique64": dict(net="clique64", mode="event", lanes=3, A=150,
                            protocol="ethereum-byzantium", delay=30.0),
    "spar4_clique40": dict(net="clique40", mode="event", lanes=3, A=200,
                           protocol="spar", k=4),
    "flood_pa40": dict(net="pa40", mode="event", lanes=2, A=6),
    "attack_sm35": dict(net="sm35", mode="attack", lanes=4, A=40),
    "attack_sm35_q64": dict(net="sm35", mode="attack", lanes=2, A=40,
                            queue=64),
    "scan_clique130": dict(net="clique130", mode="scan", lanes=3, A=300),
    "event_clique100": dict(net="clique100", mode="event", lanes=2, A=40),
}
ENGINE_KW = ("protocol", "k")
OUT_KEYS = INT_KEYS + TIME_KEYS
ATTACK_KEYS = OUT_KEYS + ("reward_attacker", "reward_defender")


def jax_network(name, delay=25.0):
    from cpr_tpu import network as jnetwork
    if name.startswith("clique"):
        return jnetwork.symmetric_clique(int(name[len("clique"):]),
                                         activation_delay=delay,
                                         propagation_delay=1.0)
    if name == "pa40":
        return jnetwork.preferential_attachment(40, 2,
                                                distribution="uniform",
                                                seed=1)
    return jnetwork.selfish_mining(alpha=0.25, gamma=0.97, defenders=34,
                                   activation_delay=60.0,
                                   propagation_delay=1.0)


def lane_inputs(name, activation_delay):
    n = CASES[name]["lanes"]
    seeds = np.arange(n, dtype=np.int64) * 17 + 3
    delays = activation_delay * np.where(np.arange(n) % 2, 2.0, 1.0)
    alphas = np.where(np.arange(n) // 2 % 2, 0.4, 0.25).astype(np.float32)
    pids = (np.arange(n) % len(ATTACK_POLICIES)).astype(np.int32)
    return seeds, delays, alphas, pids


def engine_kw(name):
    return {k: CASES[name][k] for k in ENGINE_KW if k in CASES[name]}


def jax_case(name) -> dict:
    """cpr_tpu's run of one case: its inputs and outputs, prefixed."""
    from cpr_tpu import netsim as jnetsim
    c = CASES[name]
    cn = jnetsim.compile_network(jax_network(c["net"],
                                             c.get("delay", 25.0)))
    seeds, delays, alphas, pids = lane_inputs(name, cn.activation_delay)
    if c["mode"] == "attack":
        out = jnetsim.AttackEngine(
            cn, activations=c["A"], policies=ATTACK_POLICIES,
            queue_cap=c.get("queue")).run(
            seeds.tolist(), delays.tolist(), alphas.tolist(), pids.tolist())
    else:
        out = jnetsim.Engine(cn, activations=c["A"], mode=c["mode"],
                             **engine_kw(name)).run(seeds.tolist(),
                                                    delays.tolist())
    d = {f"{name}_{k}": np.asarray(v) for k, v in out.items()}
    d.update({f"{name}_net_{f}": np.asarray(getattr(cn, f)) for f in (
        "n", "compute", "kind", "p0", "p1", "activation_delay",
        "flooding")})
    d.update({f"{name}_seeds": seeds, f"{name}_delays": delays,
              f"{name}_alphas": alphas, f"{name}_pids": pids,
              f"{name}_A": np.asarray(c["A"]),
              f"{name}_mode": np.asarray(c["mode"]),
              f"{name}_protocol": np.asarray(c.get("protocol", "nakamoto")),
              f"{name}_k": np.asarray(c.get("k", 1)),
              f"{name}_queue": np.asarray(c.get("queue", 0))})
    return d


def compiled_net(fx, name):
    """The port's CompiledNet from a case's planes in the fixture."""
    from cpr_tpu_torch.netsim.compile import CompiledNet
    g = lambda f: fx[f"{name}_net_{f}"]  # noqa: E731
    return CompiledNet(n=int(g("n")), compute=g("compute"), kind=g("kind"),
                       p0=g("p0"), p1=g("p1"),
                       activation_delay=float(g("activation_delay")),
                       flooding=bool(g("flooding")))


def replay(fx, name, device) -> dict:
    """The port's run of a fixture case on `device` (the plain versions
    on the CPU, the widened kernels on CUDA), from the fixture alone:
    the outputs as tensors, with the plain versions' `margin`."""
    from cpr_tpu_torch import netsim
    from cpr_tpu_torch.netsim import attack as AT
    from cpr_tpu_torch.netsim import engine as E
    cn = compiled_net(fx, name)
    A = int(fx[f"{name}_A"])
    mode = str(fx[f"{name}_mode"])
    keys = E.lane_keys(fx[f"{name}_seeds"].tolist(), device)
    dl = torch.as_tensor(fx[f"{name}_delays"], dtype=torch.float64,
                         device=device)
    if mode == "attack":
        eng = netsim.AttackEngine(cn, activations=A,
                                  policies=ATTACK_POLICIES, device=device,
                                  queue_cap=int(fx[f"{name}_queue"]) or None)
        al = torch.as_tensor(fx[f"{name}_alphas"], device=device)
        pi = torch.as_tensor(fx[f"{name}_pids"], device=device)
        if keys.is_cuda:
            return eng.lanes(keys, dl, al, pi)
        return AT.attack_plain(cn, A, eng.B, eng.M, eng.F, eng.S, eng.WA,
                               keys, dl, al, eng._branches(), pi,
                               eng.strict_match)
    eng = netsim.Engine(cn, activations=A, mode=mode, device=device,
                        protocol=str(fx[f"{name}_protocol"]),
                        k=int(fx[f"{name}_k"]))
    if keys.is_cuda:
        return eng.lanes(keys, dl)
    if eng.mode == "scan":
        return E.scan_plain(cn, A, eng.lookback, keys, dl)
    return E.event_plain(cn, A, eng.B, eng.M, eng.F, eng.S, keys, dl,
                         eng.proto)


def check_case(got, want, name, what):
    """Integers exact, times within TIME_RTOL (numpy outputs after
    `engine.finish`, `want` prefixed by the case's name)."""
    keys = ATTACK_KEYS if CASES[name]["mode"] == "attack" else OUT_KEYS
    for k in keys:
        w = want[f"{name}_{k}"]
        if k in TIME_KEYS:
            np.testing.assert_allclose(got[k], w, rtol=TIME_RTOL, atol=0,
                                       err_msg=f"{name} {what} {k}")
        else:
            np.testing.assert_array_equal(got[k], w,
                                          err_msg=f"{name} {what} {k}")
            assert np.asarray(got[k]).dtype == np.asarray(w).dtype, \
                (name, what, k)


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_versions_match_reference_past_32_nodes(fx, name):
    from cpr_tpu_torch.netsim import engine as E
    ref = jax_case(name)
    out = replay(ref, name, "cpu")
    margin = float(out.pop("margin").min())
    got = E.finish(out)
    n = int(ref[f"{name}_net_n"])
    print(f"{name}: {n} nodes ({E.node_slots(n)} slots a thread on the "
          f"card), smallest decision margin {margin:.3e}")
    assert n > 32 and E.node_slots(n) > 1
    assert margin > TIME_RTOL * float(ref[f"{name}_sim_time"].max())
    check_case(got, ref, name, "port vs cpr_tpu")
    A = CASES[name]["A"]
    if "queue" in CASES[name]:  # every lane overflows the small queue
        assert np.all(got["drop_q"] > 0) and np.any(got["drop_p"] > 0)
    else:
        for k in ("drop_q", "drop_p", "drop_b"):
            assert not np.any(got[k]), (name, k)
    assert not np.any(got["exhausted"]), name
    if name == "ethbyz_clique64":
        # every orphan but the newest is an uncle: blocks off the head's
        # chain, yet the head's progress within one of the activations
        assert np.all(ref[f"{name}_head_height"] < A)
        assert np.all(ref[f"{name}_progress"] >= A - 1)
    assert np.all(got["node_act"].sum(1) == A) and np.all(got["n_act"] == A)
    # the fixture the kernels are held to on the card is this run's
    check_case(got, fx, name, "port vs the fixture")


def main():
    enter_x64_standin()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    arrays = {"attack_policies": np.asarray(ATTACK_POLICIES)}
    for name in CASES:
        arrays.update(jax_case(name))
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
