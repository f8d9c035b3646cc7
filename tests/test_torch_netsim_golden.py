"""The committed JAX golden fixture for the port's netsim slice (K1's
float64 draws, K12-scan, K12-event, K13).

`tests/fixtures/torch_port_netsim_golden.npz` holds `cpr_tpu`'s outputs
(JAX on the CPU, 64-bit mode) for:

  k1              float64 uniform, clamped uniform ([1e-12, 1)) and
                  exponential draws of five 64-bit mode keys;
  scan_const      K12-scan on the 10-node bench clique (delay 1.0,
                  activation delay 30), 8 lanes x 600 activations;
  scan_exp/_uni/_geo  a 5-node clique with exponential / uniform /
                  geometric link delays, 4 lanes x 400;
  event_clique    the event engine on a 5-node clique, 8 lanes x 300;
  event_flood     flooding on random_regular(13, 4) with exponential
                  delays, 4 lanes x 40;
  attack_clique   the attacker on clique-4 (delay 10), every scripted
                  policy at alpha 0.3 and 0.45, 8 lanes x 300;
  attack_two      the same on two_agents.

Each case stores its mode, topology planes, lane inputs (the attack
cases' policy ids index `attack_policies`) and every output, so a
machine without jax rebuilds it from the fixture alone.
`chip_smoke.py` holds the CUDA kernels to it on the card; this test
replays every case through the port's plain versions on the CPU and
recomputes the K1 and scan_const cases live. `python
tests/test_torch_netsim_golden.py` rewrites the fixture (~30 s).

Tolerances: integer outputs exact; float64 times within TIME_RTOL
(test_torch_netsim.py); draws through log/log1p within 1e-13 relative.
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
from test_torch_netsim import (TIME_KEYS, TIME_RTOL,  # noqa: E402,F401
                               enter_x64_standin, jax_x64, one_torch_thread)

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_netsim_golden.npz")
K1_SEEDS = (0, 7, 2**32 + 5, -3, 2**40 + 11)
K1_N = 64
ATTACK_POLICIES = ("honest", "simple", "eyal-sirer-2014",
                   "sapirshtein-2016-sm1")
CASES = {
    "scan_const": dict(mode="scan", lanes=8, A=600, delay=30.0),
    "scan_exp": dict(mode="scan", lanes=4, A=400, delay=25.0),
    "scan_uni": dict(mode="scan", lanes=4, A=400, delay=25.0),
    "scan_geo": dict(mode="scan", lanes=4, A=400, delay=25.0),
    "event_clique": dict(mode="event", lanes=8, A=300, delay=25.0),
    "event_flood": dict(mode="event", lanes=4, A=40, delay=30.0),
    "attack_clique": dict(mode="attack", lanes=8, A=300, delay=30.0),
    "attack_two": dict(mode="attack", lanes=8, A=300, delay=60.0),
}
OUT_KEYS = ("head", "head_height", "progress", "on_chain", "sim_time",
            "n_blocks", "n_act", "node_act", "reward", "steps", "drop_q",
            "drop_p", "drop_b", "win_miss", "exhausted")
ATTACK_KEYS = OUT_KEYS + ("reward_attacker", "reward_defender")


def jax_network(name):
    from cpr_tpu import distributions as jdist
    from cpr_tpu import network as jnetwork
    link = {"scan_exp": jdist.exponential(2.0),
            "scan_uni": jdist.uniform(0.5, 3.0),
            "scan_geo": jdist.geometric(0.4)}
    if name == "scan_const":
        return jnetwork.symmetric_clique(10, activation_delay=30.0,
                                         propagation_delay=1.0)
    if name in link or name == "event_clique":
        net = jnetwork.symmetric_clique(5, activation_delay=25.0,
                                        propagation_delay=1.0)
        for nd in net.nodes:
            for ln in nd.links:
                ln.delay = link.get(name, ln.delay)
        return net
    if name == "event_flood":
        return jnetwork.random_regular(13, 4, activation_delay=30.0,
                                       delay=jdist.exponential(2.0), seed=1)
    if name == "attack_clique":
        return jnetwork.symmetric_clique(4, activation_delay=30.0,
                                         propagation_delay=10.0)
    return jnetwork.two_agents(alpha=0.3, activation_delay=60.0)


def lane_inputs(name):
    c = CASES[name]
    n = c["lanes"]
    seeds = np.arange(n, dtype=np.int64) * 17 + 3
    delays = np.full(n, c["delay"]) * np.where(np.arange(n) % 2, 2.0, 1.0)
    alphas = np.where(np.arange(n) % 2, 0.45, 0.3).astype(np.float32)
    pids = (np.arange(n) // 2 % len(ATTACK_POLICIES)).astype(np.int32)
    return seeds, delays, alphas, pids


def jax_case(name) -> dict:
    """cpr_tpu's run of one case: its inputs and outputs, prefixed."""
    from cpr_tpu import netsim as jnetsim
    c = CASES[name]
    cn = jnetsim.compile_network(jax_network(name))
    seeds, delays, alphas, pids = lane_inputs(name)
    if c["mode"] == "attack":
        out = jnetsim.AttackEngine(
            cn, activations=c["A"], policies=ATTACK_POLICIES).run(
            seeds.tolist(), delays.tolist(), alphas.tolist(), pids.tolist())
    else:
        out = jnetsim.Engine(cn, activations=c["A"], mode=c["mode"]).run(
            seeds.tolist(), delays.tolist())
    d = {f"{name}_{k}": np.asarray(v) for k, v in out.items()}
    d.update({f"{name}_net_{f}": np.asarray(getattr(cn, f)) for f in (
        "n", "compute", "kind", "p0", "p1", "activation_delay",
        "flooding")})
    d.update({f"{name}_seeds": seeds, f"{name}_delays": delays,
              f"{name}_alphas": alphas, f"{name}_pids": pids,
              f"{name}_A": np.asarray(c["A"]),
              f"{name}_mode": np.asarray(c["mode"])})
    return d


def jax_k1() -> dict:
    u, uc, e = [], [], []
    with jax.enable_x64(True):
        for s in K1_SEEDS:
            k = jax.random.PRNGKey(s)
            u.append(np.asarray(jax.random.uniform(
                k, (K1_N,), dtype=jax.numpy.float64)))
            uc.append(np.asarray(jax.random.uniform(
                k, (K1_N,), minval=1e-12, maxval=1.0,
                dtype=jax.numpy.float64)))
            e.append(np.asarray(jax.random.exponential(
                k, (K1_N,), dtype=jax.numpy.float64)))
    return dict(k1_seeds=np.asarray(K1_SEEDS, dtype=np.int64),
                k1_uniform=np.stack(u), k1_clamped=np.stack(uc),
                k1_exponential=np.stack(e))


def compiled_net(fx, name):
    """The port's CompiledNet from a case's planes in the fixture."""
    from cpr_tpu_torch.netsim.compile import CompiledNet
    g = lambda f: fx[f"{name}_net_{f}"]  # noqa: E731
    return CompiledNet(n=int(g("n")), compute=g("compute"), kind=g("kind"),
                       p0=g("p0"), p1=g("p1"),
                       activation_delay=float(g("activation_delay")),
                       flooding=bool(g("flooding")))


def replay(fx, name, device) -> dict:
    """The port's run of a fixture case on `device` (plain versions on
    the CPU, the kernels on CUDA): outputs as tensors."""
    from cpr_tpu_torch import netsim
    from cpr_tpu_torch.netsim import engine as E
    cn = compiled_net(fx, name)
    A = int(fx[f"{name}_A"])
    mode = CASES[name]["mode"]
    keys = E.lane_keys(fx[f"{name}_seeds"].tolist(), device)
    dl = torch.as_tensor(fx[f"{name}_delays"], dtype=torch.float64,
                         device=device)
    if mode == "attack":
        eng = netsim.AttackEngine(cn, activations=A,
                                  policies=ATTACK_POLICIES, device=device)
        return eng.lanes(keys, dl, torch.as_tensor(fx[f"{name}_alphas"],
                                                   device=device),
                         torch.as_tensor(fx[f"{name}_pids"], device=device))
    eng = netsim.Engine(cn, activations=A, mode=mode, device=device)
    return eng.lanes(keys, dl)


def check_case(fx, name, got: dict) -> None:
    """Integers exact, times within TIME_RTOL; `got` as numpy after
    `engine.finish`."""
    keys = ATTACK_KEYS if CASES[name]["mode"] == "attack" else OUT_KEYS
    for k in keys:
        want = fx[f"{name}_{k}"]
        if k in TIME_KEYS:
            np.testing.assert_allclose(got[k], want, rtol=TIME_RTOL, atol=0,
                                       err_msg=f"{name} {k}")
        else:
            np.testing.assert_array_equal(got[k], want,
                                          err_msg=f"{name} {k}")


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_versions_replay_the_fixture(fx, name):
    from cpr_tpu_torch.netsim import engine as E
    check_case(fx, name, E.finish(replay(fx, name, "cpu")))


def test_fixture_is_current(fx):
    """The fixture's K1 draws and scan_const case are what cpr_tpu
    computes now."""
    k1 = jax_k1()
    for k in ("k1_uniform", "k1_clamped"):
        np.testing.assert_array_equal(fx[k], k1[k])
    np.testing.assert_allclose(fx["k1_exponential"], k1["k1_exponential"],
                               rtol=1e-15, atol=0)
    live = jax_case("scan_const")
    for k, v in live.items():
        if k.removeprefix("scan_const_") in TIME_KEYS:
            np.testing.assert_allclose(fx[k], v, rtol=TIME_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(fx[k], v, err_msg=k)


def test_k1_float64_draws_replay_the_fixture(fx):
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.netsim.compile import clamp_uniform
    for i, s in enumerate(K1_SEEDS):
        key = rnd.PRNGKey(s, "cpu", x64=True)
        u = rnd.uniform(key, (K1_N,), dtype=torch.float64)
        np.testing.assert_array_equal(u.numpy(), fx["k1_uniform"][i])
        np.testing.assert_array_equal(
            rnd.uniform(key, (K1_N,), 1e-12, 1.0,
                        dtype=torch.float64).numpy(), fx["k1_clamped"][i])
        np.testing.assert_array_equal(clamp_uniform(u).numpy(),
                                      fx["k1_clamped"][i])
        np.testing.assert_allclose(
            rnd.exponential(key, (K1_N,), dtype=torch.float64).numpy(),
            fx["k1_exponential"][i], rtol=1e-13, atol=0)


def main():
    enter_x64_standin()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    arrays = jax_k1()
    arrays["attack_policies"] = np.asarray(ATTACK_POLICIES)
    for name in CASES:
        arrays.update(jax_case(name))
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
