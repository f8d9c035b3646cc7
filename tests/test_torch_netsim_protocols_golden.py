"""The committed JAX golden fixture for the netsim's Bk, Ethereum and Spar
branches (K12-event-bk, K12-event-eth, K12-event-spar).

`tests/fixtures/torch_port_netsim_protocols_golden.npz` holds
`cpr_tpu.netsim.Engine`'s outputs (JAX on the CPU, 64-bit mode) for:

  deep_*    the honest-network sweep's seven event configurations
            (Ethereum whitepaper and Byzantium, Bk k=4 constant, k=8
            constant and block, Spar k=4 constant and block) on its
            10-node clique (propagation 1.0), seed 0 at activation delays
            30, 60, 120, 300 and 600, at a reduced depth of 2000
            activations;
  small_*   Bk k=2 and Spar k=1 under the `block` scheme (the 5-node
            clique of test_torch_netsim_protocols.py);
  miss_*    forced window misses: Bk k=4 with a 3-slot window, Spar k=4
            with a 4-slot window, the whitepaper with room for one uncle;
  flood_*   Ethereum and Spar with flooding on random_regular(6, 3) with
            exponential link delays (Bk's flooding case is live in
            test_torch_netsim_protocols.py; chip_smoke.py holds each
            kernel to its plain version with flooding on
            random_regular(13, 4)).

Each case stores its protocol configuration, topology planes, lane inputs
and every output, so a machine without jax rebuilds it from the fixture
alone: `chip_smoke.py` holds the CUDA kernels to every case on the card.
This test replays the small_, miss_ and flood_ cases through the port's
plain versions on the CPU (the deep cases take minutes there), checks
the deep cases' invariants and sizes, and recomputes one case live.
`python tests/test_torch_netsim_protocols_golden.py` rewrites the
fixture (~3 min, XLA at the tests' optimization level 0).

Tolerances: integer outputs and float32 rewards exact; float64 times
within TIME_RTOL (test_torch_netsim.py).
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
           / "torch_port_netsim_protocols_golden.npz")
SWEEP_DELAYS = (30.0, 60.0, 120.0, 300.0, 600.0)
DEEP_ACTS = 2000
# name: (protocol, k, scheme, topology, activations, seeds, delays, window,
# uncle_cap); window and uncle_cap 0 take the engine's defaults
_DEEP = dict(topology="clique10", A=DEEP_ACTS, seeds=[0] * 5,
             delays=list(SWEEP_DELAYS))
_SMALL = dict(topology="clique5", A=160, seeds=[3, 11], delays=[50.0, 200.0])
_MISS = dict(topology="clique5", seeds=[3, 11], delays=[4.0, 12.0])
_FLOOD = dict(topology="flood6", A=30, seeds=[3, 20],
              delays=[25.0, 50.0])
CASES = {
    "deep_eth_whitepaper": dict(_DEEP, protocol="ethereum-whitepaper"),
    "deep_eth_byzantium": dict(_DEEP, protocol="ethereum-byzantium"),
    "deep_bk4_constant": dict(_DEEP, protocol="bk", k=4),
    "deep_bk8_constant": dict(_DEEP, protocol="bk", k=8),
    "deep_bk8_block": dict(_DEEP, protocol="bk", k=8, scheme="block"),
    "deep_spar4_constant": dict(_DEEP, protocol="spar", k=4),
    "deep_spar4_block": dict(_DEEP, protocol="spar", k=4, scheme="block"),
    "small_bk2_block": dict(_SMALL, protocol="bk", k=2, scheme="block"),
    "small_spar1_block": dict(_SMALL, protocol="spar", k=1, scheme="block"),
    "miss_bk4_window": dict(_MISS, protocol="bk", k=4, A=100, window=3),
    "miss_spar4_window": dict(_MISS, protocol="spar", k=4, A=300, window=4),
    "miss_eth_uncles": dict(_MISS, protocol="ethereum-whitepaper", A=150,
                            uncle_cap=1),
    "flood_eth_whitepaper": dict(_FLOOD, protocol="ethereum-whitepaper"),
    "flood_spar3": dict(_FLOOD, protocol="spar", k=3),
}
OUT_KEYS = ("head", "head_height", "progress", "on_chain", "sim_time",
            "n_blocks", "n_act", "node_act", "reward", "steps", "drop_q",
            "drop_p", "drop_b", "win_miss", "exhausted")
REPLAYED = sorted(n for n in CASES if not n.startswith("deep_"))


def cfg(name) -> dict:
    c = dict(k=1, scheme="constant", window=0, uncle_cap=0)
    c.update(CASES[name])
    return c


def jax_network(topology):
    from cpr_tpu import distributions as jdist
    from cpr_tpu import network as jnetwork
    if topology == "clique10":
        return jnetwork.symmetric_clique(10, activation_delay=30.0,
                                         propagation_delay=1.0)
    if topology == "clique5":
        return jnetwork.symmetric_clique(5, activation_delay=50.0,
                                         propagation_delay=1.0)
    return jnetwork.random_regular(6, 3, activation_delay=25.0,
                                   delay=jdist.exponential(2.0), seed=3)


def engine_kw(c) -> dict:
    kw = dict(protocol=c["protocol"], k=c["k"], scheme=c["scheme"],
              activations=c["A"])
    if c["window"]:
        kw["window"] = c["window"]
    if c["uncle_cap"]:
        kw["uncle_cap"] = c["uncle_cap"]
    return kw


def jax_case(name) -> dict:
    """cpr_tpu's run of one case: its inputs and outputs, prefixed."""
    from cpr_tpu import netsim as jnetsim
    c = cfg(name)
    cn = jnetsim.compile_network(jax_network(c["topology"]))
    eng = jnetsim.Engine(cn, **engine_kw(c))
    out = eng.run(c["seeds"], c["delays"])
    d = {f"{name}_{k}": np.asarray(v) for k, v in out.items()}
    d.update({f"{name}_net_{f}": np.asarray(getattr(cn, f)) for f in (
        "n", "compute", "kind", "p0", "p1", "activation_delay",
        "flooding")})
    d.update({f"{name}_seeds": np.asarray(c["seeds"], np.int64),
              f"{name}_delays": np.asarray(c["delays"], np.float64),
              f"{name}_A": np.asarray(c["A"]),
              f"{name}_protocol": np.asarray(c["protocol"]),
              f"{name}_k": np.asarray(c["k"]),
              f"{name}_scheme": np.asarray(c["scheme"]),
              f"{name}_window": np.asarray(c["window"]),
              f"{name}_uncle_cap": np.asarray(c["uncle_cap"]),
              f"{name}_B": np.asarray(eng.B), f"{name}_W": np.asarray(eng.W),
              f"{name}_U": np.asarray(eng.U)})
    return d


def fixture_engine(fx, name, device):
    """The port's Engine of a fixture case, from the fixture alone."""
    from cpr_tpu_torch import netsim
    from cpr_tpu_torch.netsim.compile import CompiledNet
    g = lambda f: fx[f"{name}_net_{f}"]  # noqa: E731
    cn = CompiledNet(n=int(g("n")), compute=g("compute"), kind=g("kind"),
                     p0=g("p0"), p1=g("p1"),
                     activation_delay=float(g("activation_delay")),
                     flooding=bool(g("flooding")))
    kw = dict(protocol=str(fx[f"{name}_protocol"]), k=int(fx[f"{name}_k"]),
              scheme=str(fx[f"{name}_scheme"]),
              activations=int(fx[f"{name}_A"]))
    if int(fx[f"{name}_window"]):
        kw["window"] = int(fx[f"{name}_window"])
    if int(fx[f"{name}_uncle_cap"]):
        kw["uncle_cap"] = int(fx[f"{name}_uncle_cap"])
    return netsim.Engine(cn, mode="event", device=device, **kw)


def replay(fx, name, device) -> dict:
    """The port's run of a fixture case on `device` (plain versions on
    the CPU, the kernels on CUDA): outputs as tensors."""
    from cpr_tpu_torch.netsim import engine as E
    eng = fixture_engine(fx, name, device)
    keys = E.lane_keys(fx[f"{name}_seeds"].tolist(), device)
    dl = torch.as_tensor(fx[f"{name}_delays"], dtype=torch.float64,
                         device=device)
    return eng.lanes(keys, dl)


def check_case(fx, name, got: dict) -> None:
    """Integers and rewards exact, times within TIME_RTOL; `got` as numpy
    after `engine.finish`."""
    for k in OUT_KEYS:
        want = fx[f"{name}_{k}"]
        if k in TIME_KEYS:
            np.testing.assert_allclose(got[k], want, rtol=TIME_RTOL, atol=0,
                                       err_msg=f"{name} {k}")
        else:
            np.testing.assert_array_equal(got[k], want,
                                          err_msg=f"{name} {k}")
            assert got[k].dtype == want.dtype, (name, k)


@pytest.fixture(scope="module")
def fx():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("name", REPLAYED)
def test_plain_versions_replay_the_fixture(fx, name):
    from cpr_tpu_torch.netsim import engine as E
    check_case(fx, name, E.finish(replay(fx, name, "cpu")))
    if name.startswith("miss_"):
        # the forced misses happen (and the port counts them as the JAX
        # package does, held above)
        assert np.any(fx[f"{name}_win_miss"] > 0)


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if n.startswith("deep_")))
def test_deep_cases_are_the_sweep_path(fx, name):
    """The deep cases (replayed by the kernels on the card) are healthy
    runs of the sweep's configurations, sized as the port sizes them."""
    eng = fixture_engine(fx, name, "cpu")
    assert (eng.B, eng.W, eng.U) == tuple(int(fx[f"{name}_{f}"])
                                         for f in ("B", "W", "U"))
    c = cfg(name)
    assert fx[f"{name}_delays"].tolist() == list(SWEEP_DELAYS)
    for key in ("drop_q", "drop_p", "drop_b", "win_miss", "exhausted"):
        assert not np.any(fx[f"{name}_{key}"]), (name, key)
    assert np.all(fx[f"{name}_node_act"].sum(1) == DEEP_ACTS)
    hh = fx[f"{name}_head_height"].astype(np.float64)
    if c["protocol"] == "spar":
        np.testing.assert_array_equal(fx[f"{name}_progress"], c["k"] * hh)
    if c["scheme"] == "constant" and c["protocol"] in ("bk", "spar"):
        np.testing.assert_array_equal(fx[f"{name}_reward"].sum(1),
                                      fx[f"{name}_progress"])
    orphan = 1.0 - fx[f"{name}_progress"] / DEEP_ACTS
    assert np.all((orphan >= 0) & (orphan <= 0.2))


def test_fixture_is_current(fx):
    """Two cases are what cpr_tpu computes now."""
    for name in ("miss_spar4_window", "small_spar1_block"):
        live = jax_case(name)
        for k, v in live.items():
            if k.removeprefix(name + "_") in TIME_KEYS:
                np.testing.assert_allclose(fx[k], v, rtol=TIME_RTOL, atol=0)
            else:
                np.testing.assert_array_equal(fx[k], v, err_msg=k)


def main():
    enter_x64_standin()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    arrays = {}
    for name in CASES:
        arrays.update(jax_case(name))
        print(name, "win_miss", arrays[f"{name}_win_miss"].tolist(),
              "steps", arrays[f"{name}_steps"].tolist(), flush=True)
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
