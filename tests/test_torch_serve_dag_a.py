"""Port parity of the serve engine over the DAG envs (K14-dag's plain
twin `ResidentEngine._burst_plain`, the splice and the tick) against
cpr_tpu's `serve/engine.py` on the CPU: Bₖ, Ethereum and TailstormJune
here, Tailstorm in test_torch_serve_dag_b.py, Stree, Sdag and Spar in
test_torch_serve_dag_c.py; and the committed JAX fixture of
chip_smoke.py's phase 62.

Both engines start from the same seeds and take the same numpy-seeded
schedule of `splice`, `tick` and `burst_run` (the port's policy
sessions admitted with their burst, `burst_run(admit=)`, the server's
route), with mid-flight admissions and lane reuse, over every scripted
policy: first-done registers, integer state, keys, done flags and
rewards equal, observations within 1e-6 and the clocks of the carry
within rtol 1e-5, the whole carry (every DAG plane, stale rows
included) after every round. Each family runs at k = 2 where its key
has a k, 16 lanes, burst 8, max_steps 16, in full mode
(`get_sized(key, 16)`) and in a 40-slot ring (TailstormJune in full
mode only, its only mode).

`tests/fixtures/torch_port_serve_dag_golden.npz` holds cpr_tpu's bursts
(JAX on the CPU) of a three-burst schedule with admissions, for every
family in full mode and Tailstorm in the ring: the inputs, every
burst's registers and the final carry. `chip_smoke.py` holds K14-dag to
it on the card; the test here replays it through the port's plain
engine. `PYTHONPATH=. python tests/test_torch_serve_dag_a.py` rewrites
it (about two minutes) and is its only writer.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from cpr_tpu.envs import registry as jregistry  # noqa: E402
from cpr_tpu.params import make_params as jmake  # noqa: E402
from cpr_tpu.serve.engine import ResidentEngine as JEngine  # noqa: E402
from cpr_tpu_torch import convert  # noqa: E402
from cpr_tpu_torch.envs import registry as tregistry  # noqa: E402
from cpr_tpu_torch.params import make_params as tmake  # noqa: E402
from cpr_tpu_torch.serve.engine import (BURST_FIELDS,  # noqa: E402
                                        ResidentEngine)
from test_torch_bk import assert_state_numpy, jax_state_numpy  # noqa: E402

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_serve_dag_golden.npz")

N_LANES, BURST, MAX_STEPS, ALPHA, RING = 16, 8, 16, 0.33, 40
ROUNDS = 5
# family: its registry key, k = 2 where the key has a k
KEYS = {"bk": "bk-2-constant", "eth": "ethereum-byzantium",
        "ts": "tailstorm-2-discount-heuristic",
        "stree": "stree-2-constant-heuristic", "spar": "spar-2-constant",
        "sdag": "sdag-2-discount-heuristic", "june": "tailstormjune-2-block"}
# the fixture: every family in full mode and Tailstorm in the ring
FX_CASES = {**{n: (k, 0) for n, k in KEYS.items()},
            "ts_ring": (KEYS["ts"], RING)}
FX_BURSTS = 3


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def env_pair(key: str, window: int):
    """The reference's env and the port's: a `window`-slot ring, or full
    mode at the engine's sizing (window 0)."""
    if window:
        return (jregistry.get(key, window=window),
                tregistry.get(key, window=window))
    return (jregistry.get_sized(key, MAX_STEPS),
            tregistry.get_sized(key, MAX_STEPS))


def params_pair():
    return (jmake(alpha=ALPHA, gamma=0.5, max_steps=MAX_STEPS),
            tmake(alpha=ALPHA, gamma=0.5, max_steps=MAX_STEPS))


def assert_regs(got, want, what):
    for k in BURST_FIELDS:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")


def assert_carry(te, je, what):
    """The port's whole carry against the reference's: every DAG plane
    and scalar (clocks within rtol 1e-5), the observations within 1e-6."""
    np.testing.assert_allclose(te._carry[1].numpy(),
                               np.asarray(je._carry[1]), rtol=1e-6,
                               atol=1e-6, err_msg=f"{what} obs")
    assert_state_numpy(convert.dag_state_to_numpy(te._carry[0]),
                       jax_state_numpy(je._carry[0]), what)


def run_schedule(je, te, seed: int, *, drain=None):
    """The numpy-seeded schedule over a started engine pair: each round
    admits free lanes (a quarter interactive, by `splice`; policy lanes
    by `splice` or with their burst, `burst_run(admit=)`, half each),
    ticks the interactive lanes with seeded actions, bursts the policy
    lanes, drops the lanes whose episode ended, and holds registers and
    carry to the reference. `drain(je, te, t0)` (t0: the port's step
    counters before the burst) runs after each burst. Returns the
    episodes ended in bursts."""
    rng = np.random.default_rng(seed)
    n_pol = len(te.policy_names)
    n_act = te.env.n_actions
    owner, next_seed, episodes = {}, 1000 * seed, 0
    for r in range(ROUNDS):
        spliced, with_burst = {}, {}
        for ln in range(N_LANES):
            if ln in owner or rng.random() >= 0.8:
                continue
            next_seed += 1
            if rng.random() < 0.25:
                owner[ln] = "interactive"
                spliced[ln] = next_seed
            else:
                owner[ln] = int(rng.integers(n_pol))
                (spliced if rng.random() < 0.5 else with_burst)[ln] = \
                    next_seed
        oj, ot = je.splice(spliced), te.splice(spliced)
        assert oj.keys() == ot.keys()
        for ln in oj:
            np.testing.assert_allclose(ot[ln], np.asarray(oj[ln]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"splice {ln}")
        acts = {ln: int(rng.integers(n_act)) for ln, o in owner.items()
                if o == "interactive"}
        if acts:
            rj, rt = je.tick(acts), te.tick(acts)
            for ln in acts:
                np.testing.assert_allclose(rt[ln]["obs"],
                                           np.asarray(rj[ln]["obs"]),
                                           rtol=1e-6, atol=1e-6)
                assert rt[ln]["reward"] == rj[ln]["reward"]
                assert rt[ln]["done"] == rj[ln]["done"]
                for k, v in rj[ln]["info"].items():
                    assert rt[ln]["info"][k] == pytest.approx(
                        v, rel=1e-5, abs=1e-6), k
                if rj[ln]["done"]:
                    del owner[ln]
        lanes = {ln: o for ln, o in owner.items() if o != "interactive"}
        t0 = None if te._exp is None else te._exp["t"].numpy().copy()
        je.splice(with_burst)
        bj = je.burst_run(lanes)
        bt = te.burst_run(lanes, admit=with_burst)
        if lanes:
            assert_regs(bt, bj, f"round {r} burst")
            for ln in lanes:
                if bj["done"][ln]:
                    episodes += 1
                    del owner[ln]
        else:
            assert bj is None and bt is None
        if drain is not None:
            drain(je, te, t0)
        assert_carry(te, je, f"round {r}")
    for k in ("steps", "episodes", "bursts", "ticks", "admitted"):
        assert te.report()[k] == je.report()[k], k
    return episodes


def engine_pair(key: str, window: int, **kw):
    """Started engines over the env pair; `kw` the port's extra keyword
    arguments, `jkw` in them the reference's."""
    jenv, tenv = env_pair(key, window)
    jp, tp = params_pair()
    jkw = kw.pop("jkw", {})
    je = JEngine(jenv, jp, n_lanes=N_LANES, burst=BURST, **jkw)
    te = ResidentEngine(tenv, tp, n_lanes=N_LANES, burst=BURST,
                        device="cpu", **kw)
    assert te.policy_names == je.policy_names
    je.start()
    te.start()
    return je, te


def check_family(name: str, window: int, seed: int):
    je, te = engine_pair(KEYS[name], window)
    assert te.env.ring == bool(window)
    episodes = run_schedule(je, te, seed)
    assert episodes > 0, f"{name}: no burst ended an episode"


@pytest.mark.parametrize("name,window", [("bk", 0), ("bk", RING),
                                         ("eth", 0), ("eth", RING),
                                         ("june", 0)],
                         ids=["full-bk", "ring-bk", "full-eth", "ring-eth",
                              "full-june"])
def test_schedule_matches_reference(name, window):
    check_family(name, window, 13 + len(name) + window)


# -- the fixture of chip_smoke.py's phase 62 ---------------------------------

def fixture_inputs(case: str):
    """The fixture's schedule for `case`: per burst the lane policies
    (-1: held) and the admissions (mask, seeds); every lane admitted
    with the first burst, then a seeded sixth of the lanes, some live
    and some held."""
    rng = np.random.default_rng(620 + list(FX_CASES).index(case))
    _, tenv = env_pair(*FX_CASES[case])
    n_pol = len([n for n in tenv.policies
                 if not getattr(tenv.policies[n], "takes_state", False)])
    out = []
    for b in range(FX_BURSTS):
        pol = rng.permutation(np.arange(N_LANES) % n_pol).astype(np.int32)
        pol[rng.random(N_LANES) < 0.2] = -1
        mask = (np.ones(N_LANES, bool) if b == 0
                else rng.random(N_LANES) < 1 / 6)
        # every burst admits a live lane, and the later ones a held lane
        mask[:2] = True
        pol[0] = b % n_pol
        pol[1] = -1 if b else pol[1]
        seeds = np.where(mask, rng.integers(1, 1 << 31, N_LANES),
                         0).astype(np.uint32)
        out.append((pol, mask, seeds))
    return out


def build_golden() -> dict[str, np.ndarray]:
    """Every array of the fixture, computed by cpr_tpu on this host."""
    from test_torch_dag_golden import state_arrays
    out = {}
    for case, (key, window) in FX_CASES.items():
        jenv, _ = env_pair(key, window)
        jp, _ = params_pair()
        je = JEngine(jenv, jp, n_lanes=N_LANES, burst=BURST)
        je.start()
        out[f"{case}_key"] = np.array(key)
        out[f"{case}_window"] = np.int32(window)
        for b, (pol, mask, seeds) in enumerate(fixture_inputs(case)):
            je.splice({int(ln): int(seeds[ln]) for ln in np.nonzero(mask)[0]})
            regs = je.burst_run({int(ln): int(pol[ln])
                                 for ln in np.nonzero(pol >= 0)[0]})
            out[f"{case}_b{b}_policy"] = pol
            out[f"{case}_b{b}_admit"] = mask
            out[f"{case}_b{b}_seeds"] = seeds
            for k in BURST_FIELDS:
                out[f"{case}_b{b}_{k}"] = np.asarray(regs[k])
        out.update(state_arrays(f"{case}_final_", je._carry[0]))
        out[f"{case}_final_obs_carry"] = np.asarray(je._carry[1])
    return out


@pytest.fixture(scope="module")
def committed():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("case", sorted(FX_CASES))
def test_port_replays_fixture(committed, case):
    """The port's plain engine reproduces the fixture's bursts (its
    inputs, registers and final carry): the replay chip_smoke.py's phase
    62 runs through K14-dag on the card."""
    from test_torch_dag_golden import fixture_state
    fx = committed
    key, window = str(fx[f"{case}_key"]), int(fx[f"{case}_window"])
    assert (key, window) == FX_CASES[case]
    _, tenv = env_pair(key, window)
    _, tp = params_pair()
    te = ResidentEngine(tenv, tp, n_lanes=N_LANES, burst=BURST,
                        device="cpu")
    te.start()
    ended = 0
    for b in range(FX_BURSTS):
        pol, mask = fx[f"{case}_b{b}_policy"], fx[f"{case}_b{b}_admit"]
        seeds = fx[f"{case}_b{b}_seeds"]
        regs = te.burst_run({int(ln): int(pol[ln])
                             for ln in np.nonzero(pol >= 0)[0]},
                            admit={int(ln): int(seeds[ln])
                                   for ln in np.nonzero(mask)[0]})
        assert_regs(regs, {k: fx[f"{case}_b{b}_{k}"] for k in BURST_FIELDS},
                    f"{case} burst {b}")
        ended += int(regs["done"].sum())
        # the schedule admits live and held lanes alike
        assert mask[0] and pol[0] >= 0 and (b == 0 or pol[1] < 0)
    assert ended > 0, case
    want = convert.dag_state_from_numpy(
        tenv, fixture_state(fx, f"{case}_final_"), device="cpu")
    assert_state_numpy(convert.dag_state_to_numpy(te._carry[0]),
                       convert.dag_state_to_numpy(want), case)
    np.testing.assert_allclose(te._carry[1].numpy(),
                               fx[f"{case}_final_obs_carry"], rtol=1e-6,
                               atol=1e-6)


if __name__ == "__main__":
    import os

    # XLA at the tests' optimization level (tests/conftest.py)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0")
    jax.config.update("jax_platforms", "cpu")
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        FIXTURE.parent.mkdir(parents=True, exist_ok=True)
        golden = build_golden()
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    np.savez_compressed(FIXTURE, **golden)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes, "
          f"{len(golden)} arrays)")
