"""The committed JAX golden fixture for the vote-quorum kernels (K9,
K10-ts, K10-stree).

`tests/fixtures/torch_port_quorum_golden.npz` holds outputs of `cpr_tpu`
(JAX on the CPU), for Tailstorm (`ts`: k = 8, discount, heuristic) and
Stree (`stree`: k = 8, constant, heuristic), both at window 128:
- `k9_<env>_*`: 64 lanes of the env's auto-reset stream carry after 190
  steps at max_steps 200 (the ring has wrapped), the selector inputs the
  port's `quorum.check_inputs` draws from it, and cpr_tpu.envs.quorum's
  outputs on them (`quorum.check_plain`'s keys);
- `<env>_*`: 64 lanes x 256 steps of the auto-reset stream (max_steps
  200: the episodes wrap the ring and reset) under every scripted policy
  — per-lane episode sums, done counts and final observation — and the
  whole final carry of the benchmark's policy;
- `<env>_sl_*`: a 32-lane, 40-tick `step_lanes` trace under seeded
  actions, admit and step masks, with every output and the final carry.

`chip_smoke.py` holds K9 and the K10 kernels against it on a machine
without jax. Regenerating the streams takes minutes of JAX on the CPU, so
`python tests/test_torch_quorum_golden.py` rewrites the fixture; the
tests here recompute the K9 part from cpr_tpu, check the rest for
coverage, and replay the K9 inputs, the step_lanes traces and the
benchmark policies' streams through the port's plain versions.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_quorum_golden.npz")

LANES, STEPS, SEED, MAX_STEPS = 64, 256, 5, 200
K9_STEPS = 190
SL_LANES, SL_TICKS, SL_MAX_STEPS = 32, 40, 12
# env name: (registry key, kwargs, the benchmark's policy, K9's policy)
ENVS = {
    "ts": ("tailstorm-8-discount-heuristic", dict(window=128), "get-ahead",
           "avoid-loss"),
    "stree": ("stree-8-constant-heuristic", dict(window=128),
              "override-catchup", "avoid-loss"),
}
K9_INPUTS = ("cand", "own", "seen", "score", "stale", "pub", "priv")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def k9_cfg_array(cfg: dict) -> np.ndarray:
    from cpr_tpu_torch.kernels import _CHECK_CFG
    return np.array([cfg[f] for f in _CHECK_CFG], np.int32)


def k9_cfg(fx: dict, name: str) -> dict:
    from cpr_tpu_torch.kernels import _CHECK_CFG
    return {f: int(v) for f, v in zip(_CHECK_CFG, fx[f"k9_{name}_cfg"])}


def k9_reference(name: str, fx: dict) -> dict:
    """cpr_tpu's K9 outputs on the fixture's stored carry and inputs."""
    from cpr_tpu.envs import registry as jregistry
    from test_torch_dag_golden import fixture_state
    from test_torch_quorum import jax_check

    key, kw, _, _ = ENVS[name]
    jenv = jregistry.get(key, **kw)
    d = fixture_state(fx, f"k9_{name}_state_")["dag"]
    from cpr_tpu.core.dag import Dag
    jdag = Dag(**{f: (tuple(jnp.asarray(p) for p in v) if f == "parents"
                      else jnp.asarray(v)) for f, v in d.items()})
    inputs = {f: fx[f"k9_{name}_in_{f}"] for f in K9_INPUTS}
    return jax_check(jenv, jdag, inputs, k9_cfg(fx, name))


def build_golden() -> dict[str, np.ndarray]:
    """Every array of the fixture, computed by cpr_tpu on this host (the
    K9 inputs by the port's `check_inputs` on the converted carry)."""
    from cpr_tpu.envs import registry as jregistry
    from cpr_tpu.envs.base import INFO_KEYS
    from cpr_tpu.params import make_params
    from cpr_tpu_torch import convert
    from cpr_tpu_torch.envs import quorum as Q
    from cpr_tpu_torch.envs import registry as tregistry
    from test_torch_bk import jax_state_numpy, jax_streams
    from test_torch_dag_golden import state_arrays
    from test_torch_quorum import jax_carries, jax_check

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        out = {}
        for name, (key, kw, main, k9_policy) in ENVS.items():
            env = jregistry.get(key, **kw)
            tenv = tregistry.get(key, **kw)
            p = make_params(alpha=0.35, gamma=0.5, max_steps=MAX_STEPS)
            keys = jax.random.split(jax.random.PRNGKey(SEED), LANES)
            # K9: a wrapped carry, the port's selector inputs on it
            (jstate,) = jax_carries(env, p, keys, k9_policy, (K9_STEPS,))
            state = convert.dag_state_from_numpy(
                tenv, jax_state_numpy(jstate), device="cpu")
            inputs = {k: v.numpy() for k, v in
                      Q.check_inputs(tenv, state).items()}
            cfg = Q.check_cfg(tenv)
            out.update(state_arrays(f"k9_{name}_state_", jstate))
            out.update({f"k9_{name}_in_{f}": inputs[f] for f in K9_INPUTS})
            out[f"k9_{name}_cfg"] = k9_cfg_array(cfg)
            for k, v in jax_check(env, jstate.dag, inputs, cfg).items():
                out[f"k9_{name}_out_{k}"] = v

            out[f"{name}_keys"] = np.asarray(keys)
            run = jax_streams(env, p, keys, STEPS)
            for i, pol in enumerate(env.policies):
                (st, obs), sums, nd, _ = run(i)
                out[f"{name}_p{i}_sums"] = np.asarray(sums)
                out[f"{name}_p{i}_n_done"] = np.asarray(nd)
                out[f"{name}_p{i}_obs"] = np.asarray(obs)
                if pol == main:
                    out.update(state_arrays(f"{name}_final_", st))

            ps = make_params(alpha=0.35, gamma=0.5, max_steps=SL_MAX_STEPS)
            rng = np.random.default_rng(SEED)
            shape = (SL_TICKS, SL_LANES)
            acts = rng.integers(0, env.n_actions, shape).astype(np.int32)
            admit = rng.random(shape) < 0.1
            step = rng.random(shape) < 0.8
            ks = jax.random.split(jax.random.PRNGKey(6), SL_LANES)
            fk = jax.random.split(jax.random.PRNGKey(7), SL_LANES)
            out.update({f"{name}_sl_actions": acts, f"{name}_sl_admit": admit,
                        f"{name}_sl_step": step,
                        f"{name}_sl_keys": np.asarray(ks),
                        f"{name}_sl_fresh_keys": np.asarray(fk)})
            carry = env.init_lanes(ks, ps)
            fresh = env.init_lanes(fk, ps)
            trace = {k: [] for k in ("obs", "reward", "done", "info")}
            for t in range(SL_TICKS):
                carry, (o, r, d, info) = env.step_lanes(
                    carry, jnp.asarray(acts[t]), jnp.asarray(admit[t]), fresh,
                    jnp.asarray(step[t]), ps)
                trace["obs"].append(np.asarray(o))
                trace["reward"].append(np.asarray(r))
                trace["done"].append(np.asarray(d))
                trace["info"].append(np.stack([np.asarray(info[k])
                                               for k in INFO_KEYS]))
            for k, v in trace.items():
                out[f"{name}_sl_out_{k}"] = np.stack(v)
            out.update(state_arrays(f"{name}_sl_final_", carry[0]))
            out[f"{name}_sl_final_obs_carry"] = np.asarray(carry[1])
        return out
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(scope="module")
def committed():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_k9_part_matches_reference(committed, name):
    """cpr_tpu recomputes the committed K9 outputs from the stored carry
    and inputs."""
    want = k9_reference(name, committed)
    for k, v in want.items():
        g = committed[f"k9_{name}_out_{k}"]
        assert g.dtype == v.dtype and g.shape == v.shape, k
        np.testing.assert_array_equal(g, v, err_msg=k)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_fixture_exercises_wrap_reset_and_quorums(committed, name):
    fx = committed
    # the K9 carry and the main policy's episodes wrapped the 128-slot ring
    assert fx[f"k9_{name}_state_dag.gid"].max() >= 128
    assert fx[f"{name}_final_dag.gid"].max() >= 128
    n_pol = len([k for k in fx if k.startswith(f"{name}_p")
                 and k.endswith("_n_done")])
    assert n_pol == (7 if name == "ts" else 6)
    for i in range(n_pol):
        assert fx[f"{name}_p{i}_n_done"].min() >= 1, i
    # every selection met quorums, releases flipped heads, Adopts staled
    assert fx[f"k9_{name}_out_found"].sum(1).min() > 0
    assert fx[f"k9_{name}_out_rfound"].any()
    assert (fx[f"k9_{name}_out_stale"] != fx[f"k9_{name}_in_stale"]).any()
    assert fx[f"{name}_sl_out_done"].sum() > 0
    assert fx[f"{name}_sl_admit"].any()


@pytest.mark.parametrize("name", sorted(ENVS))
def test_port_replays_fixture(committed, name):
    """The port's plain versions reproduce the fixture's K9 outputs, its
    step_lanes trace and the benchmark policy's stream (the replays
    chip_smoke.py runs on the card)."""
    from cpr_tpu_torch import convert
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import quorum as Q
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.envs.base import EPISODE_KEYS, INFO_KEYS
    from cpr_tpu_torch.params import make_params
    from test_torch_bk import assert_state_numpy
    from test_torch_dag_golden import fixture_state

    fx = committed
    key, kw, main, _ = ENVS[name]
    env = registry.get(key, **kw)
    state = convert.dag_state_from_numpy(
        env, fixture_state(fx, f"k9_{name}_state_"), device="cpu")
    inputs = {f: torch.from_numpy(fx[f"k9_{name}_in_{f}"])
              for f in K9_INPUTS}
    got = Q.check_plain(state.dag, inputs, k9_cfg(fx, name))
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), fx[f"k9_{name}_out_{k}"],
                                      err_msg=k)

    ps = make_params(alpha=0.35, gamma=0.5, max_steps=SL_MAX_STEPS)
    carry = env.init_lanes(rnd.from_numpy_words(fx[f"{name}_sl_keys"],
                                                "cpu"), ps)
    fresh = env.init_lanes(rnd.from_numpy_words(fx[f"{name}_sl_fresh_keys"],
                                                "cpu"), ps)
    cvt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    for t in range(SL_TICKS):
        _, (o, r, d, info) = env.step_lanes(
            carry, cvt(fx[f"{name}_sl_actions"][t]),
            cvt(fx[f"{name}_sl_admit"][t]), fresh,
            cvt(fx[f"{name}_sl_step"][t]), ps)
        np.testing.assert_allclose(o.numpy(), fx[f"{name}_sl_out_obs"][t],
                                   atol=1e-6)
        np.testing.assert_array_equal(d.numpy(), fx[f"{name}_sl_out_done"][t])
        np.testing.assert_array_equal(r.numpy(),
                                      fx[f"{name}_sl_out_reward"][t])
        for i, k in enumerate(INFO_KEYS):
            if "time" not in k:
                np.testing.assert_array_equal(
                    info[k].numpy(), fx[f"{name}_sl_out_info"][t][i])
    want = convert.dag_state_from_numpy(
        env, fixture_state(fx, f"{name}_sl_final_"), device="cpu")
    assert_state_numpy(convert.dag_state_to_numpy(carry[0]),
                       convert.dag_state_to_numpy(want), name)
    np.testing.assert_allclose(carry[1].numpy(),
                               fx[f"{name}_sl_final_obs_carry"], atol=1e-6)

    # the benchmark's policy over the whole stream
    p = make_params(alpha=0.35, gamma=0.5, max_steps=MAX_STEPS)
    i = env.scripted_policies.index(main)
    carry, sums, nd, _ = env._stream(
        None, rnd.from_numpy_words(fx[f"{name}_keys"], "cpu"), 1, STEPS, p,
        main, True)
    np.testing.assert_array_equal(nd.numpy(), fx[f"{name}_p{i}_n_done"])
    ws = fx[f"{name}_p{i}_sums"]
    for j, k in enumerate(EPISODE_KEYS):
        if "time" in k:
            np.testing.assert_allclose(sums[j].numpy(), ws[j], rtol=1e-5)
        else:
            np.testing.assert_array_equal(sums[j].numpy(), ws[j], err_msg=k)
    want = convert.dag_state_from_numpy(
        env, fixture_state(fx, f"{name}_final_"), device="cpu")
    assert_state_numpy(convert.dag_state_to_numpy(carry[0]),
                       convert.dag_state_to_numpy(want), f"{name} {main}")


if __name__ == "__main__":
    import os
    import sys

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    arrays = build_golden()
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes, "
          f"{len(arrays)} arrays)")
