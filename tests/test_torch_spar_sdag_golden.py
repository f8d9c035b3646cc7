"""The committed JAX golden fixture for K10-spar and K10-sdag.

`tests/fixtures/torch_port_spar_sdag_golden.npz` holds outputs of
`cpr_tpu` (JAX on the CPU), for Spar (`spar`: k = 8, constant) and Sdag
(`sdag`: k = 8, discount, heuristic), both at window 128:
- `<env>_*`: 64 lanes x 256 steps of the auto-reset stream (max_steps
  200: the episodes wrap the ring and reset) under every scripted policy
  — per-lane episode sums, done counts and final observation — and the
  whole final carry of the benchmark's policy;
- `<env>_sl_*`: a 32-lane, 40-tick `step_lanes` trace under seeded
  actions, admit and step masks, with every output and the final carry;
- `<env>_ref_revenue`: the relative revenue of the benchmark's policy on
  the keys of split(PRNGKey(0), 64) over 256 steps at max_steps 120
  (alpha 0.35, gamma 0.5): the first 64 lanes of chip_smoke.py's path,
  whose revenue guard it centres.

`chip_smoke.py` holds the kernels against it on a machine without jax.
Regenerating it takes minutes of JAX on the CPU, so `python
tests/test_torch_spar_sdag_golden.py` rewrites the fixture (XLA at the
optimization level tests/conftest.py sets); the tests here check it for
coverage and replay the step_lanes traces, the benchmark policies'
streams and the reference revenues through the port's plain versions.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_spar_sdag_golden.npz")

LANES, STEPS, SEED, MAX_STEPS = 64, 256, 5, 200
SL_LANES, SL_TICKS, SL_MAX_STEPS = 32, 40, 12
REF_LANES, REF_STEPS, REF_MAX_STEPS = 64, 256, 120
# env name: (registry key, kwargs, the benchmark's policy)
ENVS = {
    "spar": ("spar-8-constant", dict(window=128), "selfish"),
    "sdag": ("sdag-8-discount-heuristic", dict(window=128),
             "override-catchup"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def relative_revenue(sums, n_done) -> float:
    """chip_smoke.py's revenue: the per-lane episode means (float32), the
    attacker's lane mean over the sum of both."""
    nd = np.maximum(np.asarray(n_done), 1).astype(np.float32)
    a = (np.asarray(sums[0], np.float32) / nd).mean(dtype=np.float64)
    d = (np.asarray(sums[1], np.float32) / nd).mean(dtype=np.float64)
    return float(a / (a + d))


def build_golden() -> dict[str, np.ndarray]:
    """Every array of the fixture, computed by cpr_tpu on this host."""
    from cpr_tpu.envs import registry as jregistry
    from cpr_tpu.envs.base import INFO_KEYS
    from cpr_tpu.params import make_params
    from test_torch_bk import jax_streams
    from test_torch_dag_golden import state_arrays

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        out = {}
        for name, (key, kw, main) in ENVS.items():
            env = jregistry.get(key, **kw)
            p = make_params(alpha=0.35, gamma=0.5, max_steps=MAX_STEPS)
            keys = jax.random.split(jax.random.PRNGKey(SEED), LANES)
            out[f"{name}_keys"] = np.asarray(keys)
            run = jax_streams(env, p, keys, STEPS)
            for i, pol in enumerate(env.policies):
                (st, obs), sums, nd, _ = run(i)
                out[f"{name}_p{i}_sums"] = np.asarray(sums)
                out[f"{name}_p{i}_n_done"] = np.asarray(nd)
                out[f"{name}_p{i}_obs"] = np.asarray(obs)
                if pol == main:
                    out.update(state_arrays(f"{name}_final_", st))

            pr = make_params(alpha=0.35, gamma=0.5, max_steps=REF_MAX_STEPS)
            rk = jax.random.split(jax.random.PRNGKey(0), REF_LANES)
            _, sums, nd, _ = jax_streams(env, pr, rk, REF_STEPS)(
                list(env.policies).index(main))
            out[f"{name}_ref_revenue"] = np.float64(relative_revenue(sums,
                                                                     nd))

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
def test_fixture_exercises_wrap_reset_and_releases(committed, name):
    fx = committed
    # the benchmark policy's episodes wrapped the 128-slot ring
    assert fx[f"{name}_final_dag.gid"].max() >= 128
    n_pol = len([k for k in fx if k.startswith(f"{name}_p")
                 and k.endswith("_n_done")])
    assert n_pol == (2 if name == "spar" else 6)
    for i in range(n_pol):
        assert fx[f"{name}_p{i}_n_done"].min() >= 1, i
    assert fx[f"{name}_sl_out_done"].sum() > 0
    assert fx[f"{name}_sl_admit"].any()
    # released withheld blocks and votes reached the defender
    vis = fx[f"{name}_final_dag.vis_d"] & (fx[f"{name}_final_dag.miner"] == 0)
    assert vis.any()
    assert 0.0 < float(fx[f"{name}_ref_revenue"]) < 1.0
    if name == "sdag":  # the discount scheme's fractional rewards
        r = fx["sdag_sl_out_info"][:, 1]
        assert (r != np.round(r)).any()


@pytest.mark.parametrize("name", sorted(ENVS))
def test_port_replays_fixture(committed, name):
    """The port's plain versions reproduce the fixture's step_lanes trace,
    the benchmark policy's stream and its reference revenue (the replays
    chip_smoke.py runs on the card)."""
    from cpr_tpu_torch import convert
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.envs.base import EPISODE_KEYS, INFO_KEYS
    from cpr_tpu_torch.params import make_params
    from test_torch_bk import assert_state_numpy
    from test_torch_dag_golden import fixture_state

    fx = committed
    key, kw, main = ENVS[name]
    env = registry.get(key, **kw)
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

    # the reference revenue of chip_smoke.py's path
    pr = make_params(alpha=0.35, gamma=0.5, max_steps=REF_MAX_STEPS)
    rk = rnd.split(rnd.PRNGKey(0, device="cpu"), REF_LANES)
    _, sums, nd, _ = env._stream(None, rk, 1, REF_STEPS, pr, main, True)
    got = relative_revenue(sums.numpy(), nd.numpy())
    print(f"{name} reference revenue {got} (fixture "
          f"{float(fx[f'{name}_ref_revenue'])})")
    assert abs(got - float(fx[f"{name}_ref_revenue"])) <= 1e-6


if __name__ == "__main__":
    import os
    import sys

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # the XLA:CPU settings of tests/conftest.py
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_backend_optimization_level=0")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    arrays = build_golden()
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes, "
          f"{len(arrays)} arrays)")
