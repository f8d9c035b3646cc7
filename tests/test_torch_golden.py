"""The committed JAX golden fixture for the port's kernels.

`tests/fixtures/torch_port_golden.npz` holds outputs of `cpr_tpu` (JAX on
the CPU) for the three kernels of the port's first slice: K1 (threefry
keys and draws), K2 (per-lane episode stats, 4 policies) and K3 (a
64-lane `step_lanes` tick trace with its inputs). `chip_smoke.py` holds
the CUDA kernels against it on a machine without jax. This test
regenerates the fixture from `cpr_tpu` and checks it against the
committed file; `python tests/test_torch_golden.py` rewrites it.

Integer arrays must match exactly. Float arrays may differ in the last
bits where they come through log1p/atan, whose XLA:CPU code depends on
the host's instruction set: rtol 1e-5 (the parity contract's tolerance
for time fields) and atol 1e-6 (unit observations).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_port_golden.npz"

POLICIES = ("honest", "simple", "eyal-sirer-2014", "sapirshtein-2016-sm1")
K2_LANES, K2_STEPS, K2_MAX_STEPS, K2_SEED = 64, 300, 50, 5
K3_LANES, K3_TICKS, K3_MAX_STEPS = 64, 40, 16


def build_golden() -> dict[str, np.ndarray]:
    """Every array of the fixture, computed by cpr_tpu on this host."""
    from cpr_tpu.envs.base import INFO_KEYS
    from cpr_tpu.envs.nakamoto import NakamotoSSZ
    from cpr_tpu.params import make_params

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        out = {}
        k0 = jax.random.PRNGKey(0)
        out["k1_split"] = np.asarray(jax.random.split(k0, 4096))
        out["k1_fold_in"] = np.asarray(jax.random.fold_in(k0, 7))
        out["k1_uniform"] = np.asarray(
            jax.random.uniform(jax.random.PRNGKey(1), (300,)))
        out["k1_exponential"] = np.asarray(
            jax.random.exponential(jax.random.PRNGKey(2), (300,)))

        env = NakamotoSSZ()
        p2 = make_params(alpha=0.35, gamma=0.5, max_steps=K2_MAX_STEPS)
        keys = jax.random.split(jax.random.PRNGKey(K2_SEED), K2_LANES)
        out["k2_keys"] = np.asarray(keys)
        for i, name in enumerate(POLICIES):
            stats = env.make_episode_stats_fn(p2, env.policies[name],
                                              K2_STEPS)(keys)
            for k, v in stats.items():
                out[f"k2_p{i}_{k}"] = np.asarray(v)

        p3 = make_params(alpha=0.35, gamma=0.5, max_steps=K3_MAX_STEPS)
        rng = np.random.default_rng(0)
        shape = (K3_TICKS, K3_LANES)
        out["k3_actions"] = rng.integers(0, 4, shape).astype(np.int32)
        out["k3_admit"] = rng.random(shape) < 0.1
        out["k3_step"] = rng.random(shape) < 0.8
        out["k3_keys"] = np.asarray(
            jax.random.split(jax.random.PRNGKey(6), K3_LANES))
        out["k3_fresh_keys"] = np.asarray(
            jax.random.split(jax.random.PRNGKey(7), K3_LANES))
        carry = env.init_lanes(jnp.asarray(out["k3_keys"]), p3)
        fresh = env.init_lanes(jnp.asarray(out["k3_fresh_keys"]), p3)
        trace = {k: [] for k in ("obs", "reward", "done", "info")}
        for t in range(K3_TICKS):
            carry, (obs, reward, done, info) = env.step_lanes(
                carry, jnp.asarray(out["k3_actions"][t]),
                jnp.asarray(out["k3_admit"][t]), fresh,
                jnp.asarray(out["k3_step"][t]), p3)
            trace["obs"].append(np.asarray(obs))
            trace["reward"].append(np.asarray(reward))
            trace["done"].append(np.asarray(done))
            trace["info"].append(np.stack([np.asarray(info[k])
                                           for k in INFO_KEYS]))
        for k, v in trace.items():
            out[f"k3_out_{k}"] = np.stack(v)
        state, obs = carry
        for f in state.__dataclass_fields__:
            out[f"k3_final_{f}"] = np.asarray(getattr(state, f))
        out["k3_final_obs"] = np.asarray(obs)
        return out
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def assert_golden_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def golden():
    return build_golden()


def test_fixture_matches_reference(golden):
    with np.load(FIXTURE) as f:
        committed = {k: f[k] for k in f.files}
    assert_golden_equal(golden, committed)


def test_fixture_exercises_auto_reset(golden):
    # the K2 and K3 cases must cross episode boundaries to test the reset
    assert golden["k2_p3_n_episodes"].min() >= 2
    assert golden["k3_out_done"].sum() > 0
    assert golden["k3_admit"].any() and (~golden["k3_step"]).any()


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    arrays = build_golden()
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes, "
          f"{len(arrays)} arrays)")
