"""The committed JAX golden fixture for the DAG kernels (K8, K10-bk,
K10-eth).

`tests/fixtures/torch_port_dag_golden.npz` holds outputs of `cpr_tpu`
(JAX on the CPU):
- `k8_*`: a ring-window script of `core.dag.make_script` (64 lanes, 240
  ops, a 32-slot window that wraps and overflows) with every result, the
  registers and the final DAG; `k8q_*` the same for a second script that
  adds the vote-quorum envs' `last_by_age` and `descendants_mask`;
- `bk_*` (Bₖ k=8, constant, window 128, max_steps 200) and `eth_*`
  (Ethereum byzantium, window 128, max_steps 200): 64 lanes x 256 steps
  of the auto-reset stream under every scripted policy — per-lane episode
  sums, done counts and final observation, and the whole final carry of
  the benchmark's policy; the episodes wrap the 128-slot ring and reset;
- `*_sl_*`: a 32-lane, 40-tick `step_lanes` trace under seeded actions,
  admit and step masks, with every output and the final carry.

`chip_smoke.py` holds the CUDA kernels against it on a machine without
jax. This test regenerates the fixture from `cpr_tpu` and checks it
against the committed file (integers exactly, floats to rtol 1e-5 and
atol 1e-6, as tests/test_torch_golden.py), and replays the K8 script and
the step_lanes traces through the port's plain versions;
`python tests/test_torch_dag_golden.py` rewrites it.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_dag_golden.npz")

K8_LANES, K8_OPS, K8_WINDOW, K8_PARENTS, K8_SEED = 64, 240, 32, 3, 11
K8Q_SEED = 13  # the second script: the vote-quorum envs' queries
LANES, STEPS, SEED = 64, 256, 5
SL_LANES, SL_TICKS, SL_MAX_STEPS = 32, 40, 12
# env name: (registry key, kwargs, max_steps, the benchmark's policy)
ENVS = {
    "bk": ("bk-8-constant", dict(window=128), 200, "get-ahead"),
    "eth": ("ethereum-byzantium", dict(window=128), 200, "fn19"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain twins run thousands of tiny ops a step: one thread each
    keeps parallel test workers (pytest-xdist) from oversubscribing the
    cores (restored after the module)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def state_arrays(prefix: str, state) -> dict:
    """A cpr_tpu DAG env state as flat fixture entries: `<prefix>dag.<f>`
    (`parents` stacked [P, L, W]) and `<prefix><f>`."""
    out = {}
    for f in state.__dataclass_fields__:
        v = getattr(state, f)
        if f == "dag":
            for g in v.__dataclass_fields__:
                x = getattr(v, g)
                out[f"{prefix}dag.{g}"] = (np.stack([np.asarray(p) for p in x])
                                           if g == "parents" else np.asarray(x))
        else:
            out[f"{prefix}{f}"] = np.asarray(v)
    return out


def fixture_state(fx: dict, prefix: str) -> dict:
    """The fixture's entries under `prefix` in convert.dag_state_from_numpy's
    form (the inverse of state_arrays)."""
    d = {"dag": {}}
    for k, v in fx.items():
        if not k.startswith(prefix):
            continue
        f = k[len(prefix):]
        if f.startswith("dag."):
            g = f[4:]
            d["dag"][g] = list(v) if g == "parents" else v
        else:
            d[f] = v
    return d


def build_golden() -> dict[str, np.ndarray]:
    """Every array of the fixture, computed by cpr_tpu on this host."""
    from cpr_tpu.envs import registry as jregistry
    from cpr_tpu.envs.base import INFO_KEYS
    from cpr_tpu.params import make_params
    from cpr_tpu_torch.core import dag as D
    from test_torch_bk import jax_streams
    from test_torch_dag import jax_script

    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        out = {}
        ops, args, fargs = D.make_script(K8_SEED, K8_LANES, K8_OPS,
                                         K8_PARENTS)
        dag, regs, res = jax_script(K8_WINDOW, True, True, False,
                                    D.RING_OPS, ops, args, fargs)
        out.update(k8_ops=ops, k8_args=args, k8_fargs=fargs,
                   k8_out=np.asarray(res), k8_regs=np.asarray(regs))
        for g in dag.__dataclass_fields__:
            x = getattr(dag, g)
            out[f"k8_dag.{g}"] = (np.stack([np.asarray(p) for p in x])
                                  if g == "parents" else np.asarray(x))
        ops, args, fargs = D.make_script(K8Q_SEED, K8_LANES, K8_OPS,
                                         K8_PARENTS, ops=D.RING_OPS_Q)
        dag, regs, res = jax_script(K8_WINDOW, True, True, False,
                                    D.RING_OPS_Q, ops, args, fargs)
        out.update(k8q_ops=ops, k8q_args=args, k8q_fargs=fargs,
                   k8q_out=np.asarray(res), k8q_regs=np.asarray(regs))
        for g in dag.__dataclass_fields__:
            x = getattr(dag, g)
            out[f"k8q_dag.{g}"] = (np.stack([np.asarray(p) for p in x])
                                   if g == "parents" else np.asarray(x))

        for name, (key, kw, max_steps, main) in ENVS.items():
            env = jregistry.get(key, **kw)
            p = make_params(alpha=0.35, gamma=0.5, max_steps=max_steps)
            keys = jax.random.split(jax.random.PRNGKey(SEED), LANES)
            out[f"{name}_keys"] = np.asarray(keys)
            run = jax_streams(env, p, keys, STEPS)
            for i, pol in enumerate(env.policies):
                (state, obs), sums, nd, _ = run(i)
                out[f"{name}_p{i}_sums"] = np.asarray(sums)
                out[f"{name}_p{i}_n_done"] = np.asarray(nd)
                out[f"{name}_p{i}_obs"] = np.asarray(obs)
                if pol == main:
                    out.update(state_arrays(f"{name}_final_", state))

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
def committed():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_fixture_matches_reference(committed):
    assert_golden_equal(build_golden(), committed)


def test_fixture_exercises_wrap_reset_and_overflow(committed):
    fx = committed
    assert fx["k8_dag.overflow"].any() and fx["k8_dag.live_floor"].max() > 0
    # the second script ran both queries and found blocks with them
    from cpr_tpu_torch.core import dag as D
    for op in (D.OP_LAST_BY_AGE, D.OP_DESCENDANTS):
        res = fx["k8q_out"][fx["k8q_ops"] == op]
        assert len(res) and (res[..., 0] > 0).any(), op
    for name in ENVS:
        # the 128-slot ring wrapped within an episode, and lanes reset
        assert fx[f"{name}_final_dag.gid"].max() >= 128, name
        for i in range(len([k for k in fx if k.startswith(f"{name}_p")
                            and k.endswith("_n_done")])):
            assert fx[f"{name}_p{i}_n_done"].min() >= 1, (name, i)
        assert fx[f"{name}_sl_out_done"].sum() > 0
        assert fx[f"{name}_sl_admit"].any()


def test_port_replays_fixture(committed):
    """The port's plain versions reproduce the fixture's K8 script and
    step_lanes traces (the replays chip_smoke.py runs on the card)."""
    from cpr_tpu_torch import convert
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.core import dag as D
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.envs.base import INFO_KEYS
    from cpr_tpu_torch.params import make_params
    from test_torch_bk import assert_state_numpy

    fx = committed
    for s in ("k8", "k8q"):
        dag = D.empty(K8_LANES, K8_WINDOW, K8_PARENTS, ring=True,
                      anc_masks=True)
        dag, regs, out = D.dag_script(dag, fx[f"{s}_ops"],
                                      torch.from_numpy(fx[f"{s}_args"]),
                                      torch.from_numpy(fx[f"{s}_fargs"]))
        np.testing.assert_array_equal(out.numpy(), fx[f"{s}_out"])
        np.testing.assert_array_equal(regs.numpy(), fx[f"{s}_regs"])
        np.testing.assert_array_equal(torch.stack(dag.parents).numpy(),
                                      fx[f"{s}_dag.parents"])
        for f in D.FIELDS[1:]:
            np.testing.assert_array_equal(getattr(dag, f).numpy(),
                                          fx[f"{s}_dag.{f}"], err_msg=f)

    for name, (key, kw, _, _) in ENVS.items():
        env = registry.get(key, **kw)
        ps = make_params(alpha=0.35, gamma=0.5, max_steps=SL_MAX_STEPS)
        carry = env.init_lanes(rnd.from_numpy_words(fx[f"{name}_sl_keys"],
                                                    "cpu"), ps)
        fresh = env.init_lanes(rnd.from_numpy_words(
            fx[f"{name}_sl_fresh_keys"], "cpu"), ps)
        for t in range(SL_TICKS):
            cvt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa
            _, (o, r, d, info) = env.step_lanes(
                carry, cvt(fx[f"{name}_sl_actions"][t]),
                cvt(fx[f"{name}_sl_admit"][t]), fresh,
                cvt(fx[f"{name}_sl_step"][t]), ps)
            np.testing.assert_allclose(o.numpy(), fx[f"{name}_sl_out_obs"][t],
                                       atol=1e-6)
            np.testing.assert_array_equal(d.numpy(),
                                          fx[f"{name}_sl_out_done"][t])
            np.testing.assert_array_equal(r.numpy(),
                                          fx[f"{name}_sl_out_reward"][t])
            for i, k in enumerate(INFO_KEYS):
                if "time" not in k:
                    np.testing.assert_array_equal(
                        info[k].numpy(), fx[f"{name}_sl_out_info"][t][i])
        # through convert and back, as chip_smoke.py loads it
        want = convert.dag_state_from_numpy(
            env, fixture_state(fx, f"{name}_sl_final_"), device="cpu")
        assert_state_numpy(convert.dag_state_to_numpy(carry[0]),
                           convert.dag_state_to_numpy(want), name)
        np.testing.assert_allclose(carry[1].numpy(),
                                   fx[f"{name}_sl_final_obs_carry"],
                                   atol=1e-6)


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
