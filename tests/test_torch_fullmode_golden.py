"""The committed JAX golden fixture for full mode of the DAG kernels
(K8-full, K9-full, K10-<env>-full), the reference's default sizing.

`tests/fixtures/torch_port_fullmode_golden.npz` holds outputs of `cpr_tpu`
(JAX on the CPU), every env in full mode (no window) as
`registry.get_sized(key, 128)` sizes it:
- `k8full_*`, `k8lift_*`: a script of `core.dag.make_script` over the
  full-mode ops `FULL_OPS` (64 lanes, 240 ops, 160 slots, 3 parent slots;
  the lifted one with heights one above parent 0; the capacity holds
  every append, as a full-mode script must: a DAG that fills up pins its
  appends to the last slot, where the reference's walks can cycle), with
  every result, the registers and the final DAG;
- `k9_<env>_*` (Tailstorm, Stree): 64 lanes of the auto-reset stream
  carry after 120 steps at max_steps 200 (K9's frames without planes,
  the walk of the withheld set), the selector inputs the port's
  `quorum.check_inputs` draws from it and cpr_tpu.envs.quorum's outputs
  on them (`quorum.check_plain`'s keys);
- `<env>_*` for Bₖ, Ethereum (lifted), Tailstorm, Stree, Spar, Sdag and
  TailstormJune (`block`): 64 lanes x 256 steps of the auto-reset stream
  at max_steps 128 under every scripted policy (per-lane episode sums,
  done counts and final observation) and the whole final carry of the
  main policy;
- `<env>_sl_*`: a 16-lane, 24-tick `step_lanes` trace under seeded
  actions, admit and step masks, with every output and the final carry.

`chip_smoke.py` holds the full-mode kernels against it on a machine
without jax. Regenerating it takes minutes of JAX on the CPU, so
`PYTHONPATH=. python tests/test_torch_fullmode_golden.py` rewrites the
fixture and is the only writer; the tests here recompute the K8 scripts
from cpr_tpu, check the rest for coverage, and replay the fixture through
the port's plain full mode: K8 and K9 whole, the step_lanes traces whole,
and the main policy's stream on the first `REPLAY_LANES` lanes (a lane's
stream depends on its own key only). Integers and done flags must match
bit for bit, floats as in tests/test_torch_golden.py (rtol 1e-5, atol
1e-6; the clocks of the carry to rtol 1e-5).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_fullmode_golden.npz")

K8_LANES, K8_OPS, K8_CAP, K8_PARENTS = 64, 240, 160, 3
K8_SEEDS = {"k8full": (17, False), "k8lift": (19, True)}
LANES, STEPS, SEED, MAX_STEPS, HINT = 64, 256, 5, 128, 128
K9_STEPS, K9_MAX_STEPS = 120, 200
SL_LANES, SL_TICKS, SL_MAX_STEPS = 16, 24, 12
REPLAY_LANES = 8
# env name: (registry key, the main policy)
ENVS = {
    "bk": ("bk-8-constant", "get-ahead"),
    "eth": ("ethereum-byzantium", "fn19"),
    "ts": ("tailstorm-8-discount-heuristic", "get-ahead"),
    "stree": ("stree-8-constant-heuristic", "override-catchup"),
    "spar": ("spar-8-constant", "selfish"),
    "sdag": ("sdag-8-discount-heuristic", "override-catchup"),
    "june": ("tailstormjune-8-block", "override-catchup"),
}
K9_ENVS = {"ts": "avoid-loss", "stree": "avoid-loss"}
K9_INPUTS = ("cand", "own", "seen", "score", "stale", "pub", "priv")
CONFIGS = Path(__file__).resolve().parent.parent / "cpr_tpu" / "train" \
    / "configs"
DAG_YAMLS = sorted(p.name for p in CONFIGS.glob("*.yaml")
                   if not p.name.startswith(("nakamoto", "dummy")))


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


def k8_script(prefix: str):
    from cpr_tpu_torch.core import dag as D
    seed, lift = K8_SEEDS[prefix]
    return D.make_script(seed, K8_LANES, K8_OPS, K8_PARENTS, ops=D.FULL_OPS,
                         lift=lift)


def k8_reference(prefix: str) -> dict:
    """cpr_tpu.core.dag's run of the full-mode script `prefix`."""
    from cpr_tpu_torch.core import dag as D
    from test_torch_dag import jax_script
    _, lift = K8_SEEDS[prefix]
    ops, args, fargs = k8_script(prefix)
    dag, regs, res = jax_script(K8_CAP, False, False, lift, D.FULL_OPS, ops,
                                args, fargs)
    out = {f"{prefix}_ops": ops, f"{prefix}_args": args,
           f"{prefix}_fargs": fargs, f"{prefix}_out": np.asarray(res),
           f"{prefix}_regs": np.asarray(regs)}
    for g in dag.__dataclass_fields__:
        x = getattr(dag, g)
        out[f"{prefix}_dag.{g}"] = (np.stack([np.asarray(p) for p in x])
                                    if g == "parents" else np.asarray(x))
    return out


def sized(registry, key: str):
    return registry.get_sized(key, HINT)


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
    from test_torch_quorum_golden import k9_cfg_array

    out = {}
    for prefix in K8_SEEDS:
        out.update(k8_reference(prefix))
    for name, k9_policy in K9_ENVS.items():
        key = ENVS[name][0]
        env, tenv = sized(jregistry, key), sized(tregistry, key)
        p = make_params(alpha=0.35, gamma=0.5, max_steps=K9_MAX_STEPS)
        keys = jax.random.split(jax.random.PRNGKey(SEED), LANES)
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
    for name, (key, main) in ENVS.items():
        env = sized(jregistry, key)
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


@pytest.fixture(scope="module")
def committed():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("prefix", sorted(K8_SEEDS))
def test_k8_part_matches_reference(committed, prefix):
    from test_torch_dag_golden import assert_golden_equal
    want = {k: v for k, v in committed.items() if k.startswith(prefix + "_")}
    assert_golden_equal(k8_reference(prefix), want)


def test_fixture_exercises_walks_resets_and_quorums(committed):
    fx = committed
    for prefix in K8_SEEDS:
        assert not fx[f"{prefix}_dag.overflow"].any()
        assert fx[f"{prefix}_dag.n"].min() > K8_OPS // 4
    assert (fx["k8lift_dag.anc4"] >= 0).any()
    for name in K9_ENVS:
        assert fx[f"k9_{name}_out_found"].any()
        assert (fx[f"k9_{name}_out_cvalid"].sum(1) >= 8).any()
        assert fx[f"k9_{name}_out_rfound"].any()
    for name, (key, _) in ENVS.items():
        n_pol = sum(1 for k in fx if k.startswith(f"{name}_p")
                    and k.endswith("_n_done"))
        assert n_pol >= 2, name
        assert fx[f"{name}_p0_n_done"].min() >= 1, name
        # the reference's sizing: no episode filled its capacity
        assert not fx[f"{name}_final_dag.overflow"].any(), name
        assert fx[f"{name}_final_dag.gid"].shape[-1] == 0, name
        assert fx[f"{name}_sl_out_done"].any(), name
    # Ethereum's chains are deep enough for the longest jump
    assert (fx["eth_final_dag.anc16"] >= 0).any()


def _replay_stream(fx, name):
    from cpr_tpu_torch import convert
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.envs.base import EPISODE_KEYS, map_state
    from cpr_tpu_torch.params import make_params
    from test_torch_bk import assert_state_numpy
    from test_torch_dag_golden import fixture_state

    key, main = ENVS[name]
    env = sized(registry, key)
    assert not env.ring
    assert env.capacity == fx[f"{name}_final_dag.height"].shape[-1]
    i = env.scripted_policies.index(main)
    n = REPLAY_LANES
    keys = rnd.from_numpy_words(fx[f"{name}_keys"][:n], "cpu")
    p = make_params(alpha=0.35, gamma=0.5, max_steps=MAX_STEPS)
    carry, sums, nd, _ = env._stream(None, keys, 1, STEPS, p,
                                     env.policies[main], True)
    np.testing.assert_array_equal(nd.numpy(), fx[f"{name}_p{i}_n_done"][:n])
    ws = fx[f"{name}_p{i}_sums"][:, :n]
    for j, k in enumerate(EPISODE_KEYS):
        if "time" in k:
            np.testing.assert_allclose(sums[j].numpy(), ws[j], rtol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(sums[j].numpy(), ws[j], err_msg=k)
    np.testing.assert_allclose(carry[1].numpy(), fx[f"{name}_p{i}_obs"][:n],
                               atol=1e-6)
    want = convert.dag_state_from_numpy(
        env, fixture_state(fx, f"{name}_final_"), device="cpu")
    want = map_state(lambda t: t[:n], want)
    assert_state_numpy(convert.dag_state_to_numpy(carry[0]),
                       convert.dag_state_to_numpy(want), name)


def _replay_lanes(fx, name):
    from cpr_tpu_torch import convert
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.envs.base import INFO_KEYS
    from cpr_tpu_torch.params import make_params
    from test_torch_bk import assert_state_numpy
    from test_torch_dag_golden import fixture_state

    env = sized(registry, ENVS[name][0])
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
            got, want = info[k].numpy(), fx[f"{name}_sl_out_info"][t][i]
            if "time" in k:
                np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)
    want = convert.dag_state_from_numpy(
        env, fixture_state(fx, f"{name}_sl_final_"), device="cpu")
    assert_state_numpy(convert.dag_state_to_numpy(carry[0]),
                       convert.dag_state_to_numpy(want), name)
    np.testing.assert_allclose(carry[1].numpy(),
                               fx[f"{name}_sl_final_obs_carry"], atol=1e-6)


@pytest.mark.parametrize("name", sorted(ENVS))
def test_port_replays_fixture(committed, name):
    """The port's plain full mode reproduces the fixture's step_lanes
    trace and the main policy's stream on the first lanes (the replays
    chip_smoke.py runs through the kernels on the card)."""
    _replay_lanes(committed, name)
    _replay_stream(committed, name)


def test_port_replays_k8_and_k9(committed):
    """`script_plain` on the full-mode scripts and `check_plain` on the
    full-mode carries reproduce cpr_tpu's outputs."""
    from cpr_tpu_torch import convert
    from cpr_tpu_torch.core import dag as D
    from cpr_tpu_torch.envs import quorum as Q
    from cpr_tpu_torch.envs import registry
    from test_torch_dag_golden import fixture_state
    from test_torch_quorum_golden import k9_cfg

    fx = committed
    for prefix, (_, lift) in K8_SEEDS.items():
        dag, regs, out = D.script_plain(
            D.empty(K8_LANES, K8_CAP, K8_PARENTS, lift=lift),
            fx[f"{prefix}_ops"], torch.from_numpy(fx[f"{prefix}_args"]),
            torch.from_numpy(fx[f"{prefix}_fargs"]))
        np.testing.assert_array_equal(out.numpy(), fx[f"{prefix}_out"])
        np.testing.assert_array_equal(regs.numpy(), fx[f"{prefix}_regs"])
        np.testing.assert_array_equal(torch.stack(dag.parents).numpy(),
                                      fx[f"{prefix}_dag.parents"])
        for g in D.FIELDS[1:]:
            np.testing.assert_array_equal(getattr(dag, g).numpy(),
                                          fx[f"{prefix}_dag.{g}"], err_msg=g)
    for name in K9_ENVS:
        env = sized(registry, ENVS[name][0])
        state = convert.dag_state_from_numpy(
            env, fixture_state(fx, f"k9_{name}_state_"), device="cpu")
        inputs = {f: torch.from_numpy(fx[f"k9_{name}_in_{f}"])
                  for f in K9_INPUTS}
        got = Q.check_plain(state.dag, inputs, k9_cfg(fx, name))
        for k, v in got.items():
            np.testing.assert_array_equal(
                v.numpy(), fx[f"k9_{name}_out_{k}"], err_msg=k)


@pytest.mark.parametrize("yaml_name", DAG_YAMLS)
def test_build_env_sizes_shipped_yamls_as_reference(yaml_name):
    """Every shipped DAG training yaml: `build_env` gives the reference's
    capacity and DAG mode (full, lifted as the reference lifts) on the
    CPU and on the card alike; the kernels take it up to their largest
    full-mode bucket and name item 8c beyond it."""
    from cpr_tpu.train import config as jconfig
    from cpr_tpu.train import driver as jdriver
    from cpr_tpu_torch import kernels
    from cpr_tpu_torch.train import config as tconfig
    from cpr_tpu_torch.train import driver as tdriver

    from cpr_tpu.params import make_params

    path = str(CONFIGS / yaml_name)
    jenv = jdriver.build_env(jconfig.TrainConfig.from_yaml(path))
    jenv = getattr(jenv, "inner", jenv)
    # the reference's DAG as its reset builds it (shapes only)
    jdag = jax.eval_shape(lambda k: jenv.reset(k, make_params(
        alpha=0.3, gamma=0.5, max_steps=128)), jax.random.PRNGKey(0))[0].dag
    want = (jdag.parents[0].shape[-1], jdag.gid.shape[-1] > 0,
            jdag.chain.shape[-1] > 0, jdag.anc2.shape[-1] > 0)
    assert want[0] == jenv.capacity
    cfg = tconfig.TrainConfig.from_yaml(path)
    for device in ("cpu", "cuda"):
        env = tdriver.build_env(cfg, device)
        env = getattr(env, "inner", env)
        assert (env.capacity, env.ring, env.anc_masks, env.lift) == want, \
            device
        assert not env.ring
        if env.capacity <= kernels._MAX_FULL:
            env._check_kernel()
        else:
            with pytest.raises(NotImplementedError,
                               match="full mode .* item 8c"):
                env._check_kernel()


def test_check_dag_modes_buckets():
    """Full mode, lifted or not, up to the largest bucket (544 slots);
    beyond it the check raises naming item 8c, as it does for rings past
    128 slots and for full mode with ancestry planes."""
    from cpr_tpu_torch import kernels
    full = kernels._MAX_FULL
    assert full == 544 and full >= 2 * 256 + 8
    for ring, masks, lifted, W, mode in ((True, True, False, 128, "ring"),
                                         (False, False, False, full, "full"),
                                         (False, False, True, full, "lift"),
                                         (False, False, False, 1, "full")):
        assert kernels.check_dag_modes("x", W, 17, ring, masks,
                                       lifted) == mode
    for ring, masks, lifted, W, P in ((True, True, False, 129, 3),
                                      (False, False, False, full + 1, 3),
                                      (False, False, True, full + 1, 3),
                                      (False, False, False, full, 18),
                                      (False, True, False, 64, 3),
                                      (True, True, True, 64, 3)):
        with pytest.raises(NotImplementedError, match="item 8c"):
            kernels.check_dag_modes("x", W, P, ring, masks, lifted)


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
