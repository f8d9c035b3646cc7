"""Port parity of the Spar env (`cpr_tpu_torch.envs.spar`, the plain twin
of K10-spar) against cpr_tpu on the CPU, with the tolerances and helpers
of tests/test_torch_bk.py: every carry field bit-identical (stale ring
rows included), clocks to rtol 1e-5, unit observations to atol 1e-6,
rewards exact. The grid covers k = 4 and k = 8 under both incentive
schemes, in ring mode (window 128, a 24-slot ring that wraps, and the
48-slot ring of tests/test_dag_ring.py that wraps every episode) and in
full mode, under both scripted policies; the release's
proposal fast path and its release-every-vote fallback are reached under
seeded random actions and counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.envs.spar import SparSSZ as JEnv
from cpr_tpu.params import make_params as jmake
from cpr_tpu_torch import convert
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.envs.spar import SparSSZ as TEnv
from cpr_tpu_torch.params import make_params as tmake
from test_torch_bk import (assert_info, assert_obs, assert_state,
                           assert_stats_drivers, assert_stream,
                           jax_state_numpy, jax_streams, keys, params,
                           step_lanes_trace)

LANES, STEPS, MAX_STEPS = 12, 80, 36
CONFIGS = {
    "ring128-k8-constant": dict(k=8, window=128),
    "ring128-k8-block": dict(k=8, incentive_scheme="block", window=128),
    "ring24-k4-constant": dict(k=4, window=24),
    "full-k4-block": dict(k=4, incentive_scheme="block", max_steps_hint=40),
}
STATS_POLICIES = {"ring128-k8-constant": ("selfish",),
                  "full-k4-block": ("honest",)}
POLICIES = ("honest", "selfish")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain twins run thousands of tiny ops a step: one thread each
    keeps parallel test workers (pytest-xdist) from oversubscribing the
    cores (restored after the module)."""
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


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def streams(request):
    kw = CONFIGS[request.param]
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=MAX_STEPS)
    jk, tk = keys(3, LANES)
    run = jax_streams(jenv, jp, jk, STEPS)
    want = {name: run(i) for i, name in enumerate(tenv.scripted_policies)}
    return request.param, jenv, tenv, tp, tk, want


@pytest.mark.parametrize("policy", POLICIES)
def test_streams_every_policy(streams, policy):
    name, jenv, tenv, tp, tk, want = streams
    assert tenv.capacity == jenv.capacity and tenv.ring == jenv.ring
    nd = assert_stream(tenv, tp, tk, want[policy], policy, STEPS,
                       f"{name} {policy}")
    assert int(nd.min()) >= 2  # the logical reset fired on every lane
    if policy in STATS_POLICIES.get(name, ()):
        assert_stats_drivers(tenv, tp, tk, want[policy],
                             tenv.policies[policy], STEPS, 33)
    if name == "ring24-k4-constant":
        # the episodes outgrew the 24-slot window: the ring wrapped
        assert int(np.asarray(want[policy][0][0].dag.gid).max()) >= 24


def test_wrapping_ring_equals_full_mode():
    """tests/test_dag_ring.py's case: a 48-slot ring at k = 4 wraps every
    96-step episode and replays full mode bit for bit, in the port as in
    cpr_tpu; the port's ring against cpr_tpu's."""
    jp, tp = (jmake(alpha=0.3, gamma=0.5, max_steps=96),
              tmake(alpha=0.3, gamma=0.5, max_steps=96))
    jk, tk = keys(4, 16)
    jring = JEnv(k=4, max_steps_hint=104, window=48)
    want = jax.jit(jax.vmap(lambda k: jring.episode_stats(
        k, jp, jring.policies["selfish"], 104)))(jk)
    full = TEnv(k=4, max_steps_hint=104)
    ring = TEnv(k=4, max_steps_hint=104, window=48)
    got = {}
    for env in (full, ring):
        got[env.ring] = env.make_episode_stats_fn(
            tp, env.policies["selfish"], 104)(tk)
    for key in sorted(want):
        np.testing.assert_array_equal(got[False][key].numpy(),
                                      got[True][key].numpy(), err_msg=key)
        if "time" in key:  # the clocks: log1p, rtol 1e-5
            np.testing.assert_allclose(got[True][key].numpy(),
                                       np.asarray(want[key]), rtol=1e-5,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[True][key].numpy(),
                                          np.asarray(want[key]), err_msg=key)
    assert int(np.asarray(want["n_episodes"]).min()) >= 1


@pytest.mark.parametrize("window", [48, None])
def test_step_lanes_and_mid_episode_convert(window):
    kw = dict(k=4, window=window, max_steps_hint=40)
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=12)
    assert step_lanes_trace(jenv, tenv, jp, tp, 7, 12, 30, convert_at=15) > 0


def test_release_fast_path_and_fallback_reached():
    """Seeded random actions through both packages' step_lanes at k = 4
    in a 48-slot ring: before every tick, count the stepped lanes whose
    Override or Match took the proposal fast path (a block child of the
    target block released instead of votes) and those that released
    every confirming vote (the request exceeds the votes there); both
    branches must be reached while the packages agree bit for bit."""
    kw = dict(k=4, window=48)
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=40)
    n, ticks = 32, 60
    jk, tk = keys(9, n)
    jcarry, tcarry = jenv.init_lanes(jk, jp), tenv.init_lanes(tk, tp)
    jf, tf = keys(10, n)
    jfresh, tfresh = jenv.init_lanes(jf, jp), tenv.init_lanes(tf, tp)
    none = np.zeros(n, bool)
    step = np.ones(n, bool)
    rng = np.random.default_rng(9)
    counts = {"fast_path": 0, "fallback": 0, "releases": 0}
    for t in range(ticks):
        a = rng.choice([1, 2, 5, 6, 7, 3, 0, 4], n,
                       p=[.15, .1, .15, .1, .2, .2, .05, .05]).astype(np.int32)
        ta = torch.from_numpy(a)
        rel = ((ta % 4) == 1) | ((ta % 4) == 2)
        _, _, use_prop, not_enough = tenv.release_plan(tcarry[0], ta)
        counts["releases"] += int(rel.sum())
        counts["fast_path"] += int((rel & use_prop).sum())
        counts["fallback"] += int((rel & not_enough).sum())
        jcarry, jout = jenv.step_lanes(jcarry, jnp.asarray(a),
                                       jnp.asarray(none), jfresh,
                                       jnp.asarray(step), jp)
        tcarry, tout = tenv.step_lanes(tcarry, ta, torch.from_numpy(none),
                                       tfresh, torch.from_numpy(step), tp)
        assert_state(tcarry[0], jcarry[0], f"tick {t}")
        assert_obs(tout[0], jout[0], f"tick {t}")
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        assert_info(tout[3], jout[3], f"tick {t}")
    print(f"spar release branches over {n} lanes x {ticks} ticks: {counts}")
    assert counts["fast_path"] > 0 and counts["fallback"] > 0


def test_convert_carries_a_jax_state():
    """convert.dag_state_from_numpy carries a mid-episode cpr_tpu Spar
    state across whole, and the port steps on from it as cpr_tpu does."""
    kw = dict(k=4, window=48)
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=30)
    jk, _ = keys(12, 8)
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    js = jenv.reset_lanes(jk, jp)[0]
    for t in range(20):
        js = jstep(js, jnp.full(8, 7 if t % 4 else 5, jnp.int32))[0]
    ts = convert.dag_state_from_numpy(tenv, jax_state_numpy(js),
                                      device="cpu")
    assert_state(ts, js, "converted")
    a = np.full(8, 6, np.int32)
    assert_state(tenv.step(ts, torch.from_numpy(a), tp)[0],
                 jstep(js, jnp.asarray(a))[0], "stepped")


def test_reset_rows_and_select_reset():
    jenv, tenv = JEnv(k=2, window=32), TEnv(k=2, window=32)
    jp, tp = params(max_steps=12)
    jk, tk = keys(10, 8)
    jf, tf = keys(11, 8)
    done = np.arange(8) % 3 == 0
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    js = jenv.reset_lanes(jk, jp)[0]
    ts = tenv.reset_lanes(tk, tp)[0]
    for t in range(10):
        a = np.full(8, 7 if t % 3 else 4, np.int32)
        js = jstep(js, jnp.asarray(a))[0]
        ts = tenv.step(ts, torch.from_numpy(a), tp)[0]
    want = jax.vmap(jenv.select_reset)(jnp.asarray(done),
                                       jenv.reset_lanes(jf, jp)[0], js)
    got = tenv.select_reset(torch.from_numpy(done),
                            tenv.reset_lanes(tf, tp)[0], ts)
    assert_state(got, want)
    assert tenv.reset_dag_rows == jenv.reset_dag_rows == 2


def test_policies_match_reference_on_observations():
    from cpr_tpu import obs as jobs
    for unit in (True, False):
        jenv, tenv = JEnv(k=4, unit_observation=unit), TEnv(
            k=4, unit_observation=unit)
        rng = np.random.default_rng(int(unit))
        n = 400
        ints = np.stack([rng.integers(0, 14, n), rng.integers(0, 14, n),
                         rng.integers(-14, 14, n), rng.integers(0, 9, n),
                         rng.integers(0, 9, n), rng.integers(0, 9, n),
                         rng.integers(0, 2, n)])
        obs = np.asarray(jobs.encode(jenv.fields, tuple(jnp.asarray(v)
                                                        for v in ints),
                                     unit))
        for name in tenv.scripted_policies:
            want = np.asarray(jax.vmap(jenv.policies[name])(obs))
            got = tenv.policies[name](torch.from_numpy(obs.copy()))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            pid = tenv.scripted_policy_id(name)
            t = [torch.from_numpy(v.astype(np.int32)) for v in ints]
            np.testing.assert_array_equal(
                tenv._policy_ints(pid, t[0], t[1]).numpy(), want)
    assert tuple(jenv.policies) == tenv.scripted_policies


def test_registry_keys():
    for key in ("spar-8-constant", "spar-4-block"):
        env, jenv = tregistry.get(key, window=128), jregistry.get(
            key, window=128)
        assert isinstance(env, TEnv)
        assert (env.k, env.incentive_scheme, env.capacity, env.max_parents) \
            == (jenv.k, jenv.incentive_scheme, jenv.capacity,
                jenv.max_parents)
        assert tregistry.describe(key) == jregistry.describe(key)
    sized = tregistry.get_sized("spar-4-constant", 104)
    assert sized.capacity == 112 and not sized.ring


def test_kernels_take_ring_windows_only():
    """Full mode (K10-spar-full) up to 544 slots and ring windows up to
    128 take the kernels; beyond them, and k + 8 > 16, the check raises
    on CUDA, naming what is queued, before any launch."""
    for env, match in ((TEnv(k=4), None),
                       (TEnv(k=4, max_steps_hint=600),
                        "at most 544 slots in full mode .* item 8c"),
                       (TEnv(k=4, window=256), "at most 128 slots"),
                       (TEnv(k=9, window=128), "k \\+ 8 <= 16 .* item 8c"),
                       (TEnv(k=8, window=128), None)):
        if match is None:
            env._check_kernel()
            continue
        with pytest.raises(NotImplementedError, match=match):
            env._empty_carry(4, "cpu")


def test_shipped_config_builds_and_trains():
    """The shipped spar-8.yaml: build_env sizes full mode as cpr_tpu does
    on the CPU and on the card (K10-spar-full takes it); a small
    run of its config trains on the CPU with finite metrics."""
    from pathlib import Path

    from cpr_tpu.train import config as jconfig
    from cpr_tpu.train import driver as jdriver
    from cpr_tpu_torch.train import config as tconfig
    from cpr_tpu_torch.train import driver as tdriver
    path = Path(jconfig.__file__).parent / "configs" / "spar-8.yaml"
    cfg = tconfig.TrainConfig.from_yaml(str(path))
    jenv = jdriver.build_env(jconfig.TrainConfig.from_yaml(str(path))).inner
    full, card = (tdriver.build_env(cfg, d).inner for d in ("cpu", "cuda"))
    assert isinstance(full, TEnv) and not full.ring
    assert full.capacity == jenv.capacity == 136
    assert not card.ring and card.capacity == full.capacity
    card._check_kernel()
    small = tconfig.TrainConfig.from_dict(dict(
        protocol=cfg.protocol, alpha=dict(min=0.15, max=0.45), gamma=0.5,
        episode_len=16, n_envs=8, reward=cfg.reward,
        ppo=dict(n_steps=8, n_minibatches=2, update_epochs=1, layer_size=8),
        eval=dict(freq=1, start_at_iteration=0, episodes_per_alpha=2)))
    _, history, rows = tdriver.train_from_config(small, n_updates=1,
                                                 device="cpu")
    assert len(history) == 1 and rows
    assert all(np.isfinite(v) for v in history[0].values()
               if isinstance(v, float))
