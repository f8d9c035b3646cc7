"""Port parity of the Stree env (`cpr_tpu_torch.envs.stree`, the plain
twin of K10-stree) and of TailstormJune over it against cpr_tpu on the
CPU, with the tolerances and helpers of tests/test_torch_bk.py: every
carry field bit-identical (stale ring rows and the `stale` plane
included), clocks to rtol 1e-5, unit observations to atol 1e-6, rewards
exact. The grid covers every incentive scheme and every sub-block
selection, in ring mode (wrapping) and in full mode; TailstormJune runs
in full mode only (the reference gives it no window), in all five
schemes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.envs.stree import StreeSSZ as JEnv
from cpr_tpu.envs.tailstorm_june import TailstormJuneSSZ as JJune
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.envs.stree import StreeSSZ as TEnv
from cpr_tpu_torch.envs.tailstorm_june import TailstormJuneSSZ as TJune
from test_torch_bk import (assert_state, assert_stats_drivers, assert_stream,
                           jax_streams, keys, params, step_lanes_trace)

LANES, STEPS, MAX_STEPS = 12, 80, 36
CONFIGS = {
    "ring128-k8-constant-heuristic": dict(k=8, window=128),
    # a release scan of 8 positions (the release-everything branch)
    "ring24-k2-discount-heuristic-r8": dict(
        k=2, incentive_scheme="discount", window=24, release_scan=8),
    "ring28-k3-hybrid-optimal": dict(k=3, incentive_scheme="hybrid",
                                     subblock_selection="optimal",
                                     window=28),
    "full-k4-punish-altruistic": dict(k=4, incentive_scheme="punish",
                                      subblock_selection="altruistic",
                                      max_steps_hint=40),
}
STATS_POLICIES = {"ring128-k8-constant-heuristic": ("override-catchup",),
                  "full-k4-punish-altruistic": ("avoid-loss",)}
POLICIES = ("honest", "release-block", "override-block", "override-catchup",
            "minor-delay", "avoid-loss")
JUNE_SCHEMES = ("block", "constant", "discount", "punish", "hybrid")


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
    nd = assert_stream(tenv, tp, tk, want[policy], policy, STEPS,
                       f"{name} {policy}")
    assert int(nd.min()) >= 2  # the logical reset fired on every lane
    if policy in STATS_POLICIES.get(name, ()):
        assert_stats_drivers(tenv, tp, tk, want[policy],
                             tenv.policies[policy], STEPS, 33)
    if policy == POLICIES[-1] and name == "ring24-k2-discount-heuristic-r8":
        # an episode outgrew the window, and Adopts left stale vertices
        finals = [w[0][0] for w in want.values()]
        assert max(int(np.asarray(s.dag.gid).max()) for s in finals) >= 24
        assert any(np.asarray(s.stale).any() for s in finals)


@pytest.mark.parametrize("scheme", JUNE_SCHEMES)
def test_tailstorm_june_every_scheme(scheme):
    """TailstormJune (full mode, heuristic selection) under two policies;
    the `block` scheme pays the summary's miner the whole k."""
    jenv = JJune(k=3, incentive_scheme=scheme, max_steps_hint=40)
    tenv = TJune(k=3, incentive_scheme=scheme, max_steps_hint=40)
    assert not tenv.ring and tenv.capacity == jenv.capacity
    jp, tp = params(max_steps=16)
    jk, tk = keys(5, 8)
    run = jax_streams(jenv, jp, jk, 40)
    for pid in (3, 5):  # override-catchup, avoid-loss
        name = tenv.scripted_policies[pid]
        nd = assert_stream(tenv, tp, tk, run(pid), name, 40,
                           f"june {scheme} {name}")
        assert int(nd.min()) >= 2


@pytest.mark.parametrize("window", [32, None])
def test_step_lanes_and_mid_episode_convert(window):
    kw = dict(k=3, window=window, max_steps_hint=40)
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=12)
    assert step_lanes_trace(jenv, tenv, jp, tp, 7, 12, 40, convert_at=15) > 0


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
                         rng.integers(0, 6, n), rng.integers(0, 3, n),
                         rng.integers(0, 6, n), rng.integers(0, 2, n)])
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
                tenv._policy_ints(pid, t[0], t[1], t[3], t[4], t[7]).numpy(),
                want)
    assert tuple(jenv.policies) == tenv.scripted_policies


def test_registry_keys():
    env = tregistry.get("stree-8-constant-heuristic", window=128)
    assert isinstance(env, TEnv) and env.k == 8 and env.q == 7 and env.ring
    june = tregistry.get("tailstormjune-8-block")
    assert isinstance(june, TJune) and june.incentive_scheme == "block"
    assert not june.ring
    opt = tregistry.get("stree-3-discount-optimal")
    jopt = jregistry.get("stree-3-discount-optimal")
    assert opt.opt_window == jopt.opt_window
    np.testing.assert_array_equal(opt.opt_combos, jopt.opt_combos)
    for key in ("stree-8-constant-heuristic", "tailstormjune-8-block"):
        assert tregistry.describe(key) == jregistry.describe(key)
    # every family of the JAX registry resolves in the port
    from cpr_tpu_torch.envs.sdag import SdagSSZ
    from cpr_tpu_torch.envs.spar import SparSSZ
    for key, cls in (("spar-8-constant", SparSSZ),
                     ("sdag-8-constant-heuristic", SdagSSZ)):
        env, jenv = tregistry.get(key), jregistry.get(key)
        assert isinstance(env, cls)
        assert (env.k, env.capacity) == (jenv.k, jenv.capacity)
        assert env.scripted_policies == tuple(jenv.policies)


def test_kernels_take_ring_windows_only():
    """Full mode (TailstormJune always) and frames beyond 64 candidates
    raise on CUDA, naming what is queued, before any launch."""
    for env, match in ((TJune(k=3), "full mode .* item 8c"),
                       (TEnv(k=3), "full mode .* item 8c"),
                       (TEnv(k=13, window=128), "candidate frames of at most"),
                       (TEnv(k=8, window=128), None)):
        if match is None:
            env._check_kernel()
            continue
        with pytest.raises(NotImplementedError, match=match):
            env._empty_carry(4, "cpu")
