"""Port parity of the Ethereum env (`cpr_tpu_torch.envs.ethereum`, the
plain twin of K10-eth) against cpr_tpu on the CPU, with the tolerances
and helpers of tests/test_torch_bk.py: every carry field bit-identical
(stale ring rows included), clocks to rtol 1e-5, unit observations to
atol 1e-6, the dyadic uncle and miner rewards exact."""

import jax
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.envs.ethereum import EthereumSSZ as JEnv
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.envs.ethereum import EthereumSSZ as TEnv
from test_torch_bk import (assert_stats_drivers, assert_stream, jax_streams,
                           keys, params, step_lanes_trace)

LANES, STEPS, MAX_STEPS = 16, 120, 30

# the benchmark's preset and ring (byzantium, window 128), the whitepaper
# preset (preference by work) on a 16-slot ring that wraps and overflows,
# and full mode (lifted walks, the release closure fixpoint)
CONFIGS = {
    "ring128-byzantium": ("byzantium", dict(window=128)),
    "ring16-whitepaper": ("whitepaper", dict(window=16)),
    "full-byzantium": ("byzantium", dict(max_steps_hint=64)),
}
STATS_POLICIES = {"ring128-byzantium": ("fn19",),
                  "full-byzantium": ("selfish_release",)}
POLICIES = ("honest", "selfish_release", "selfish_discard", "fn19",
            "fn19pkel")


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
    preset, kw = CONFIGS[request.param]
    jenv, tenv = JEnv(preset, **kw), TEnv(preset, **kw)
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
                             tenv.policies[policy], STEPS, 37)


@pytest.mark.parametrize("streams", ["ring16-whitepaper"], indirect=True)
def test_small_ring_wraps_and_overflows(streams):
    name, jenv, tenv, tp, tk, want = streams
    assert max(int(np.asarray(w[0][0].dag.gid).max())
               for w in want.values()) >= 16
    overflowed = 0
    for w in want.values():
        _, _, _, (_, _, _, done, info) = w
        ends = np.asarray(info["episode_n_steps"])
        overflowed += int((np.asarray(done) & (ends < MAX_STEPS)).sum())
    assert overflowed >= 2


@pytest.mark.parametrize("preset,window", [("byzantium", 128),
                                           ("whitepaper", None)])
def test_step_lanes_and_mid_episode_convert(preset, window):
    kw = dict(window=window, max_steps_hint=64)
    jenv, tenv = JEnv(preset, **kw), TEnv(preset, **kw)
    jp, tp = params(max_steps=12)
    assert step_lanes_trace(jenv, tenv, jp, tp, 8, 16, 50, convert_at=20) > 0


def test_policies_match_reference_on_observations():
    from cpr_tpu import obs as jobs
    import jax.numpy as jnp
    for preset, unit in (("byzantium", True), ("whitepaper", False)):
        jenv, tenv = JEnv(preset, unit_observation=unit), TEnv(
            preset, unit_observation=unit)
        rng = np.random.default_rng(int(unit))
        ints = np.stack([rng.integers(0, 6, 400) for _ in range(4)]
                        + [rng.integers(-5, 6, 400) for _ in range(2)]
                        + [rng.integers(0, 3, 400) for _ in range(3)]
                        + [rng.integers(0, 2, 400)])
        obs = np.asarray(jobs.encode(jenv.fields, tuple(jnp.asarray(v)
                                                        for v in ints),
                                     unit))
        for name in POLICIES:
            want = np.asarray(jax.vmap(jenv.policies[name])(obs))
            got = tenv.policies[name](torch.from_numpy(obs.copy()))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            t = [torch.from_numpy(v.astype(np.int32)) for v in ints]
            ids = tenv._policy_ints(tenv.scripted_policy_id(name), t[0], t[1],
                                    t[2], t[3], t[9])
            np.testing.assert_array_equal(ids.numpy(), want, err_msg=name)


def test_registry_keys_and_gym_core():
    import cpr_tpu.gym as jgym
    import cpr_tpu_torch.gym as tgym
    for key, preset in (("ethereum-byzantium", "byzantium"),
                        ("ethereum-whitepaper", "whitepaper"),
                        ("ethereum", "byzantium")):
        env = tregistry.get(key)
        assert isinstance(env, TEnv) and env.preset == preset, key
        assert tregistry.describe(key) == jregistry.describe(key)
    assert tregistry.get_sized("ethereum-byzantium", 100).capacity == 108
    kw = dict(alpha=0.35, gamma=0.5, max_steps=16, seed=5, window=128)
    jc = jgym.Core("ethereum-byzantium", **kw)
    tc = tgym.Core("ethereum-byzantium", device="cpu", **kw)
    rng = np.random.default_rng(0)
    jo, _ = jc.reset()
    to, _ = tc.reset()
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    episodes = 0
    for t in range(60):
        a = int(rng.integers(0, 24)) if t % 2 else jc.policy(jo, "fn19")
        if t % 2 == 0:
            assert tc.policy(to, "fn19") == a
        jo, jr, jd, _, ji = jc.step(a)
        to, tr, td, _, ti = tc.step(a)
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
        assert (tr, td) == (jr, jd)
        for k in ji:
            assert abs(ti[k] - ji[k]) <= 1e-5 * (abs(ji[k]) + 1), k
        if jd:
            episodes += 1
            jo, _ = jc.reset()
            to, _ = tc.reset()
    assert episodes >= 2
