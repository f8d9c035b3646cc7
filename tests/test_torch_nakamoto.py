"""Port parity of the Nakamoto env and the lane drivers (plain twins of
K2 and K3) against cpr_tpu on the CPU.

The same keys go through `cpr_tpu` (vmapped, jitted, XLA:CPU) and
through `cpr_tpu_torch` with `device="cpu"`. Integer state, keys,
actions, done, the integer-valued float32 rewards/progress and episode
counts must be bit-identical. Time fields come from log1p and a float32
running sum, so they agree to rtol 1e-5 (a step delta is a difference of
two clock readings and is held to 1e-5 of the clock); unit observations
go through atan and agree to atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.envs.base import relative_reward as jrel
from cpr_tpu.envs.base import reward_per_progress as jrpp
from cpr_tpu.envs.nakamoto import NakamotoSSZ as JEnv
from cpr_tpu.params import make_params as jmake
from cpr_tpu_torch import convert
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.envs.base import INFO_KEYS, relative_reward, reward_per_progress
from cpr_tpu_torch.envs.nakamoto import INT_FIELDS, STATE_FIELDS
from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ as TEnv
from cpr_tpu_torch.params import make_params as tmake

POLICIES = ("honest", "simple", "eyal-sirer-2014", "sapirshtein-2016-sm1")
TIME_FIELDS = ("time", "t_priv", "t_pub", "last_chain_time", "last_sim_time")


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def params(**kw):
    kw = {"alpha": 0.35, "gamma": 0.5, **kw}
    return jmake(**kw), tmake(**kw)


def keys(seed, n):
    return (jax.random.split(jax.random.PRNGKey(seed), n),
            rnd.split(rnd.PRNGKey(seed, device="cpu"), n))


def assert_state(t, j, what=""):
    got = convert.state_to_numpy(t)
    for f in STATE_FIELDS:
        w = np.asarray(getattr(j, f))
        if f in TIME_FIELDS:
            np.testing.assert_allclose(got[f], w, rtol=1e-5, atol=0,
                                       err_msg=f"{what} {f}")
        else:
            assert got[f].dtype == w.dtype, f
            np.testing.assert_array_equal(got[f], w, err_msg=f"{what} {f}")


def assert_info(t, j, what=""):
    clock = np.abs(np.asarray(j["episode_sim_time"]))
    for k in INFO_KEYS:
        g, w = t[k].numpy(), np.asarray(j[k])
        if "time" in k:
            assert np.all(np.abs(g - w) <= 1e-5 * (np.abs(w) + clock)), \
                f"{what} {k}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def assert_obs(t, j, what=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6,
                               err_msg=f"{what} obs")


@pytest.mark.parametrize("unit,strict", [(True, True), (False, False)])
def test_reset_and_step_random_actions(unit, strict):
    jenv, tenv = JEnv(unit, strict), TEnv(unit, strict)
    jp, tp = params(max_steps=50)
    jk, tk = keys(1, 32)
    jreset = jax.jit(jax.vmap(lambda k: jenv.reset(k, jp)))
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    js, jo = jreset(jk)
    ts, to = tenv.reset(tk, tp)
    assert_state(ts, js, "reset")
    assert_obs(to, jo, "reset")
    rng = np.random.default_rng(0)
    for t in range(200):
        a = rng.integers(0, 4, 32).astype(np.int32)
        js, jo, jr, jd, ji = jstep(js, jnp.asarray(a))
        ts, to, tr, td, ti = tenv.step(ts, torch.from_numpy(a), tp)
        assert_state(ts, js, f"step {t}")
        assert_obs(to, jo, f"step {t}")
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert_info(ti, ji, f"step {t}")
    assert np.asarray(jd).all()  # steps ran past max_steps


def test_rollout_trajectories():
    jenv, tenv = JEnv(), TEnv()
    jp, tp = params(max_steps=30)
    jk, tk = keys(2, 16)
    n = 120
    for name in ("sapirshtein-2016-sm1", "honest"):
        want = jax.vmap(lambda k: jenv.rollout(k, jp, jenv.policies[name],
                                               n))(jk)
        got = tenv.rollout(tk, tp, tenv.policies[name], n)
        assert_obs(got[0], want[0], name)
        for g, w in zip(got[1:4], want[1:4]):
            assert g.shape == w.shape == (16, n)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert_info(got[4], want[4], name)
        assert int(got[3].sum()) >= 16 * 3
    # a single key gives the unbatched layout of the reference's rollout
    one = tenv.rollout(tk[3], tp, "honest", 40)
    ref = jenv.rollout(jk[3], jp, jenv.policies["honest"], 40)
    assert one[0].shape == (40, 4)
    np.testing.assert_array_equal(one[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("chunk", [None, 37])
@pytest.mark.parametrize("policy", POLICIES)
def test_episode_stats(policy, chunk):
    jenv, tenv = JEnv(), TEnv()
    jp, tp = params(max_steps=50)
    jk, tk = keys(3, 48)
    want = jenv.make_episode_stats_fn(jp, jenv.policies[policy], 300,
                                      chunk=chunk)(jk)
    got = tenv.make_episode_stats_fn(tp, tenv.policies[policy], 300,
                                     chunk=chunk)(tk)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = got[k].numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == (48,), k
        if "time" in k:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["n_episodes"].min() >= 5  # auto-reset fired on every lane


def test_policy_given_by_name_id_or_callable():
    tenv = TEnv()
    _, tp = params(max_steps=20)
    _, tk = keys(4, 8)
    ref = tenv.episode_stats(tk, tp, tenv.policies["simple"], 60)
    for pol in ("simple", 1):
        got = tenv.episode_stats(tk, tp, pol, 60)
        for k in ref:
            assert torch.equal(got[k], ref[k]), (pol, k)
    assert tenv.scripted_policy_id(TEnv(False).policies["honest"]) == 0
    assert tenv.scripted_policy_id(lambda obs: obs[..., 0]) is None
    with pytest.raises(ValueError, match="not a valid policy"):
        tenv.scripted_policy_id("no-such-policy")
    with pytest.raises(ValueError, match="out of range"):
        tenv.scripted_policy_id(7)


def test_custom_callable_policy_runs_plain():
    jenv, tenv = JEnv(), TEnv()
    jp, tp = params(max_steps=25)
    jk, tk = keys(5, 16)
    want = jenv.make_episode_stats_fn(
        jp, lambda obs: jnp.int32(2), 100)(jk)
    got = tenv.make_episode_stats_fn(
        tp, lambda obs: torch.full(obs.shape[:-1], 2, dtype=torch.int32),
        100)(tk)
    for k in ("episode_reward_attacker", "episode_progress", "n_episodes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_public_policies_match_reference_on_observations():
    for unit in (True, False):
        jenv, tenv = JEnv(unit), TEnv(unit)
        rng = np.random.default_rng(unit)
        a = rng.integers(0, 40, 400).astype(np.int32)
        h = rng.integers(0, 40, 400).astype(np.int32)
        ev = rng.integers(0, 2, 400).astype(np.int32)
        obs = np.asarray(jax.vmap(lambda a, h, e: jenv.observe(
            jenv.reset(jax.random.PRNGKey(0), params(max_steps=9)[0])[0]
            .replace(a=a, h=h, event=e)))(a, h, ev))
        for name in POLICIES:
            want = np.asarray(jax.vmap(jenv.policies[name])(obs))
            got = tenv.policies[name](torch.from_numpy(obs.copy()))
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            ints = tenv._policy_ints(tenv.scripted_policy_id(name),
                                     torch.from_numpy(a), torch.from_numpy(h))
            np.testing.assert_array_equal(ints.numpy(), want, err_msg=name)


def test_step_lanes_masks_and_freeze():
    jenv, tenv = JEnv(), TEnv()
    jp, tp = params(max_steps=16)
    n, ticks = 32, 60
    jk, tk = keys(6, n)
    jf, tf = keys(7, n)
    jcarry, tcarry = jenv.init_lanes(jk, jp), tenv.init_lanes(tk, tp)
    jfresh, tfresh = jenv.init_lanes(jf, jp), tenv.init_lanes(tf, tp)
    rng = np.random.default_rng(2)
    held_seen = 0
    for t in range(ticks):
        a = rng.integers(0, 4, n).astype(np.int32)
        admit = rng.random(n) < 0.1
        step = rng.random(n) < 0.7
        before = convert.state_to_numpy(tcarry[0])
        obs_before = tcarry[1].clone()
        jcarry, jout = jenv.step_lanes(jcarry, jnp.asarray(a),
                                       jnp.asarray(admit), jfresh,
                                       jnp.asarray(step), jp)
        carry_ref = tcarry
        tcarry, tout = tenv.step_lanes(
            tcarry, torch.from_numpy(a), torch.from_numpy(admit), tfresh,
            torch.from_numpy(step), tp)
        assert tcarry is carry_ref  # updated in place
        assert_state(tcarry[0], jcarry[0], f"tick {t}")
        assert_obs(tcarry[1], jcarry[1], f"tick {t} carry")
        assert_obs(tout[0], jout[0], f"tick {t} out")
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        assert_info(tout[3], jout[3], f"tick {t}")
        held = ~admit & ~step
        held_seen += int(held.sum())
        after = convert.state_to_numpy(tcarry[0])
        for f in STATE_FIELDS:  # held lanes frozen bit for bit
            np.testing.assert_array_equal(after[f][held], before[f][held])
        assert torch.equal(tcarry[1][torch.from_numpy(held)],
                           obs_before[torch.from_numpy(held)])
        assert not tout[2][torch.from_numpy(~step)].any()
        assert (tout[1][torch.from_numpy(~step)] == 0).all()
    assert held_seen > 0


def test_select_reset():
    jenv, tenv = JEnv(), TEnv()
    jp, tp = params(max_steps=16)
    jk, tk = keys(10, 12)
    jf, tf = keys(11, 12)
    done = np.arange(12) % 3 == 0
    want = jax.vmap(jenv.select_reset)(
        jnp.asarray(done), jenv.reset_lanes(jf, jp)[0],
        jenv.reset_lanes(jk, jp)[0])
    got = tenv.select_reset(torch.from_numpy(done), tenv.reset_lanes(tf, tp)[0],
                            tenv.reset_lanes(tk, tp)[0])
    assert_state(got, want)


def test_init_lanes_and_reset_lanes():
    jenv, tenv = JEnv(), TEnv()
    jp, tp = params(max_steps=16)
    jk, tk = keys(8, 24)
    for fn in ("init_lanes", "reset_lanes"):
        js, jo = getattr(jenv, fn)(jk, jp)
        ts, to = getattr(tenv, fn)(tk, tp)
        assert_state(ts, js, fn)
        assert_obs(to, jo, fn)
    # the prologue split makes the two seedings differ
    assert not torch.equal(tenv.init_lanes(tk, tp)[0].key,
                           tenv.reset_lanes(tk, tp)[0].key)


def test_state_carried_through_convert():
    jenv, tenv = JEnv(), TEnv()
    jp, tp = params(max_steps=40)
    jk, _ = keys(9, 16)
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    js, _ = jax.vmap(lambda k: jenv.reset(k, jp))(jk)
    rng = np.random.default_rng(3)
    for _ in range(10):
        js = jstep(js, jnp.asarray(rng.integers(0, 4, 16), jnp.int32))[0]
    ts = convert.state_from_numpy(
        {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}, device="cpu")
    assert ts.key.dtype == torch.int32 and ts.a.dtype == torch.int32
    for _ in range(30):
        a = rng.integers(0, 4, 16).astype(np.int32)
        js, jo, *_ = jstep(js, jnp.asarray(a))
        ts, to, *_ = tenv.step(ts, torch.from_numpy(a), tp)
    assert_state(ts, js)
    # and back: the port's state as the reference's pytree
    back = convert.state_to_numpy(ts)
    assert back["key"].dtype == np.uint32
    js2 = js.replace(**{f: jnp.asarray(back[f]) for f in STATE_FIELDS})
    for f in INT_FIELDS + ("key",):
        np.testing.assert_array_equal(np.asarray(getattr(js2, f)),
                                      np.asarray(getattr(js, f)))
    with pytest.raises(KeyError, match="missing"):
        convert.state_from_numpy({"a": back["a"]}, device="cpu")


def test_driver_option_errors():
    tenv = TEnv()
    _, tp = params(max_steps=8)
    pol = tenv.policies["honest"]
    with pytest.raises(ValueError, match="chunk must be positive"):
        tenv.make_episode_stats_fn(tp, pol, 10, chunk=0)
    with pytest.raises(NotImplementedError, match="item 14"):
        tenv.make_episode_stats_fn(tp, pol, 10, collect_metrics=True)
    with pytest.raises(NotImplementedError, match="item 13"):
        tenv.make_episode_stats_fn(tp, pol, 10, mesh=object())
    with pytest.raises(NotImplementedError, match="item 14"):
        tenv.rollout(rnd.PRNGKey(0, "cpu"), tp, pol, 4, with_metrics=True)


def test_reward_ratios():
    info = {"episode_reward_attacker": np.array([0, 3, 2, 0], np.float32),
            "episode_reward_defender": np.array([0, 1, 0, 5], np.float32),
            "episode_progress": np.array([0, 4, 2, 5], np.float32)}
    tinfo = {k: torch.from_numpy(v) for k, v in info.items()}
    jinfo = {k: jnp.asarray(v) for k, v in info.items()}
    np.testing.assert_array_equal(relative_reward(tinfo).numpy(),
                                  np.asarray(jrel(jinfo)))
    np.testing.assert_array_equal(reward_per_progress(tinfo).numpy(),
                                  np.asarray(jrpp(jinfo)))


PROTOCOL_KEYS = ["nakamoto", "ethereum-whitepaper", "ethereum-x",
                 "bk-8-constant", "bk-8", "spar-3-block",
                 "stree-4-discount-heuristic", "sdag-1-constant-altruistic",
                 "sdag-2-discount-altruistic", "tailstorm-8-punish-optimal",
                 "tailstorm-8-punish-best", "tailstormjune-4-block",
                 "nakamoto-2", "unknown"]


@pytest.mark.parametrize("key", PROTOCOL_KEYS)
def test_parse_key_grammar(key):
    try:
        want = jregistry.parse_key(key)
    except KeyError as e:
        with pytest.raises(KeyError) as got:
            tregistry.parse_key(key)
        assert str(got.value) == str(e)
        return
    assert tregistry.parse_key(key) == want


def test_registry_surface():
    assert tregistry.keys() == ["bk", "ethereum", "ethereum-byzantium",
                                "ethereum-whitepaper", "nakamoto", "sdag",
                                "spar", "stree", "tailstorm",
                                "tailstormjune"]
    assert tregistry.keys() == jregistry.keys()
    env = tregistry.get("nakamoto")
    assert isinstance(env, TEnv) and tregistry.get("nakamoto") is env
    assert tregistry.get_sized("nakamoto", 128) is env
    assert tregistry.describe("nakamoto") == jregistry.describe("nakamoto")
    raw = tregistry.get("nakamoto", unit_observation=False)
    assert raw is not env and raw.unit_observation is False
    for key in ("spar-3-block", "sdag-2-constant-altruistic"):
        env, jenv = tregistry.get(key), jregistry.get(key)
        assert type(env).__name__ == type(jenv).__name__
        assert (env.k, env.capacity) == (jenv.k, jenv.capacity)
    with pytest.raises(KeyError, match="cannot parse"):
        tregistry.get("nosuch")
