"""The port's gymnasium surface against cpr_tpu.gym on the CPU: the same
seed gives the same step stream through `Core`, `BatchedCore` and the
composed `env_fn`, and the port registers ids of its own."""

import gymnasium
import jax
import numpy as np
import pytest
from gymnasium.utils.env_checker import check_env

import cpr_tpu.gym as jgym
import cpr_tpu_torch.gym as tgym
from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def assert_info(t, j):
    clock = np.abs(np.asarray(j["episode_sim_time"]))
    assert sorted(t) == sorted(j)
    for k in j:
        g, w = np.asarray(t[k]), np.asarray(j[k])
        if "time" in k:
            assert np.all(np.abs(g - w) <= 1e-5 * (np.abs(w) + clock)), k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_core_stream_matches_reference():
    kw = dict(alpha=0.35, gamma=0.5, max_steps=20, seed=3)
    jc = jgym.Core("nakamoto", **kw)
    tc = tgym.Core("nakamoto", device="cpu", **kw)
    rng = np.random.default_rng(0)
    episodes = 0
    for ep_seed in (None, 7):
        jo, _ = jc.reset(seed=ep_seed)
        to, _ = tc.reset(seed=ep_seed)
        assert to.dtype == np.float64
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
        for t in range(90):
            if t % 3:
                a = int(rng.integers(0, 4))
            else:  # the reference surface's policy dispatch, on both
                a = jc.policy(jo, "sapirshtein-2016-sm1")
                assert tc.policy(to, "sapirshtein-2016-sm1") == a
            jo, jr, jd, jt, ji = jc.step(a)
            to, tr, td, tt, ti = tc.step(a)
            np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
            assert (tr, td, tt) == (jr, jd, jt)
            assert_info(ti, ji)
            if jd:
                episodes += 1
                jo, _ = jc.reset()
                to, _ = tc.reset()
                np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    assert episodes >= 6


def test_batched_core_matches_reference():
    kw = dict(alpha=0.3, gamma=0.7, max_steps=12, n_envs=8, seed=11)
    jb = jgym.BatchedCore("nakamoto", **kw)
    tb = tgym.BatchedCore("nakamoto", device="cpu", **kw)
    jo, _ = jb.reset()
    to, _ = tb.reset()
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    rng = np.random.default_rng(1)
    dones = 0
    for _ in range(50):
        a = rng.integers(0, 4, 8)
        jo, jr, jd, jt, ji = jb.step(a)
        to, tr, td, tt, ti = tb.step(a)
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tt, jt)
        assert_info(ti, ji)
        dones += int(td.sum())
    assert dones >= 8


def test_env_fn_composition_matches_reference():
    kw = dict(episode_len=16, alpha=[0.2, 0.3, 0.4], gamma=0.5, seed=5)
    je = jgym.env_fn(**kw)
    te = tgym.env_fn(device="cpu", **kw)
    jo, _ = je.reset()
    to, _ = te.reset()
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    ends = 0
    for _ in range(120):
        a = je.policy(jo, "honest")
        assert te.policy(to, "honest") == a
        jo, jr, jd, jt, ji = je.step(a)
        to, tr, td, tt, ti = te.step(a)
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
        assert (td, tt) == (jd, jt)
        assert tr == pytest.approx(jr, rel=1e-12)
        assert ti["alpha"] == ji["alpha"]
        if jd or jt:
            ends += 1
            jo, _ = je.reset()
            to, _ = te.reset()
    assert ends >= 5


def test_check_env():
    check_env(tgym.Core("nakamoto", max_steps=32, device="cpu"),
              skip_render_check=True)
    env = gymnasium.make("cpr-nakamoto-torch-v0", episode_len=32,
                         device="cpu")
    check_env(env.unwrapped, skip_render_check=True)


def test_ids_are_distinct_from_the_reference():
    jax_ids = {"core-v0", "cpr-v0", "cpr-nakamoto-v0"}
    assert not set(tgym.ENV_IDS) & jax_ids
    for eid in tgym.ENV_IDS + tuple(jax_ids):
        assert eid in gymnasium.envs.registry
    port = gymnasium.make("core-torch-v0", max_steps=8, device="cpu")
    ref = gymnasium.make("core-v0", max_steps=8)
    assert isinstance(port.unwrapped, tgym.Core)
    assert isinstance(port.unwrapped.torch_env, NakamotoSSZ)
    assert isinstance(ref.unwrapped, jgym.Core)


def test_core_surface(capsys):
    core = tgym.Core("nakamoto", max_steps=8, device="cpu")
    core.render()
    assert "not reset" in capsys.readouterr().out
    obs, _ = core.reset()
    core.render()
    assert "public_blocks=" in capsys.readouterr().out
    assert set(core.policies()) == set(jgym.Core(
        "nakamoto", max_steps=8).policies())
    with pytest.raises(ValueError, match="not a valid policy"):
        core.policy(obs, "no-such-policy")
    with pytest.raises(Exception, match="max_steps"):
        tgym.Core("nakamoto", device="cpu")
