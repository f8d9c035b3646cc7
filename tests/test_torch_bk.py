"""Port parity of the Bₖ env (`cpr_tpu_torch.envs.bk`, the plain twin of
K10-bk) against cpr_tpu on the CPU.

The same keys go through `cpr_tpu` (vmapped, jitted, XLA:CPU) and through
`cpr_tpu_torch` with `device="cpu"`. Every field of the carry — the
whole DAG, stale ring rows and the rows a logical reset left behind
included — integer state, keys, actions, done, votes and rewards and the
episode sums must be bit-identical; `time`, `born_at`, `vis_d_since` and
the other clock fields hold to rtol 1e-5 (log1p), a step delta to 1e-5
of the clock, unit observations to atol 1e-6 (atan). JAX runs every
scripted policy of one env configuration in one compiled stream
(`lax.switch` on the policy id), so a configuration costs one compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.envs.bk import BkSSZ as JEnv
from cpr_tpu.params import make_params as jmake
from cpr_tpu_torch import convert
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.envs.base import EPISODE_KEYS, INFO_KEYS
from cpr_tpu_torch.envs.bk import BkSSZ as TEnv
from cpr_tpu_torch.params import make_params as tmake

TIME_FIELDS = ("time", "last_chain_time", "last_sim_time", "vis_d_since",
               "born_at")
LANES, STEPS = 16, 120


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


def params(**kw):
    kw = {"alpha": 0.35, "gamma": 0.5, **kw}
    return jmake(**kw), tmake(**kw)


def keys(seed, n):
    return (jax.random.split(jax.random.PRNGKey(seed), n),
            rnd.split(rnd.PRNGKey(seed, device="cpu"), n))


# -- shared helpers (test_torch_ethereum.py and test_torch_dag_golden.py
#    import them) ------------------------------------------------------------

def jax_state_numpy(s) -> dict:
    """A cpr_tpu DAG env state as convert.dag_state_from_numpy takes it."""
    out = {}
    for f in s.__dataclass_fields__:
        v = getattr(s, f)
        if f == "dag":
            out["dag"] = {g: ([np.asarray(p) for p in v.parents]
                              if g == "parents" else np.asarray(getattr(v, g)))
                          for g in v.__dataclass_fields__}
        else:
            out[f] = np.asarray(v)
    return out


def _assert_field(g, w, what):
    assert g.dtype == w.dtype and g.shape == w.shape, what
    if what.replace(".", " ").split()[-1] in TIME_FIELDS:
        with np.errstate(invalid="ignore"):  # inf - inf where withheld
            ok = (g == w) | (np.abs(g - w) <= 1e-5 * np.abs(w))
        assert ok.all(), what
    else:
        np.testing.assert_array_equal(g, w, err_msg=what)


def assert_state(t, j, what=""):
    """Every field of a port state against a cpr_tpu one."""
    assert_state_numpy(convert.dag_state_to_numpy(t), jax_state_numpy(j),
                       what)


def assert_state_numpy(got: dict, want: dict, what=""):
    """Two states in convert.dag_state_to_numpy's form, field by field."""
    assert sorted(got) == sorted(want)
    for f, w in want.items():
        if f == "dag":
            for g, wv in w.items():
                if g == "parents":
                    assert len(got["dag"][g]) == len(wv)
                    for p, (a, b) in enumerate(zip(got["dag"][g], wv)):
                        _assert_field(a, b, f"{what} dag.parents[{p}]")
                else:
                    _assert_field(got["dag"][g], wv, f"{what} dag.{g}")
        else:
            _assert_field(got[f], w, f"{what} {f}")


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


def jax_streams(jenv, jp, jkeys, n_steps):
    """fn(pid) -> (final carry, sums [7, L], n_done [L], traj) of the
    reference's auto-reset stream (`_stream_init` + `_autoreset_body`, as
    `rollout` and the stats drivers run it) under scripted policy `pid`,
    the episode sums accumulated step by step as the chunked driver does;
    one compile for every policy."""
    pols = [jenv.policies[n] for n in jenv.policies]

    @jax.jit
    def run(pid):
        body = jenv._autoreset_body(
            jp, lambda obs: jax.lax.switch(pid, pols, obs))

        def one(k):
            def step(c, _):
                carry, acc, nd = c
                carry, tr = body(carry, None)
                done, info = tr[3], tr[4]
                acc = acc + jnp.stack([jnp.where(done, info[k2], 0.0)
                                       for k2 in EPISODE_KEYS])
                return (carry, acc, nd + done.astype(jnp.int32)), tr

            c0 = (jenv._stream_init(k, jp), jnp.zeros(len(EPISODE_KEYS)),
                  jnp.int32(0))
            return jax.lax.scan(step, c0, None, length=n_steps)

        (carry, acc, nd), traj = jax.vmap(one)(jkeys)
        return carry, acc.T, nd, traj

    return run


def assert_stream(tenv, tp, tk, want, policy, n_steps, what):
    """The port's stream (carry, sums, n_done, trajectory) against
    `jax_streams`' output for one policy."""
    (wstate, wobs), wsums, wnd, wtraj = want
    carry, sums, nd, traj = tenv._stream(None, tk, 1, n_steps, tp, policy,
                                         True, store_traj=True)
    assert_state(carry[0], wstate, what)
    assert_obs(carry[1], wobs, what)
    np.testing.assert_array_equal(nd.numpy(), np.asarray(wnd), err_msg=what)
    ws = np.asarray(wsums)
    for j, k in enumerate(EPISODE_KEYS):
        if "time" in k:
            np.testing.assert_allclose(sums[j].numpy(), ws[j], rtol=1e-5,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(sums[j].numpy(), ws[j],
                                          err_msg=f"{what} {k}")
    obs, action, reward, done, info = traj
    assert_obs(obs, wtraj[0], what)
    for g, w in zip((action, reward, done), wtraj[1:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=what)
    assert_info(info, wtraj[4], what)
    return nd


def assert_stats_drivers(tenv, tp, tk, want, policy, n_steps, chunk):
    """make_episode_stats_fn unchunked and chunked against the sums, and
    `rollout` against the trajectory."""
    _, wsums, wnd, wtraj = want
    obs, action, reward, done, info = tenv.rollout(tk, tp, policy, n_steps)
    assert_obs(obs, wtraj[0], "rollout")
    for g, w in zip((action, reward, done), wtraj[1:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert_info(info, wtraj[4], "rollout")
    nd = np.maximum(np.asarray(wnd), 1)
    for c in (None, chunk):
        got = tenv.make_episode_stats_fn(tp, policy, n_steps, chunk=c)(tk)
        np.testing.assert_array_equal(got["n_episodes"].numpy(),
                                      np.asarray(wnd))
        for j, k in enumerate(EPISODE_KEYS):
            w = (np.asarray(wsums)[j] / nd).astype(np.float32)
            if "time" in k:
                np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5)
            else:
                np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def step_lanes_trace(jenv, tenv, jp, tp, seed, n, ticks, convert_at=None):
    """Random admit/step masks and actions through both packages'
    step_lanes; at tick `convert_at` the port's carry is replaced by the
    reference's, carried across with convert (a mid-episode state)."""
    jk, tk = keys(seed, n)
    jf, tf = keys(seed + 1, n)
    jcarry, tcarry = jenv.init_lanes(jk, jp), tenv.init_lanes(tk, tp)
    jfresh, tfresh = jenv.init_lanes(jf, jp), tenv.init_lanes(tf, tp)
    rng = np.random.default_rng(seed)
    n_done = 0
    for t in range(ticks):
        if t == convert_at:
            tcarry = (convert.dag_state_from_numpy(
                tenv, jax_state_numpy(jcarry[0]), device="cpu"),
                torch.from_numpy(np.asarray(jcarry[1]).copy()))
        a = rng.integers(0, tenv.n_actions, n).astype(np.int32)
        admit = rng.random(n) < 0.1
        step = rng.random(n) < 0.8
        jcarry, jout = jenv.step_lanes(jcarry, jnp.asarray(a),
                                       jnp.asarray(admit), jfresh,
                                       jnp.asarray(step), jp)
        tcarry, tout = tenv.step_lanes(
            tcarry, torch.from_numpy(a), torch.from_numpy(admit), tfresh,
            torch.from_numpy(step), tp)
        assert_state(tcarry[0], jcarry[0], f"tick {t}")
        assert_obs(tcarry[1], jcarry[1], f"tick {t} carry")
        assert_obs(tout[0], jout[0], f"tick {t} out")
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        assert_info(tout[3], jout[3], f"tick {t}")
        n_done += int(tout[2].sum())
    return n_done


# -- configurations -------------------------------------------------------------

# (name, env kwargs): the benchmark's ring (window 128, k = 8), a small
# ring that wraps and overflows (window 16 at k = 2), and full mode (the
# walk-based queries)
CONFIGS = {
    "ring128-k8-constant": dict(k=8, incentive_scheme="constant", window=128),
    "ring16-k2-block": dict(k=2, incentive_scheme="block", window=16),
    "full-k2-constant": dict(k=2, incentive_scheme="constant",
                             max_steps_hint=64),
}
MAX_STEPS = 30
# the configurations and policies whose stats drivers (unchunked, chunked)
# are run too; the stream above is the unchunked driver's own loop
STATS_POLICIES = {"ring128-k8-constant": ("get-ahead",),
                  "full-k2-constant": ("minor-delay",)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def streams(request):
    kw = CONFIGS[request.param]
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=MAX_STEPS)
    jk, tk = keys(3, LANES)
    run = jax_streams(jenv, jp, jk, STEPS)
    want = {name: run(i) for i, name in enumerate(tenv.scripted_policies)}
    return request.param, jenv, tenv, tp, tk, want


@pytest.mark.parametrize("policy", ["honest", "get-ahead", "minor-delay",
                                    "avoid-loss"])
def test_streams_every_policy(streams, policy):
    name, jenv, tenv, tp, tk, want = streams
    nd = assert_stream(tenv, tp, tk, want[policy], policy, STEPS,
                       f"{name} {policy}")
    assert int(nd.min()) >= 2  # the logical reset fired on every lane
    if policy in STATS_POLICIES.get(name, ()):
        assert_stats_drivers(tenv, tp, tk, want[policy],
                             tenv.policies[policy], STEPS, 37)


@pytest.mark.parametrize("streams", ["ring16-k2-block"], indirect=True)
def test_small_ring_wraps_and_overflows(streams):
    name, jenv, tenv, tp, tk, want = streams
    # episodes outgrow the 16-slot window (the ring wraps) ...
    assert max(int(np.asarray(w[0][0].dag.gid).max())
               for w in want.values()) >= 16
    # ... and avoid-loss forks deeper than it holds: overflow ends episodes
    _, _, _, (_, _, _, done, info) = want["avoid-loss"]
    ends = np.asarray(info["episode_n_steps"])
    assert (np.asarray(done) & (ends < MAX_STEPS)).sum() >= 2


@pytest.mark.parametrize("window", [128, None])
def test_step_lanes_and_mid_episode_convert(window):
    kw = dict(k=2, window=window, max_steps_hint=64)
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=12)
    assert step_lanes_trace(jenv, tenv, jp, tp, 6, 16, 50, convert_at=20) > 0


def test_reset_rows_and_select_reset():
    jenv, tenv = JEnv(k=2, window=32), TEnv(k=2, window=32)
    jp, tp = params(max_steps=12)
    jk, tk = keys(10, 8)
    jf, tf = keys(11, 8)
    done = np.arange(8) % 3 == 0
    # a stepped state against a fresh one: rows >= 2 keep their values
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, jp)))
    js = jenv.reset_lanes(jk, jp)[0]
    ts = tenv.reset_lanes(tk, tp)[0]
    for _ in range(6):
        a = np.full(8, 7, np.int32)
        js = jstep(js, jnp.asarray(a))[0]
        ts = tenv.step(ts, torch.from_numpy(a), tp)[0]
    want = jax.vmap(jenv.select_reset)(jnp.asarray(done),
                                       jenv.reset_lanes(jf, jp)[0], js)
    got = tenv.select_reset(torch.from_numpy(done),
                            tenv.reset_lanes(tf, tp)[0], ts)
    assert_state(got, want)
    assert tenv.reset_dag_rows == jenv.reset_dag_rows == 2


def test_policies_match_reference_on_observations():
    for unit in (True, False):
        jenv, tenv = JEnv(k=4, unit_observation=unit), TEnv(
            k=4, unit_observation=unit)
        rng = np.random.default_rng(int(unit))
        ints = np.stack([rng.integers(0, 15, 300), rng.integers(0, 15, 300),
                         rng.integers(-15, 15, 300), rng.integers(0, 9, 300),
                         rng.integers(0, 9, 300), rng.integers(0, 9, 300),
                         rng.integers(0, 2, 300), rng.integers(0, 3, 300)])
        from cpr_tpu import obs as jobs
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
                tenv._policy_ints(pid, t[0], t[1], t[3], t[4]).numpy(), want)


def test_registry_keys_and_gym_core():
    import cpr_tpu.gym as jgym
    import cpr_tpu_torch.gym as tgym
    env = tregistry.get("bk-8-constant")
    assert isinstance(env, TEnv) and env.k == 8
    assert env.incentive_scheme == "constant"
    assert tregistry.get("bk", k=3, incentive_scheme="block").k == 3
    sized = tregistry.get_sized("bk-2-block", 64, window=32)
    assert sized.capacity == max(32, 2 + 8) and sized.ring
    assert tregistry.describe("bk-8-constant") == \
        jregistry.describe("bk-8-constant")
    kw = dict(alpha=0.35, gamma=0.5, max_steps=16, seed=4, window=128)
    jc = jgym.Core("bk-8-constant", **kw)
    tc = tgym.Core("bk-8-constant", device="cpu", **kw)
    rng = np.random.default_rng(0)
    jo, _ = jc.reset()
    to, _ = tc.reset()
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    episodes = 0
    for t in range(60):
        a = int(rng.integers(0, 8)) if t % 2 else jc.policy(jo, "get-ahead")
        if t % 2 == 0:
            assert tc.policy(to, "get-ahead") == a
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


def test_kernels_take_ring_windows_only():
    """Ring windows of at most 128 slots and full mode (K10-bk-full) of
    at most 544 take the kernels; beyond them the check raises on CUDA,
    naming what is queued, before any launch (it runs on the host)."""
    for env, match in ((TEnv(k=2), None),
                       (TEnv(k=2, max_steps_hint=300),
                        "at most 544 slots in full mode .* item 8c"),
                       (TEnv(k=2, window=256), "at most 128 slots"),
                       (TEnv(k=2, window=64, anc_masks=True), None)):
        if match is None:
            env._check_kernel()
            continue
        with pytest.raises(NotImplementedError, match=match):
            env._empty_carry(4, "cpu")
