"""Port parity of the Tailstorm env (`cpr_tpu_torch.envs.tailstorm`, the
plain twin of K10-ts) against cpr_tpu on the CPU, with the tolerances and
helpers of tests/test_torch_bk.py: every carry field bit-identical (stale
ring rows and the `stale` plane included), clocks to rtol 1e-5, unit
observations to atol 1e-6, rewards exact. JAX runs every scripted policy
of one configuration in one compiled stream.

The grid covers every incentive scheme and every sub-block selection:
the benchmark's configuration (k = 8, window 128, a candidate frame of
C = 48), rings of 24-32 slots that wrap and overflow (one with a short release
scan), and
full mode (the walk-based queries and the log-doubling closure)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu.envs import registry as jregistry
from cpr_tpu.envs.tailstorm import TailstormSSZ as JEnv
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.envs.tailstorm import TailstormSSZ as TEnv
from test_torch_bk import (assert_state, assert_stats_drivers, assert_stream,
                           jax_streams, keys, params, step_lanes_trace)

LANES, STEPS, MAX_STEPS = 12, 80, 36
CONFIGS = {
    "ring128-k8-discount-heuristic": dict(k=8, window=128),
    # a release scan of 8 positions: more withheld vertices take the
    # release-everything branch of prefix_release_sets
    "ring24-k2-constant-heuristic-r8": dict(
        k=2, incentive_scheme="constant", window=24, release_scan=8),
    "ring28-k3-punish-optimal": dict(k=3, incentive_scheme="punish",
                                     subblock_selection="optimal",
                                     window=28),
    "ring32-k4-hybrid-altruistic": dict(k=4, incentive_scheme="hybrid",
                                        subblock_selection="altruistic",
                                        window=32),
    "full-k2-discount-optimal": dict(k=2, subblock_selection="optimal",
                                     max_steps_hint=40),
}
STATS_POLICIES = {"ring128-k8-discount-heuristic": ("get-ahead",),
                  "full-k2-discount-optimal": ("avoid-loss",)}
POLICIES = ("honest", "get-ahead", "minor-delay", "avoid-loss",
            "avoid-loss-a", "avoid-loss-b", "long-delay")


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


# per small ring: (an episode outgrew the window, forks deeper than it
# ended episodes early, Adopts left stale vertices)
SMALL_RINGS = {"ring24-k2-constant-heuristic-r8": (True, True, False),
               "ring32-k4-hybrid-altruistic": (False, True, True)}


@pytest.mark.parametrize("policy", POLICIES)
def test_streams_every_policy(streams, policy):
    name, jenv, tenv, tp, tk, want = streams
    nd = assert_stream(tenv, tp, tk, want[policy], policy, STEPS,
                       f"{name} {policy}")
    assert int(nd.min()) >= 2  # the logical reset fired on every lane
    if policy in STATS_POLICIES.get(name, ()):
        assert_stats_drivers(tenv, tp, tk, want[policy],
                             tenv.policies[policy], STEPS, 33)
    if policy == POLICIES[-1] and name in SMALL_RINGS:
        wraps, overflows, stale = SMALL_RINGS[name]
        finals = [w[0][0] for w in want.values()]
        ends = np.concatenate([np.asarray(w[3][4]["episode_n_steps"])
                               [np.asarray(w[3][3])] for w in want.values()])
        if wraps:
            assert max(int(np.asarray(s.dag.gid).max()) for s in finals) \
                >= tenv.capacity
        if overflows:
            assert (ends < MAX_STEPS).sum() >= 2
        if stale:
            assert any(np.asarray(s.stale).any() for s in finals)


@pytest.mark.parametrize("window", [32, None])
def test_step_lanes_and_mid_episode_convert(window):
    kw = dict(k=2, window=window, max_steps_hint=32)
    jenv, tenv = JEnv(**kw), TEnv(**kw)
    jp, tp = params(max_steps=12)
    assert step_lanes_trace(jenv, tenv, jp, tp, 6, 12, 40, convert_at=15) > 0


def test_reset_rows_and_select_reset():
    """The logical reset switches rows [0, 2) of the DAG planes and the
    whole `stale` plane (it is not a DAG field)."""
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
                         rng.integers(0, 6, n), rng.integers(0, 6, n),
                         rng.integers(0, 6, n), rng.integers(0, 3, n)])
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
    assert tuple(jenv.policies) == tenv.scripted_policies


def test_registry_keys_and_gym_core():
    import cpr_tpu.gym as jgym
    import cpr_tpu_torch.gym as tgym
    env = tregistry.get("tailstorm-8-discount-heuristic", window=128)
    assert isinstance(env, TEnv) and env.k == 8 and env.ring
    assert env.capacity == 128 and env.C_MAX == 48
    assert (env.incentive_scheme, env.subblock_selection) == (
        "discount", "heuristic")
    opt = tregistry.get("tailstorm-3-hybrid-optimal")
    jopt = jregistry.get("tailstorm-3-hybrid-optimal")
    assert opt.opt_window == jopt.opt_window
    np.testing.assert_array_equal(opt.opt_combos, jopt.opt_combos)
    assert tregistry.describe("tailstorm-8-discount-heuristic") == \
        jregistry.describe("tailstorm-8-discount-heuristic")
    sized = tregistry.get_sized("tailstorm-2-constant-altruistic", 64,
                                window=32)
    assert sized.capacity == 32 and sized.ring
    kw = dict(alpha=0.35, gamma=0.5, max_steps=16, seed=4, window=128)
    jc = jgym.Core("tailstorm-8-discount-heuristic", **kw)
    tc = tgym.Core("tailstorm-8-discount-heuristic", device="cpu", **kw)
    rng = np.random.default_rng(0)
    jo, _ = jc.reset()
    to, _ = tc.reset()
    np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
    episodes = 0
    for t in range(50):
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


def test_vote_paths_match_reference():
    """vote_ancestors, closure_counts and mark_closure (the reference's
    vote-path helpers) on the quorum fixture's wrapped Tailstorm carry."""
    from test_torch_dag_golden import fixture_state
    from test_torch_quorum_golden import FIXTURE

    from cpr_tpu.core.dag import Dag
    from cpr_tpu_torch import convert
    with np.load(FIXTURE) as f:
        d = fixture_state({k: f[k] for k in f.files}, "k9_ts_state_")
    jenv, tenv = JEnv(k=8, window=128), TEnv(k=8, window=128)
    state = convert.dag_state_from_numpy(tenv, d, device="cpu")
    jdag = Dag(**{f: (tuple(jnp.asarray(p) for p in v) if f == "parents"
                      else jnp.asarray(v)) for f, v in d["dag"].items()})
    L, B = state.dag.n_lanes, state.dag.capacity
    starts = np.tile(np.arange(-1, B, dtype=np.int32), (L, 1))
    masks = np.stack([d["dag"]["miner"] == 0, d["dag"]["vis_d"]], 2)
    on = np.arange(L) % 2 == 0
    anc, counts, marked = jax.vmap(
        lambda g, s, m, o: (jenv.vote_ancestors(g, s),
                            jenv.closure_counts(jenv.vote_ancestors(g, s),
                                                m),
                            jenv.mark_closure(jenv.vote_ancestors(g, s)[9],
                                              g.vis_d, o)))(
        jdag, jnp.asarray(starts), jnp.asarray(masks), jnp.asarray(on))
    tanc = tenv.vote_ancestors(state.dag, torch.from_numpy(starts))
    np.testing.assert_array_equal(tanc.numpy(), np.asarray(anc))
    assert (np.asarray(anc)[..., 1] >= 0).any()  # paths of depth > 1
    np.testing.assert_array_equal(
        tenv.closure_counts(tanc, torch.from_numpy(masks)).numpy(),
        np.asarray(counts))
    np.testing.assert_array_equal(
        tenv.mark_closure(tanc[:, 9], state.dag.vis_d,
                          torch.from_numpy(on)).numpy(), np.asarray(marked))


def test_kernels_take_ring_windows_only():
    """Full mode, windows beyond 128 slots and frames beyond 64 candidates
    raise on CUDA, naming what is queued, before any launch."""
    for env, match in ((TEnv(k=2), "full mode .* item 8c"),
                       (TEnv(k=2, window=256), "at most 128 slots"),
                       (TEnv(k=13, window=128), "candidate frames of at most"),
                       (TEnv(k=8, window=128), None)):
        if match is None:
            env._check_kernel()
            continue
        with pytest.raises(NotImplementedError, match=match):
            env._empty_carry(4, "cpu")
