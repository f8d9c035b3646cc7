"""The port's transition-sharded VI (the plain twin of K16-psum), sharded
lanes and sharded episode streams (`cpr_tpu_torch.parallel`) against
`cpr_tpu` on the CPU.

The reference runs on the conftest's forced host devices
(`jax.devices()[:n]`); the port on `default_mesh(devices=["cpu"] * n)`.

Tolerances. `sharded_value_iteration` sums the shards' partial Q planes
in shard order over the port's sorted rows, the reference in XLA's psum
order over its compiled-order chunks, so the two agree to the
reference's own tolerance (tests/test_mdp.py:105-129): values and
progress to rtol 1e-6, atol 1e-7, the policy equal wherever the Q-gap
(best minus second-best action value) exceeds 1e-4; with Anderson
mixing (`accel_m`) the sweep paths part in the last bits (see
tests/test_torch_mdp.py), and the fixpoint is held to the same
tolerance. At 1 shard the port's while solve equals its single-device
solve bit for bit. Sharded lanes and sharded streams hold bit for bit
against the unsharded port, and the lanes against `cpr_tpu`'s sharded
lane programs as tests/test_torch_nakamoto.py holds the unsharded ones
(time fields to rtol 1e-5); the sharded streams against `cpr_tpu`'s at
rtol 1e-5, as tests/test_multichip.py:96 holds its chunked streams.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu_torch import random as rnd

CPU = "cpu"
# the reference's fc16 PT-MDP (tests/test_mdp.py:105) and GhostDAG table
# (tests/test_multichip.py:158)
PSUM_TABLES = ("fc16_25", "gd5")
PSUM_STOP = 1e-6
RTOL, ATOL, GAP = 1e-6, 1e-7, 1e-4
LANES, MAX_STEPS = 8, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def ref_mesh(n):
    from cpr_tpu.parallel import default_mesh
    return default_mesh(devices=jax.devices()[:n])


def port_mesh(n):
    from cpr_tpu_torch.parallel import default_mesh
    return default_mesh(devices=[CPU] * n)


def ref_psum_table(name):
    from cpr_tpu.mdp import Compiler, ptmdp
    from cpr_tpu.mdp.models import Fc16BitcoinSM
    if name == "gd5":
        from cpr_tpu.mdp.generic.native import compile_native
        return ptmdp(compile_native("ghostdag", k=2, alpha=0.3, gamma=0.5,
                                    collect_garbage="simple",
                                    dag_size_cutoff=5),
                     horizon=10).tensor()
    return ptmdp(Compiler(Fc16BitcoinSM(alpha=0.33, gamma=0.7,
                                        maximum_fork_length=25)).mdp(),
                 horizon=60).tensor()


def q_gap(jt, value=None):
    """Best minus second-best action value of each state under the
    reference's own while fixpoint (nan where a state has < 2 actions)."""
    if value is None:
        value = jt.value_iteration(stop_delta=PSUM_STOP)["vi_value"]
    src, act, dst, prob, reward, _ = jt._numpy()
    S, A = jt.n_states, jt.n_actions
    q = np.zeros(S * A)
    key = src.astype(np.int64) * A + act
    np.add.at(q, key, prob * (reward + np.asarray(value, np.float64)[dst]))
    present = np.zeros(S * A, bool)
    present[key] = True
    q = -np.sort(-np.where(present, q, -np.inf).reshape(S, A), axis=1)
    with np.errstate(invalid="ignore"):
        return q[:, 0] - q[:, 1]


@pytest.fixture(scope="module")
def psum_tables():
    from cpr_tpu_torch import convert
    out = {}
    for name in PSUM_TABLES:
        jt = ref_psum_table(name)
        tm = convert.tensor_mdp(jt.n_states, jt.n_actions, *(
            np.asarray(getattr(jt, f)) for f in (
                "start", "src", "act", "dst", "prob", "reward",
                "progress")), device=CPU)
        out[name] = (jt, tm, q_gap(jt))
    return out


@pytest.fixture(scope="module")
def ref_psum(psum_tables):
    from cpr_tpu.parallel import sharded_value_iteration
    return {(name, impl, accel): sharded_value_iteration(
        jt, ref_mesh(4), stop_delta=PSUM_STOP, impl=impl, accel_m=accel)
        for name, (jt, _, _) in psum_tables.items()
        for impl, accel in (("while", 0), ("chunked", 0), ("chunked", 3))}


def assert_close(got, want, gap, what):
    for k in ("vi_value", "vi_progress"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {k}")
    sure = gap > GAP
    np.testing.assert_array_equal(got["vi_policy"][sure],
                                  np.asarray(want["vi_policy"])[sure],
                                  err_msg=f"{what} policy")


@pytest.mark.parametrize("impl,accel", [("while", 0), ("chunked", 0),
                                        ("chunked", 3)],
                         ids=["while", "chunked", "chunked-accel3"])
@pytest.mark.parametrize("name", PSUM_TABLES)
def test_sharded_vi_matches_reference(psum_tables, ref_psum, name, impl,
                                      accel):
    from cpr_tpu_torch.parallel import sharded_value_iteration
    jt, tm, gap = psum_tables[name]
    want = ref_psum[(name, impl, accel)]
    got = sharded_value_iteration(tm, port_mesh(4), stop_delta=PSUM_STOP,
                                  impl=impl, accel_m=accel)
    assert_close(got, want, gap, f"{name} {impl} accel {accel}")
    if accel:
        return  # the mixing weights' last bits set the path (docstring)
    assert abs(got["vi_iter"] - want["vi_iter"]) <= (
        0 if impl == "while" else 64)
    single = tm.value_iteration(stop_delta=PSUM_STOP, impl=impl)
    assert_close(got, single, gap, f"{name} {impl} vs one device")
    if impl == "while" and name == "gd5":
        one = sharded_value_iteration(tm, port_mesh(1), stop_delta=PSUM_STOP)
        for k in ("vi_value", "vi_progress", "vi_policy"):
            np.testing.assert_array_equal(one[k], single[k], k)
        assert one["vi_iter"] == single["vi_iter"]


def test_psum_fixture_is_current(psum_tables, ref_psum):
    from test_torch_state_shard import FIXTURE
    with np.load(FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
    for name, (jt, _, gap) in psum_tables.items():
        np.testing.assert_array_equal(fx[f"psum_{name}_prob"],
                                      np.asarray(jt.prob))
        np.testing.assert_array_equal(fx[f"psum_{name}_gap"], gap)
        for impl in ("while", "chunked"):
            for k in ("value", "policy", "iter"):
                np.testing.assert_array_equal(
                    fx[f"psum_{name}_{impl}_{k}"],
                    np.asarray(ref_psum[(name, impl, 0)][f"vi_{k}"]))


def test_psum_refusals(psum_tables):
    from cpr_tpu_torch.parallel import sharded_value_iteration
    tm = psum_tables["gd5"][1]
    with pytest.raises(ValueError, match="impl='chunked'"):
        sharded_value_iteration(tm, port_mesh(2), stop_delta=PSUM_STOP,
                                impl="while", checkpoint_path="x")
    with pytest.raises(NotImplementedError, match="item 6"):
        sharded_value_iteration(tm, port_mesh(2), stop_delta=PSUM_STOP,
                                impl="chunked", checkpoint_path="x")
    with pytest.raises(ValueError, match="at most 8 shards"):
        sharded_value_iteration(tm, port_mesh(9), stop_delta=PSUM_STOP)


# -- the entry points that pass a mesh through --------------------------------


def test_measure_rows_mesh_matches_reference():
    from cpr_tpu.experiments import measure_mdp as j_measure
    from cpr_tpu.mdp.models import Fc16BitcoinSM as JFc16
    from cpr_tpu_torch.experiments import measure_mdp
    battery = measure_mdp.model_battery((0.3,), 0.5, generic_cutoff=4,
                                        mfl=6)[:2]
    rows = measure_mdp.measure_rows(battery, mesh=port_mesh(4))
    plain = measure_mdp.measure_rows(battery, device=CPU)
    jrows = j_measure.measure_rows(
        [("fc16-0.3", lambda: JFc16(alpha=0.3, gamma=0.5,
                                    maximum_fork_length=6))],
        mesh=ref_mesh(4))
    assert [r["model"] for r in rows] == ["fc16-0.3", "aft20-0.3"]
    for got, want in zip(rows, plain):
        assert got["revenue"] == pytest.approx(want["revenue"], abs=1e-6)
        assert got["n_states"] == want["n_states"]
    assert rows[0]["revenue"] == pytest.approx(jrows[0]["revenue"],
                                               abs=1e-6)
    grid_rows = measure_mdp.measure_rows_grid(
        [("fc16", 6, {}, "fc16")], alphas=(0.25, 0.3, 0.35, 0.4),
        mesh=port_mesh(4))
    solo = measure_mdp.measure_rows_grid(
        [("fc16", 6, {}, "fc16")], alphas=(0.25, 0.3, 0.35, 0.4),
        device=CPU)
    assert [r["revenue"] for r in grid_rows] == [r["revenue"] for r in solo]


def test_break_even_and_grid_pass_the_mesh_through(tmp_path, monkeypatch):
    from cpr_tpu.mdp import grid as JG
    from cpr_tpu_torch.experiments.break_even import break_even_exact
    from cpr_tpu_torch.mdp import grid as G
    monkeypatch.setenv("CPR_MDP_CACHE", str(tmp_path))
    kw = dict(cutoff=5, support=(0.1, 0.45), grid=8, horizon=30)
    sharded = break_even_exact("fc16", gamma=0.5, mesh=port_mesh(4),
                               full=True, **kw)
    monkeypatch.setenv("CPR_MDP_CACHE", str(tmp_path / "solo"))
    solo = break_even_exact("fc16", gamma=0.5, device=CPU, full=True, **kw)
    assert sharded["alpha"] == solo["alpha"]
    with pytest.raises(ValueError, match="cannot shard 8 grid points"):
        monkeypatch.setenv("CPR_MDP_CACHE", str(tmp_path / "three"))
        break_even_exact("fc16", gamma=0.5, mesh=port_mesh(3), **kw)
    pm = G.param_ptmdp(G.compile_protocol("fc16", cutoff=5), horizon=30)
    jp = JG.param_ptmdp(JG.compile_protocol("fc16", cutoff=5), horizon=30)
    alphas, gammas = (0.25, 0.35), (0.25, 0.75)
    got = G.grid_value_iteration(pm, alphas, gammas, stop_delta=1e-6,
                                 mesh=port_mesh(4))
    want = JG.grid_value_iteration(jp, alphas, gammas, stop_delta=1e-6,
                                   mesh=ref_mesh(4))
    for k in ("grid_value", "grid_progress", "grid_policy", "grid_iter",
              "vi_residuals"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    cached = G.solve_grid_cached("fc16", cutoff=5, alphas=alphas,
                                 gammas=gammas, horizon=30,
                                 mesh=port_mesh(2), cache=False)
    assert cached["revenue"] == [round(float(r), 12)
                                 for r in got["grid_revenue"]]


# -- sharded lanes -------------------------------------------------------------


def _keys(seeds):
    return (jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds,
                                                     dtype=jnp.uint32)),
            torch.stack([rnd.PRNGKey(s, device=CPU) for s in seeds]))


def _carry_equal(a, b, what):
    from cpr_tpu_torch.envs.base import map_state
    map_state(lambda x, y: np.testing.assert_array_equal(
        x.numpy(), y.numpy(), err_msg=what), a, b)


def _outputs_equal(a, b, what):
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=what)
    for k in a[3]:
        np.testing.assert_array_equal(a[3][k].numpy(), b[3][k].numpy(),
                                      err_msg=f"{what} {k}")


def test_sharded_lanes_nakamoto_match_reference():
    """tests/test_sharded_lanes.py:44 case by case: six ticks of random
    admit/hold/step masks through the port's sharded lanes, the port's
    unsharded lanes and cpr_tpu's sharded lane programs."""
    from test_torch_nakamoto import assert_info, assert_obs, assert_state

    from cpr_tpu.envs import registry as jregistry
    from cpr_tpu.parallel import make_sharded_lane_fns as j_lanes
    from cpr_tpu.params import make_params as jmake
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.parallel import make_sharded_lane_fns
    jenv = jregistry.get_sized("nakamoto", MAX_STEPS)
    env = registry.get_sized("nakamoto", MAX_STEPS)
    jp = jmake(alpha=0.25, gamma=0.5, max_steps=MAX_STEPS)
    tp = make_params(alpha=0.25, gamma=0.5, max_steps=MAX_STEPS)
    jfns, fns = j_lanes(jenv, ref_mesh(4)), make_sharded_lane_fns(
        env, port_mesh(4))
    jk, tk = _keys(range(LANES))
    jf, tf = _keys(range(100, 100 + LANES))
    jcarry, carry = jfns.init_lanes(jk, jp), fns.init_lanes(tk, tp)
    single = env.init_lanes(tk, tp)
    jfresh, fresh = jfns.init_lanes(jf, jp), fns.init_lanes(tf, tp)
    fresh1 = env.init_lanes(tf, tp)
    assert len(carry) == 4
    _carry_equal(fns.gather(carry), single, "init")
    rng = np.random.RandomState(7)
    for t in range(6):
        a = rng.randint(0, env.n_actions, LANES).astype(np.int32)
        admit = rng.rand(LANES) < 0.25
        step = rng.rand(LANES) < 0.7
        jcarry, jout = jfns.step_lanes(jcarry, jnp.asarray(a),
                                       jnp.asarray(admit), jfresh,
                                       jnp.asarray(step), jp)
        args = (torch.from_numpy(a), torch.from_numpy(admit))
        carry, out = fns.step_lanes(carry, *args, fresh,
                                    torch.from_numpy(step), tp)
        single, out1 = env.step_lanes(single, *args, fresh1,
                                      torch.from_numpy(step), tp)
        _carry_equal(fns.gather(carry), single, f"tick {t} carry")
        _outputs_equal(out, out1, f"tick {t} out")
        state, obs = fns.gather(carry)
        assert_state(state, jcarry[0], f"tick {t}")
        assert_obs(obs, jcarry[1], f"tick {t} carry")
        assert_obs(out[0], jout[0], f"tick {t} out")
        np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]))
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(jout[2]))
        assert_info(out[3], jout[3], f"tick {t}")


def test_sharded_lanes_dag_env_match_unsharded():
    """A DAG env (Bk, k=2, a 32-slot ring): admission and holds per
    shard bit for bit against the unsharded lanes."""
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.parallel import make_sharded_lane_fns
    env = registry.get("bk-2-constant", window=32)
    tp = make_params(alpha=0.25, gamma=0.5, max_steps=MAX_STEPS)
    fns = make_sharded_lane_fns(env, port_mesh(4))
    _, tk = _keys(range(LANES))
    _, tf = _keys(range(100, 100 + LANES))
    carry, single = fns.init_lanes(tk, tp), env.init_lanes(tk, tp)
    fresh, fresh1 = fns.reset_lanes(tf, tp), env.reset_lanes(tf, tp)
    rng = np.random.RandomState(11)
    for t in range(6):
        a = torch.from_numpy(rng.randint(0, env.n_actions, LANES)
                             .astype(np.int32))
        admit = torch.from_numpy(rng.rand(LANES) < 0.25)
        step = torch.from_numpy(rng.rand(LANES) < 0.7)
        carry, out = fns.step_lanes(carry, a, admit, fresh, step, tp)
        single, out1 = env.step_lanes(single, a, admit, fresh1, step, tp)
        _carry_equal(fns.gather(carry), single, f"tick {t} carry")
        _outputs_equal(out, out1, f"tick {t} out")


def test_uneven_batches_refused_with_both_values_named():
    from cpr_tpu_torch.envs import registry
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.parallel import (check_even_shards,
                                        make_sharded_lane_fns, shard_envs)
    env = registry.get_sized("nakamoto", MAX_STEPS)
    tp = make_params(alpha=0.25, gamma=0.5, max_steps=MAX_STEPS)
    mesh = port_mesh(4)
    fns = make_sharded_lane_fns(env, mesh)
    _, bad = _keys(range(6))
    with pytest.raises(ValueError, match=r"6 lanes.*4 devices"):
        fns.init_lanes(bad, tp)
    with pytest.raises(ValueError, match=r"6 lanes.*4 devices"):
        fns.reset_lanes(bad, tp)
    carry = fns.init_lanes(_keys(range(LANES))[1], tp)
    with pytest.raises(ValueError, match=r"6 lanes.*4 devices"):
        fns.step_lanes(carry, torch.zeros(6, dtype=torch.int32),
                       torch.zeros(6, dtype=torch.bool), carry,
                       torch.ones(6, dtype=torch.bool), tp)
    with pytest.raises(ValueError, match=r"6 batched envs.*4 devices"):
        shard_envs(mesh, {"x": torch.zeros((6, 3))})
    fn = env.make_episode_stats_fn(tp, "honest", MAX_STEPS, mesh=mesh)
    with pytest.raises(ValueError, match=r"6 episode streams.*4 devices"):
        fn(bad)
    assert check_even_shards(8, mesh) == 4
    with pytest.raises(ValueError) as ei:
        check_even_shards(10, mesh, what="lanes")
    assert "10 % 4 = 2" in str(ei.value)
    assert "multiple of the device count" in str(ei.value)
    parts = shard_envs(mesh, {"x": torch.arange(8.0)})
    assert [p["x"].tolist() for p in parts] == [[0.0, 1.0], [2.0, 3.0],
                                                [4.0, 5.0], [6.0, 7.0]]


@pytest.mark.parametrize("chunk", [None, 20], ids=["whole", "chunk20"])
def test_sharded_rollout_matches_unsharded_and_reference(chunk):
    """tests/test_multichip.py:96's streams: the port's sharded stats
    equal its unsharded call bit for bit, metrics on or off (the
    accumulator too), and cpr_tpu's sharded streams to rtol 1e-5."""
    from cpr_tpu.envs.nakamoto import NakamotoSSZ as JEnv
    from cpr_tpu.parallel import sharded_rollout as j_rollout
    from cpr_tpu.params import make_params as jmake
    from cpr_tpu_torch.envs.nakamoto import NakamotoSSZ
    from cpr_tpu_torch.params import make_params
    from cpr_tpu_torch.parallel import make_sharded_rollout_fn
    env = NakamotoSSZ()
    tp = make_params(alpha=0.35, gamma=0.5, max_steps=24)
    pol = "sapirshtein-2016-sm1"
    keys = rnd.split(rnd.PRNGKey(3, device=CPU), 32)
    mesh = port_mesh(8)
    whole = env.make_episode_stats_fn(tp, pol, 48, chunk=chunk)(keys)
    sharded = make_sharded_rollout_fn(env, mesh, tp, pol, 48,
                                      chunk=chunk)(keys)
    for k in whole:
        np.testing.assert_array_equal(sharded[k].numpy(), whole[k].numpy(),
                                      err_msg=k)
    s1, acc1 = env.make_episode_stats_fn(tp, pol, 48, chunk=chunk,
                                         collect_metrics=True)(keys)
    fn = make_sharded_rollout_fn(env, mesh, tp, pol, 48, chunk=chunk,
                                 collect_metrics=True)
    s4, acc4 = fn(keys)
    assert torch.equal(acc1, acc4)
    assert fn.metrics_spec.summarize(acc4) == fn.metrics_spec.summarize(
        acc1)
    for k in s1:
        assert torch.equal(s1[k], s4[k]), k
        assert torch.equal(s4[k], sharded[k]), k
    jenv = JEnv()
    want = j_rollout(jenv, ref_mesh(8), jax.random.split(
        jax.random.PRNGKey(3), 32), jmake(alpha=0.35, gamma=0.5,
                                          max_steps=24),
        jenv.policies[pol], 48, chunk=chunk)
    for k in want:
        np.testing.assert_allclose(sharded[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)
