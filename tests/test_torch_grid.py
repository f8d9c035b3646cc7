"""The port's parametric compile and grid solve (`cpr_tpu_torch.mdp.grid`)
against `cpr_tpu.mdp.grid` on the CPU: the monomial tracer, the
parametric columns (Python frontier and native compiles), revalued
columns bit for bit, the PT transform, the grid solve bit for bit against
JAX and against the port's solo chunked solves (the plain twin of K7),
the grid battery, the sealed solve cache and the exact break-even."""

import os

import numpy as np
import pytest
import torch

from cpr_tpu.mdp import grid as JG
from cpr_tpu_torch.mdp import grid as G
from cpr_tpu_torch.mdp.explicit import MDP, ptmdp, vi_chunked
from cpr_tpu_torch.mdp.models import Aft20BitcoinSM, Fc16BitcoinSM

MFL, HORIZON = 6, 30
POINTS = [(0.2, 0.3), (0.33, 0.5), (0.45, 0.9)]
ALPHAS, GAMMAS = (0.25, 0.35), (0.25, 0.75)
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fc16_pt():
    return (G.param_ptmdp(G.compile_protocol("fc16", cutoff=MFL),
                          horizon=HORIZON),
            JG.param_ptmdp(JG.compile_protocol("fc16", cutoff=MFL),
                           horizon=HORIZON))


def revalued_mdp(pm, a, g):
    """A plain MDP over the same revalued column the grid solves."""
    src, act, dst, _, reward, progress = pm.mdp.arrays()
    return MDP(n_states=pm.mdp.n_states, n_actions=pm.mdp.n_actions,
               start=dict(pm.mdp.start), src=src, act=act, dst=dst,
               prob=pm.revalue(a, g), reward=reward, progress=progress)


def assert_same_param(pm, jp):
    for got, want in zip(pm.mdp.arrays(), jp.mdp.arrays()):
        np.testing.assert_array_equal(got, want)
    for f in ("coef", "expo", "start_ids", "start_coef", "start_expo"):
        np.testing.assert_array_equal(getattr(pm, f), getattr(jp, f))
    assert pm.mdp.start == jp.mdp.start


def test_param_tracer_algebra():
    a, g = G.param_pair()
    p = a * g * (1 - a)
    assert isinstance(p, G.Param)
    assert p.expo == (1, 1, 1, 0) and p.coef == 1.0
    assert ((1 - g) * (1 - g)).expo == (0, 0, 0, 2)
    r = 0.5 * a * 2.0
    assert r.expo == (1, 0, 0, 0) and r.coef == 1.0
    assert float(p) == float(a) * float(g) * (1 - float(a))
    assert a < 0.5 and a * g < a and a * g == g * a
    s = a + (1 - a)
    assert isinstance(s, float) and s == pytest.approx(1.0)
    ja, jg = JG.param_pair()
    jp = ja * jg * (1 - ja)
    assert (p.coef, p.expo, p.value) == (jp.coef, jp.expo, jp.value)


def test_param_tracer_rejects_non_monomials():
    a, g = G.param_pair()
    with pytest.raises(G.ParamError):
        a - 1  # noqa: B018
    with pytest.raises(G.ParamError):
        1 - a * g
    with pytest.raises(G.ParamError):
        1 - 2 * a
    with pytest.raises(TypeError):
        a / g  # noqa: B018
    with pytest.raises(G.ParamError):
        G._extract_param("0.5", "prob")


@pytest.mark.parametrize("mfl", [6, 8])
@pytest.mark.parametrize("proto", ["fc16", "aft20"])
def test_param_columns_and_revalue_equal_jax(proto, mfl):
    pm = G.compile_protocol(proto, cutoff=mfl)
    jp = JG.compile_protocol(proto, cutoff=mfl)
    assert_same_param(pm, jp)
    for a, g in POINTS:
        np.testing.assert_array_equal(pm.revalue(a, g), jp.revalue(a, g))
        np.testing.assert_array_equal(pm.start_vector(a, g),
                                      jp.start_vector(a, g))
    assert pm.fingerprint() == jp.fingerprint()
    ppt, jpt = (G.param_ptmdp(pm, horizon=HORIZON),
                JG.param_ptmdp(jp, horizon=HORIZON))
    assert_same_param(ppt, jpt)


@pytest.mark.parametrize("proto", ["fc16", "aft20"])
def test_check_revalue_parity_against_fresh_port_compiles(proto):
    cls = Fc16BitcoinSM if proto == "fc16" else Aft20BitcoinSM
    pm = G.compile_protocol(proto, cutoff=MFL)
    assert G.check_revalue_parity(
        pm, lambda a, g: cls(alpha=a, gamma=g, maximum_fork_length=MFL),
        POINTS) == len(POINTS)
    with pytest.raises(AssertionError, match="diverges"):
        G.check_revalue_parity(
            pm, lambda a, g: cls(alpha=a, gamma=g,
                                 maximum_fork_length=MFL + 1), POINTS[:1])


def test_param_ptmdp_matches_explicit_ptmdp(fc16_pt):
    pm, _ = fc16_pt
    base = G.compile_protocol("fc16", cutoff=MFL)
    oracle = ptmdp(revalued_mdp(base, 0.33, 0.6), horizon=HORIZON)
    assert pm.n_transitions == oracle.n_transitions
    np.testing.assert_allclose(pm.revalue(0.33, 0.6),
                               np.asarray(oracle.prob, np.float64),
                               rtol=1e-12, atol=0)


def test_native_exponent_recovery_equals_jax():
    kw = dict(k=2, collect_garbage="simple", dag_size_cutoff=5)
    pm = G.parametric_compile_native("ghostdag", **kw)
    jp = JG.parametric_compile_native("ghostdag", **kw)
    assert_same_param(pm, jp)
    assert pm.meta == jp.meta
    assert G.compile_protocol("ghostdag", cutoff=5, native=True
                              ).fingerprint() == JG.compile_protocol(
        "ghostdag", cutoff=5, native=True).fingerprint()


@pytest.mark.parametrize("gammas", [GAMMAS, (0.0, 1.0)],
                         ids=["interior", "gamma-0-1"])
def test_grid_vi_bit_identical_to_jax_and_solo(fc16_pt, gammas):
    # at gamma 0 and 1 rows carry probability 0, so the points' segment
    # validity differs: the per-point masks must follow each column
    pm, jp = fc16_pt
    vi = G.grid_value_iteration(pm, ALPHAS, gammas, stop_delta=1e-6,
                                device=CPU)
    jv = JG.grid_value_iteration(jp, ALPHAS, gammas, stop_delta=1e-6)
    for k in ("grid_value", "grid_progress", "grid_policy", "grid_iter",
              "grid_converged", "grid_revenue", "grid_start",
              "vi_residuals"):
        np.testing.assert_array_equal(vi[k], np.asarray(jv[k]), err_msg=k)
    assert vi["vi_iter"] == jv["vi_iter"]
    assert vi["grid_converged"].all()
    for gi, (a, g) in enumerate(vi["grid_points"]):
        tm = revalued_mdp(pm, a, g).tensor(device=CPU)
        v, p, pol, _, it, _ = vi_chunked(tm, 1.0, tm._cast(1e-6), 1 << 30)
        np.testing.assert_array_equal(vi["grid_value"][gi], v.numpy())
        np.testing.assert_array_equal(vi["grid_progress"][gi], p.numpy())
        np.testing.assert_array_equal(vi["grid_policy"][gi], pol.numpy())
        assert int(vi["grid_iter"][gi]) == it


def test_grid_vi_max_iter_and_frozen_points(fc16_pt):
    pm, jp = fc16_pt
    kw = dict(stop_delta=1e-6, max_iter=100, chunk=32)
    vi = G.grid_value_iteration(pm, ALPHAS, GAMMAS, device=CPU, **kw)
    jv = JG.grid_value_iteration(jp, ALPHAS, GAMMAS, **kw)
    # 100 = 3 chunks of 32 and a 1-sweep tail, 4 times
    assert vi["vi_iter"] == jv["vi_iter"] == 100
    for k in ("grid_value", "grid_iter", "grid_converged", "grid_delta",
              "vi_residuals"):
        np.testing.assert_array_equal(vi[k], np.asarray(jv[k]), err_msg=k)


def test_grid_emits_mdp_solve_event(fc16_pt):
    import io
    import json

    from cpr_tpu_torch import telemetry

    sink = io.StringIO()
    telemetry.configure(stream=sink)
    try:
        G.grid_value_iteration(fc16_pt[0], ALPHAS, GAMMAS, stop_delta=1e-4,
                               protocol="fc16", cutoff=MFL, device=CPU)
    finally:
        telemetry.configure(None)
    ev = [json.loads(line) for line in sink.getvalue().splitlines()]
    solve = [e for e in ev if e["name"] == "mdp_solve"][0]
    assert solve["grid"] == [2, 2] and solve["points"] == 4
    assert solve["converged"] == 4 and solve["protocol"] == "fc16"
    assert any(e["name"] == "memory" and e["scope"] == "mdp_grid"
               for e in ev)


def test_measure_rows_grid_matches_serial():
    from cpr_tpu_torch.experiments.measure_mdp import (measure_rows,
                                                       measure_rows_grid)
    from cpr_tpu_torch.mdp.generic import compile_native

    alphas, gamma = (0.25, 0.4), 0.5
    battery = []
    for a in alphas:
        battery += [
            (f"fc16-{a}", lambda a=a: Fc16BitcoinSM(
                alpha=a, gamma=gamma, maximum_fork_length=MFL)),
            (f"aft20-{a}", lambda a=a: Aft20BitcoinSM(
                alpha=a, gamma=gamma, maximum_fork_length=MFL)),
            (f"generic-ghostdag-{a}", lambda a=a: compile_native(
                "ghostdag", k=2, alpha=a, gamma=gamma,
                collect_garbage="simple", dag_size_cutoff=5))]
    serial = {r["model"]: r for r in measure_rows(
        battery, horizon=HORIZON, device=CPU)}
    groups = [("fc16", MFL, {}, "fc16"), ("aft20", MFL, {}, "aft20"),
              ("ghostdag", 5, {"native": True, "k": 2},
               "generic-ghostdag")]
    grid = measure_rows_grid(groups, alphas=alphas, gamma=gamma,
                             horizon=HORIZON, device=CPU)
    assert sorted(r["model"] for r in grid) == sorted(serial)
    for gr in grid:
        sr = serial[gr["model"]]
        assert gr["n_states"] == sr["n_states"]
        assert gr["n_transitions"] == sr["n_transitions"]
        assert gr["revenue"] == pytest.approx(sr["revenue"], abs=5e-6)
        assert gr["group_points"] == len(alphas)


def test_solve_grid_cached_miss_hit_and_regenerate(tmp_path, monkeypatch):
    from cpr_tpu_torch import integrity

    monkeypatch.setenv("CPR_MDP_CACHE", str(tmp_path))
    kw = dict(cutoff=MFL, alphas=(0.25, 0.4), gammas=(0.5,),
              horizon=HORIZON, stop_delta=1e-6, device=CPU)
    miss = G.solve_grid_cached("fc16", **kw)
    assert miss["cached"] is False and all(miss["converged"])
    hit = G.solve_grid_cached("fc16", **kw)
    assert hit["cached"] is True and hit["integrity"] == "verified"
    assert hit["revenue"] == miss["revenue"]
    assert hit["fingerprint"] == miss["fingerprint"]
    # the JAX package's cache entry for the same solve agrees
    want = JG.solve_grid_cached("fc16", cache=False, **{
        k: v for k, v in kw.items() if k != "device"})
    assert miss["fingerprint"] == want["fingerprint"]
    assert miss["revenue"] == want["revenue"]
    # a flipped byte is a miss: quarantined, then solved and sealed again
    (entry,) = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    path = tmp_path / entry
    data = bytearray(path.read_bytes())
    data[-2] ^= 0xFF
    path.write_bytes(bytes(data))
    again = G.solve_grid_cached("fc16", **kw)
    assert again["cached"] is False and again["revenue"] == miss["revenue"]
    assert os.listdir(integrity.quarantine_dir(str(path))) == [entry]
    assert G.solve_grid_cached("fc16", **kw)["cached"] is True
    pol = G.solve_grid_cached("fc16", include_policy=True, **kw)
    assert pol["cached"] is False and len(pol["policy"]) == 2


def test_break_even_exact_monotone_in_gamma(tmp_path, monkeypatch):
    from cpr_tpu_torch.experiments.break_even import (break_even_exact,
                                                      exact_revenue_curve)

    monkeypatch.setenv("CPR_MDP_CACHE", str(tmp_path))
    curve = exact_revenue_curve("fc16", gamma=0.5, cutoff=MFL,
                                alphas=(0.2, 0.3, 0.4), horizon=HORIZON,
                                device=CPU)
    assert curve == sorted(curve)
    kw = dict(cutoff=MFL, support=(0.1, 0.45), grid=5, horizon=HORIZON,
              device=CPU)
    be_lo = break_even_exact("fc16", gamma=0.2, **kw)
    be_hi = break_even_exact("fc16", gamma=0.9, **kw)
    assert 0.1 <= be_hi <= be_lo <= 0.45
    full = break_even_exact("fc16", gamma=0.9, full=True, **kw)
    assert full["alpha"] == be_hi and full["cached"] is True


def test_monte_carlo_break_even_is_queued():
    from cpr_tpu_torch.experiments import break_even

    with pytest.raises(NotImplementedError, match="item 9"):
        break_even.revenue("nakamoto", "honest", alpha=0.3, gamma=0.5)
    with pytest.raises(NotImplementedError, match="item 9"):
        break_even.break_even("nakamoto", "honest")
