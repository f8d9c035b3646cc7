"""The port's RTDP on the CPU: the padded layout against JAX's, the
reference's convergence and warm-start properties of the device walkers
(kernel K6's plain twin; its walks are held to JAX's in
test_torch_grid_rtdp_golden.py), the `rtdp_graph` result, the chunked
solve warm-started from the walkers' table, and host RTDP and the
explorer against the reference's for fixed seeds."""

import numpy as np
import pytest
import torch

from cpr_tpu.mdp import Compiler as JCompiler
from cpr_tpu.mdp import RTDP as JRTDP
from cpr_tpu.mdp import Explorer as JExplorer
from cpr_tpu.mdp import PTOWrapper as JPTO
from cpr_tpu.mdp import ptmdp as jptmdp
from cpr_tpu.mdp.models import Fc16BitcoinSM as JFc16
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.mdp import RTDP, Compiler, Explorer, PTOWrapper, ptmdp
from cpr_tpu_torch.mdp import explicit as E
from cpr_tpu_torch.mdp.models import Fc16BitcoinSM
from cpr_tpu_torch.mdp.rtdp_graph import rtdp_graph

CPU = "cpu"
TERM = "terminal"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tables(mfl=6, horizon=20):
    kw = dict(alpha=0.3, gamma=0.5, maximum_fork_length=mfl)
    tm = ptmdp(Compiler(Fc16BitcoinSM(**kw)).mdp(),
               horizon=horizon).tensor(device=CPU)
    jt = jptmdp(JCompiler(JFc16(**kw)).mdp(), horizon=horizon).tensor()
    return tm, jt


@pytest.fixture(scope="module")
def small():
    return tables()


def exact_revenue(tm, stop=1e-8):
    vi = tm.value_iteration(stop_delta=stop)
    return vi, tm.start_value(vi["vi_value"]) / tm.start_value(
        vi["vi_progress"])


def test_padded_layout_equals_jax():
    tm, jt = tables(mfl=8)
    Tdst, Tpack, K = tm.padded_layout()
    JTdst, JTpack, JK = jt.padded_layout()
    assert K == JK == tm.max_segment()
    np.testing.assert_array_equal(Tdst.numpy(), np.asarray(JTdst))
    np.testing.assert_array_equal(Tpack.numpy(), np.asarray(JTpack))
    assert tm.padded_layout()[0] is Tdst  # memoized


def test_padded_layout_guard_leaves_rtdp_alone(monkeypatch):
    tm = ptmdp(Compiler(Fc16BitcoinSM(alpha=0.3, gamma=0.5,
                                      maximum_fork_length=5)).mdp(),
               horizon=20).tensor(device=CPU)
    monkeypatch.setenv(E.PAD_BYTES_ENV_VAR, "64")
    with pytest.raises(E.PaddedLayoutTooLarge, match="CPR_MDP_PAD_BYTES"):
        tm.padded_layout()
    # rtdp reads the segment index: no padded copy, no guard
    r = tm.rtdp(rnd.PRNGKey(0, device=CPU), steps=5, batch=4)
    assert np.isfinite(r["rtdp_value"]).all()


def test_rtdp_converges_to_vi():
    # the reference's property (tests/test_device_rtdp.py) at mfl 8
    tm, _ = tables(mfl=8)
    _, exact = exact_revenue(tm)
    r = tm.rtdp(rnd.PRNGKey(1, device=CPU), steps=1500, batch=128,
                eps=0.25)
    est = tm.start_value(r["rtdp_value"]) / tm.start_value(
        r["rtdp_progress"])
    assert abs(est - exact) / exact < 0.02, (est, exact)
    visited = int((r["rtdp_value"] != 0).sum())
    assert 0 < visited < tm.n_states


def test_rtdp_warm_start_at_fixpoint_stays(small):
    tm, _ = small
    vi, _ = exact_revenue(tm, stop=1e-9)
    r = tm.rtdp(rnd.PRNGKey(2, device=CPU), steps=300, batch=64, eps=0.2,
                value0=vi["vi_value"], progress0=vi["vi_progress"])
    assert abs(tm.start_value(r["rtdp_value"])
               - tm.start_value(vi["vi_value"])) < 5e-4


def test_rtdp_graph_result_and_warm_polish(small):
    tm, _ = small
    key = rnd.PRNGKey(4, device=CPU)
    r = rtdp_graph(tm, key, max_steps=300, batch=32, buffer=64, eps=0.5)
    want = E._rtdp_walk(tm, key, graph=True, max_steps=300, batch=32,
                        cap=64, eps=0.5, restart_p=0.5, discount=1.0,
                        stop_delta=0.0, decay=0.95)
    np.testing.assert_array_equal(r["rtdp_visits"], want["visits"].numpy())
    assert r["rtdp_steps"] == want["t"] == 300
    filled = want["buf_pri"].numpy() > 0
    assert filled.any()
    np.testing.assert_array_equal(
        r["rtdp_buffer"], np.where(filled, want["buf_s"].numpy(), -1))
    assert r["rtdp_visits"].sum() == 300 * 32
    # the handoff: chunked VI warm-started from the walkers' table
    _, rev = exact_revenue(tm, stop=1e-6)
    step = E.make_vi_chunk(tm, 1.0)
    v, p, _, delta, it, _ = E.run_chunk_driver(
        step, tm.n_states, torch.float32, tm._cast(1e-6), 1 << 30,
        value0=r["rtdp_value"], prog0=r["rtdp_progress"], device=CPU)
    assert delta <= tm._cast(1e-6)
    warm = tm.start_value(v) / tm.start_value(p)
    assert abs(warm - rev) <= 1e-5, (warm, rev)
    with pytest.raises(ValueError, match="warm start"):
        E.run_chunk_driver(step, tm.n_states, torch.float32, 1e-6, 64,
                           value0=np.zeros(3), device=CPU)


def test_rtdp_refuses_float64():
    tm = ptmdp(Compiler(Fc16BitcoinSM(alpha=0.3, gamma=0.5,
                                      maximum_fork_length=4)).mdp(),
               horizon=20).tensor(torch.float64, device=CPU)
    with pytest.raises(NotImplementedError, match="float32"):
        tm.rtdp(rnd.PRNGKey(0, device=CPU), steps=1, batch=1)


def test_host_rtdp_equals_reference():
    kw = dict(alpha=0.35, gamma=0.6, maximum_fork_length=5)
    agents = []
    for pto, model in ((PTOWrapper, Fc16BitcoinSM), (JPTO, JFc16)):
        rt = RTDP if pto is PTOWrapper else JRTDP
        agent = rt(pto(model(**kw), horizon=15, terminal_state=TERM),
                   eps=0.3, eps_honest=0.2, es=0.2, seed=3)
        agent.run(3000)
        agents.append(agent)
    got, want = agents
    assert got.n_states == want.n_states and got.i == want.i
    assert got.n_episodes == want.n_episodes
    n = got.n_states
    np.testing.assert_array_equal(got.value[:n], want.value[:n])
    np.testing.assert_array_equal(got.count[:n], want.count[:n])
    assert got.start_value_and_progress() == want.start_value_and_progress()
    a, b = got.mdp(), want.mdp()
    for x, y in zip(a["mdp"].arrays(), b["mdp"].arrays()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["policy"], b["policy"])


def test_explorer_equals_reference():
    kw = dict(alpha=0.3, gamma=0.5, maximum_fork_length=6)
    mdps = []
    for pto, model, ex in ((PTOWrapper, Fc16BitcoinSM, Explorer),
                           (JPTO, JFc16, JExplorer)):
        m = pto(model(**kw), horizon=10, terminal_state=TERM)
        e = ex(m, m.honest)
        e.explore_along_policy()
        small = e.mdp()
        e.explore_aside_policy()
        mdps.append((small, e.mdp(), e.policy_actions))
    (s1, b1, pa1), (s2, b2, pa2) = mdps
    assert pa1 == pa2
    for x, y in ((s1, s2), (b1, b2)):
        assert x.n_states == y.n_states
        for c1, c2 in zip(x.arrays(), y.arrays()):
            np.testing.assert_array_equal(c1, c2)
    assert b1.n_states > s1.n_states


def test_measure_rtdp_rows_matches_reference():
    from cpr_tpu.experiments.measure_rtdp import measure_rtdp_rows as j_rows
    from cpr_tpu_torch.experiments.measure_rtdp import (measure_rtdp_rows,
                                                        rtdp_battery)

    kw = dict(horizon=20, step_budgets=(2000, 4000), seed=1)
    rows = measure_rtdp_rows(rtdp_battery(alphas=(0.3,), fork_len=5)[:1],
                             device_batch=32, device=CPU, **kw)
    from cpr_tpu.experiments.measure_rtdp import rtdp_battery as j_battery
    jrows = j_rows(j_battery(alphas=(0.3,), fork_len=5)[:1],
                   device_rtdp=False, **kw)
    assert [r["steps"] for r in rows] == [2000, 4000]
    for got, want in zip(rows, jrows):
        for k in ("model", "steps", "n_states", "rtdp_revenue"):
            assert got[k] == want[k], k
        assert got["vi_revenue"] == pytest.approx(want["vi_revenue"],
                                                  abs=1e-6)
        assert abs(got["device_rtdp_revenue"] - got["vi_revenue"]) < 0.05
