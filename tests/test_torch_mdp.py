"""The port's exact-analysis path against `cpr_tpu`, on the CPU.

Small tables (the FC'16 and AFT'20 bitcoin models at maximum_fork_length
10, the native GhostDAG compile at cutoff 5) go through both packages:
the port's compiler and ptmdp must give identical columns, and the
port's solvers (the plain twins of K4 and K5 here) run on the very same
table as JAX's, built with `convert.tensor_mdp`.

Tolerances: values and progress atol 1e-4, revenue 1e-6, the policy
equal wherever JAX's Q-gap (best minus second-best action value) exceeds
1e-4. Measured: the plain twins add each segment in row order with the
ops XLA:CPU's segment_sum uses, so the while impl and the unaccelerated
chunked impl agree with JAX bit for bit and `vi_iter` is equal. With
Anderson mixing the Gram dots (torch.dot against jnp.vdot) differ in the
last bits, so the two solves take slightly different paths to the
fixpoint: values near 100 (FC'16) differ by up to 1.2e-4, 16 float32
ULP, while the stop rule only certifies a last sweep's delta of 1e-6,
and the sweep count follows the mixing weights' last bits (equal on
these tables here, but at maximum_fork_length 20 the port took 1536
sweeps and JAX 3968 to the same fixpoint), so it is not compared. There
values hold to rtol 1e-5 on top of atol 1e-4; the revenue still to
1e-6. A float32 solve with mixing can also land on a limit cycle of the
rounded sweep whose delta stays above 1e-6 (on the H100, FC'16 at
maximum_fork_length 20: 1.14e-5, 1.5 ULP of values near 100); the
port's driver then restarts from zero and must converge, while JAX's
solves are capped at ACCEL_CAP sweeps.
"""

from __future__ import annotations

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpr_tpu.mdp as J
from cpr_tpu.experiments import measure_mdp as j_measure
from cpr_tpu.mdp import explicit as JE
from cpr_tpu.mdp.generic.native import compile_native as j_compile_native
from cpr_tpu.mdp.models import Aft20BitcoinSM as JAft20
from cpr_tpu.mdp.models import Fc16BitcoinSM as JFc16
from cpr_tpu_torch import convert, telemetry
from cpr_tpu_torch.experiments import measure_mdp
from cpr_tpu_torch.mdp import MDP, Compiler, ptmdp
from cpr_tpu_torch.mdp import explicit as E
from cpr_tpu_torch.mdp.generic import compile_native
from cpr_tpu_torch.mdp.models import Aft20BitcoinSM, Fc16BitcoinSM, map_params

ALPHA, GAMMA, HORIZON = 0.3, 0.5, 100
ATOL, REV_TOL, GAP = 1e-4, 1e-6, 1e-4
ACCEL_CAP = 6400
CPU = "cpu"


def both_tables(model: str, mfl: int = 10):
    """(port MDP, JAX MDP, port Compiler or None) of one PT table."""
    if model == "gd5":
        kw = dict(k=2, alpha=ALPHA, gamma=GAMMA, collect_garbage="simple",
                  dag_size_cutoff=5)
        return (ptmdp(compile_native("ghostdag", **kw), horizon=HORIZON),
                J.ptmdp(j_compile_native("ghostdag", **kw), horizon=HORIZON),
                None)
    port_cls, jax_cls = {"fc16": (Fc16BitcoinSM, JFc16),
                         "aft20": (Aft20BitcoinSM, JAft20)}[model]
    kw = dict(alpha=ALPHA, gamma=GAMMA, maximum_fork_length=mfl)
    c = Compiler(port_cls(**kw))
    return (ptmdp(c.mdp(), horizon=HORIZON),
            J.ptmdp(J.Compiler(jax_cls(**kw)).mdp(), horizon=HORIZON), c)


def same_table(jt):
    """The port's TensorMDP over the JAX TensorMDP's arrays."""
    return convert.tensor_mdp(
        jt.n_states, jt.n_actions,
        *(np.asarray(getattr(jt, f)) for f in (
            "start", "src", "act", "dst", "prob", "reward", "progress")),
        device=CPU)


def q_gap(jt, value):
    src, act, dst, prob, reward, _ = jt._numpy()
    S, A = jt.n_states, jt.n_actions
    q = np.zeros(S * A)
    key = src.astype(np.int64) * A + act
    np.add.at(q, key, prob * (reward + np.asarray(value, np.float64)[dst]))
    present = np.zeros(S * A, bool)
    present[key] = True
    q = -np.sort(-np.where(present, q, -np.inf).reshape(S, A), axis=1)
    with np.errstate(invalid="ignore"):  # action-less states: nan, not sure
        return q[:, 0] - q[:, 1]


def revenue(tm, value, progress):
    return tm.start_value(value) / tm.start_value(progress)


def assert_vi_close(got, want, tm, jt, rtol=0.0):
    np.testing.assert_allclose(got["vi_value"], want["vi_value"], atol=ATOL,
                               rtol=rtol)
    np.testing.assert_allclose(got["vi_progress"], want["vi_progress"],
                               atol=ATOL, rtol=rtol)
    sure = q_gap(jt, want["vi_value"]) > GAP
    np.testing.assert_array_equal(got["vi_policy"][sure],
                                  np.asarray(want["vi_policy"])[sure])
    assert abs(revenue(tm, got["vi_value"], got["vi_progress"])
               - revenue(jt, want["vi_value"], want["vi_progress"])) \
        <= REV_TOL


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain twins run thousands of sweeps of small ops; beside the
    suite's other workers an intra-op thread pool only contends."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["fc16", "aft20", "gd5"])
def tables(request):
    port, ref, c = both_tables(request.param)
    return port, ref, same_table(ref.tensor()), ref.tensor(), c


@pytest.mark.parametrize("model", ["fc16", "aft20"])
def test_compiler_and_ptmdp_columns_identical(model):
    port, ref, c = both_tables(model)
    for got, want in zip(port.arrays(), ref.arrays()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert port.start == ref.start
    assert (port.n_states, port.n_actions) == (ref.n_states, ref.n_actions)
    assert port.check() and port.check_dense()


@pytest.mark.parametrize("impl", ["while", "chunked"])
def test_value_iteration_matches_reference(tables, impl):
    _, _, tm, jt, _ = tables
    got = tm.value_iteration(stop_delta=1e-6, impl=impl)
    want = jt.value_iteration(stop_delta=1e-6, impl=impl)
    assert_vi_close(got, want, tm, jt)
    assert got["vi_iter"] == want["vi_iter"]
    np.testing.assert_array_equal(got["vi_value"], want["vi_value"])
    np.testing.assert_allclose(got["vi_residuals"], want["vi_residuals"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["while", "chunked"])
def test_fixed_sweep_count(tables, impl):
    _, _, tm, jt, _ = tables
    got = tm.value_iteration(max_iter=7, impl=impl)
    want = jt.value_iteration(max_iter=7, impl=impl)
    assert got["vi_iter"] == want["vi_iter"] == 7
    np.testing.assert_array_equal(got["vi_value"], want["vi_value"])
    np.testing.assert_array_equal(got["vi_policy"], want["vi_policy"])
    assert got["vi_delta"] == pytest.approx(want["vi_delta"], abs=0)


def test_anderson_mixing_matches_reference(tables):
    _, _, tm, jt, _ = tables
    got = E.vi_chunked(tm, 1.0, tm._cast(1e-6), ACCEL_CAP, accel_m=3)
    assert got[3] <= 1e-6
    want = JE.vi_chunked(jt.src, jt.act, jt.dst, jt.prob, jt.reward,
                         jt.progress, jt.n_states, jt.n_actions,
                         jnp.float32(1.0), jnp.float32(1e-6), ACCEL_CAP,
                         accel_m=3)
    assert_vi_close(
        dict(vi_value=got[0].numpy(), vi_progress=got[1].numpy(),
             vi_policy=got[2].numpy()),
        dict(vi_value=np.asarray(want[0]), vi_progress=np.asarray(want[1]),
             vi_policy=np.asarray(want[2])), tm, jt, rtol=1e-5)
    plain = tm.value_iteration(stop_delta=1e-6, impl="chunked")
    assert got[4] < plain["vi_iter"]


def test_anderson_mixing_leaves_a_limit_cycle(monkeypatch):
    """Mixing that lands on a limit cycle of the rounded float32 sweep
    (found here by perturbing FC'16's fixpoint at maximum_fork_length 20
    by up to 8 ULP: plain sweeps from there keep a delta of a few ULP)
    stalls the delta; after ACCEL_STALLS chunks without a new lowest
    delta the driver restarts from zero and ends on the plain chunked
    solve's values, bit for bit. Dropping the history alone would leave
    the iterate on the cycle."""
    port, _, _ = both_tables("fc16", mfl=20)
    tm = port.tensor(torch.float32, device=CPU)
    vi = tm.value_iteration(stop_delta=1e-6)
    x = vi["vi_value"]
    rng = np.random.default_rng(3)
    cyc_v = torch.from_numpy(
        (x + np.spacing(np.abs(x)) * rng.integers(-8, 9, x.shape[0]))
        .astype(np.float32))
    cyc_p = torch.from_numpy(vi["vi_progress"])
    step = E.make_vi_chunk(tm, 1.0)
    v, p, _, deltas = step(cyc_v, cyc_p, 256)
    assert float(deltas[-64:].min()) > 1e-6  # plain sweeps stay on it
    monkeypatch.setattr(E, "_anderson_mix", lambda hist: (cyc_v, cyc_p))
    got = E.vi_chunked(tm, 1.0, tm._cast(1e-6), ACCEL_CAP, accel_m=3)
    plain = tm.value_iteration(stop_delta=1e-6, impl="chunked")
    assert got[3] <= 1e-6
    np.testing.assert_array_equal(got[0].numpy(), plain["vi_value"])
    np.testing.assert_array_equal(got[1].numpy(), plain["vi_progress"])
    # two chunks fill the history, the first from the cycle still lowers
    # the delta, then ACCEL_STALLS chunks do not; then the plain solve
    assert got[4] == plain["vi_iter"] + 64 * (3 + E.ACCEL_STALLS)


def test_discounted_eps_rule_matches_reference(tables):
    _, _, tm, jt, _ = tables
    got = tm.value_iteration(discount=0.9, eps=1e-3)
    want = jt.value_iteration(discount=0.9, eps=1e-3)
    assert got["vi_stop_delta"] == pytest.approx(1e-3 * 0.1 / 0.9)
    assert got["vi_iter"] == want["vi_iter"]
    assert_vi_close(got, want, tm, jt)


def test_stop_rule_guards(tables):
    _, _, tm, jt, _ = tables
    for t in (tm, jt):
        with pytest.raises(ValueError, match="undefined at discount=1"):
            t.value_iteration(eps=1e-3)
        with pytest.raises(ValueError, match="need eps, stop_delta"):
            t.value_iteration()
        with pytest.raises(ValueError, match="unknown VI impl 'jacobi'"):
            t.value_iteration(stop_delta=1e-3, impl="jacobi")


def test_vi_impl_env_var(tables, monkeypatch):
    _, _, tm, _, _ = tables
    monkeypatch.setenv("CPR_VI_IMPL", "chunked")
    assert E.resolve_vi_impl(None) == "chunked"
    assert tm.value_iteration(max_iter=3)["vi_iter"] == 3
    monkeypatch.setenv("CPR_VI_IMPL", "bogus")
    with pytest.raises(ValueError, match="unknown VI impl 'bogus'"):
        tm.value_iteration(max_iter=3)


def test_policy_evaluation_matches_reference(tables):
    _, _, tm, jt, _ = tables
    policy = jt.value_iteration(stop_delta=1e-6)["vi_policy"]
    got = tm.policy_evaluation(policy, theta=1e-6)
    want = jt.policy_evaluation(policy, theta=1e-6)
    assert got["pe_iter"] == want["pe_iter"]
    np.testing.assert_allclose(got["pe_reward"], want["pe_reward"], atol=ATOL)
    np.testing.assert_allclose(got["pe_progress"], want["pe_progress"],
                               atol=ATOL)
    short = tm.policy_evaluation(policy, theta=1e-6, max_iter=3)
    assert short["pe_iter"] == jt.policy_evaluation(
        policy, theta=1e-6, max_iter=3)["pe_iter"] == 3
    none = tm.policy_evaluation(policy, theta=1e-6, max_iter=0)
    assert none["pe_iter"] == 0 and not none["pe_reward"].any()


@pytest.mark.parametrize("model", ["fc16", "aft20"])
def test_honest_policy_evaluation_yields_alpha(model):
    # revenue of the honest policy is alpha (within 1e-6, in float64)
    port, _, c = both_tables(model)
    tm = port.tensor(torch.float64, device=CPU)
    policy = np.full(port.n_states, -1, np.int32)
    for sid, st in enumerate(c.states):
        policy[sid] = c.action_map[sid].index(c.model.honest(st))
    pe = tm.policy_evaluation(policy, theta=1e-10)
    assert revenue(tm, pe["pe_reward"], pe["pe_progress"]) == \
        pytest.approx(ALPHA, abs=1e-6)


def test_steady_state_matches_reference(tables):
    _, _, tm, jt, _ = tables
    policy = jt.value_iteration(stop_delta=1e-6)["vi_policy"]
    start = int(np.flatnonzero(np.asarray(jt.start))[0])
    got = tm.steady_state(policy, start_state=start)
    want = jt.steady_state(policy, start_state=start)
    assert got["ss_reachable"] == want["ss_reachable"]
    np.testing.assert_allclose(got["ss"], want["ss"], atol=1e-9)
    assert tm.reachable_states(policy) == jt.reachable_states(policy)


def test_measure_rows_matches_reference():
    alphas, mfl, cutoff = (0.25, 0.4), 8, 5
    battery = measure_mdp.model_battery(alphas, GAMMA, generic_cutoff=cutoff,
                                        mfl=mfl)
    jbattery = []
    for a in alphas:
        jbattery += [
            (f"fc16-{a}", lambda a=a: JFc16(alpha=a, gamma=GAMMA,
                                            maximum_fork_length=mfl)),
            (f"aft20-{a}", lambda a=a: JAft20(alpha=a, gamma=GAMMA,
                                              maximum_fork_length=mfl))]
        for proto, k in (("bitcoin", 0), ("ghostdag", 2)):
            jbattery.append((f"generic-{proto}-{a}",
                             lambda a=a, proto=proto, k=k: j_compile_native(
                                 proto, k=k, alpha=a, gamma=GAMMA,
                                 collect_garbage="simple",
                                 dag_size_cutoff=cutoff)))
    assert [n for n, _ in battery] == [n for n, _ in jbattery]
    rows = measure_mdp.measure_rows(battery, device=CPU)
    jrows = j_measure.measure_rows(jbattery)
    for got, want in zip(rows, jrows):
        assert set(got) == set(want)
        for k in ("model", "n_states", "n_transitions", "vi_iter"):
            assert got[k] == want[k], k
        assert got["revenue"] == pytest.approx(want["revenue"], abs=REV_TOL)
        assert got["revenue"] >= float(got["model"].rsplit("-", 1)[1]) - 1e-4
    capped = measure_mdp.measure_rows(battery[:1], max_transitions=10,
                                      device=CPU)
    assert capped[0]["skipped"] == "transition cap"
    assert measure_mdp.battery_groups() == j_measure.battery_groups()


def test_unported_options_raise(tables):
    from cpr_tpu_torch.mdp import grid as G
    _, _, tm, _, _ = tables
    with pytest.raises(NotImplementedError, match="item 6"):
        tm.value_iteration(stop_delta=1e-3, impl="chunked",
                           checkpoint_path="vi.ckpt")
    with pytest.raises(NotImplementedError, match="item 6"):
        E.run_grid_chunk_driver(None, None, 1, 1, torch.float32, 1e-3, 1,
                                checkpoint_path="grid.ckpt")
    # the mesh= paths are ported (K16): they take a mesh and refuse what
    # the reference refuses
    from cpr_tpu_torch.parallel import (default_mesh,
                                        sharded_state_value_iteration)
    mesh = default_mesh(devices=[CPU] * 2)
    assert measure_mdp.measure_rows([], mesh=mesh) == []
    assert measure_mdp.measure_rows_grid([], mesh=mesh) == []
    with pytest.raises(ValueError, match="2-D mesh"):
        G.grid_value_iteration(None, (0.3,), (0.5,), state_axis="s")
    # rtdp_sharded_polish polishes on the state-sharded chunked solve,
    # which refuses the while impl by name
    with pytest.raises(ValueError, match="impl='chunked'"):
        sharded_state_value_iteration(tm, mesh, impl="while",
                                      stop_delta=1e-3)
    with pytest.raises(NotImplementedError, match="item 7c"):
        measure_mdp.model_battery(native=False)
    with pytest.raises(NotImplementedError, match="item 7c"):
        G.compile_protocol("ghostdag", cutoff=3)


def test_sweep_layout_indexes_segments(tables):
    _, _, tm, jt, _ = tables
    S, A = tm.n_states, tm.n_actions
    key = tm.src.long() * A + tm.act
    assert bool((key[1:] >= key[:-1]).all())
    seg_ptr, state_seg = tm.seg_ptr.long(), tm.state_seg.long()
    assert int(seg_ptr[0]) == 0 and int(seg_ptr[-1]) == key.numel()
    first = key[seg_ptr[:-1]]
    assert torch.equal(first // A, torch.repeat_interleave(
        torch.arange(S), state_seg[1:] - state_seg[:-1]))
    assert torch.equal(first % A, tm.seg_act.long())
    valid, _ = E._valid_actions(tm.src, tm.act, tm.prob, S, A)
    assert torch.equal(valid.reshape(-1)[first], tm.seg_valid.bool())
    # the stable sort keeps each segment's rows in compiled order
    src, act = (torch.from_numpy(np.array(c, np.int64))
                for c in (jt.src, jt.act))
    order = torch.argsort(src * A + act, stable=True)
    assert torch.equal(tm.dst, torch.from_numpy(
        np.array(jt.dst, np.int32))[order])


def test_residual_and_memory_events(tables):
    _, _, tm, _, _ = tables
    sink = io.StringIO()
    telemetry.configure(stream=sink)
    try:
        vi = tm.value_iteration(stop_delta=1e-6, impl="chunked")
        tm.value_iteration(max_iter=600)
    finally:
        telemetry.configure(None)
    events = [json.loads(line) for line in sink.getvalue().splitlines()]
    names = [e["name"] for e in events]
    assert names == ["memory", "vi_residuals", "vi_residuals"]
    mem, chunked, ring = events
    assert mem["scope"] == "vi" and mem["source"] in ("rss", "device")
    assert mem["peak_bytes"] > 0 and mem["predicted_bytes"] > 0
    assert chunked["n_sweeps"] == vi["vi_iter"]
    assert chunked["truncated"] == (vi["vi_iter"] > E.VI_RESID_LEN)
    assert len(chunked["residuals"]) == min(vi["vi_iter"], E.VI_RESID_LEN)
    assert chunked["residuals"][-1] == chunked["final_delta"] <= 1e-6
    assert ring["n_sweeps"] == 600 and ring["truncated"]
    assert len(ring["residuals"]) == E.VI_RESID_LEN
    np.testing.assert_array_equal(
        E.ring_residuals(np.arange(4.0), 6), [2.0, 3.0, 0.0, 1.0])


def test_map_params_matches_reference():
    m = Compiler(Fc16BitcoinSM(alpha=0.125, gamma=0.25,
                               maximum_fork_length=6)).mdp()
    jm = J.Compiler(JFc16(alpha=0.125, gamma=0.25,
                          maximum_fork_length=6)).mdp()
    from cpr_tpu.mdp.models import map_params as j_map_params
    got = map_params(m, alpha=0.3, gamma=0.5)
    want = j_map_params(jm, alpha=0.3, gamma=0.5)
    for a, b in zip(got.arrays(), want.arrays()):
        np.testing.assert_array_equal(a, b)
    assert isinstance(got, MDP) and got.start == want.start


def test_float64_solves_agree_with_float32(tables):
    port, _, tm32, _, _ = tables
    tm64 = port.tensor(torch.float64, device=CPU)
    assert tm64.prob.dtype == torch.float64
    a = tm64.value_iteration(stop_delta=1e-6)
    b = tm64.value_iteration(stop_delta=1e-6, impl="chunked")
    c = tm32.value_iteration(stop_delta=1e-6)
    for other in (b, c):
        assert revenue(tm64, a["vi_value"], a["vi_progress"]) == \
            pytest.approx(revenue(tm64, other["vi_value"],
                                  other["vi_progress"]), abs=1e-5)


def test_span_events_nest_and_rate():
    sink = io.StringIO()
    tele = telemetry.Telemetry(stream=sink)
    with tele.span("solve", sweeps=10) as outer:
        with tele.span("chunk"):
            outer.fence(torch.zeros(3))  # a CPU tensor: no card to fence
    inner, outer_ev = [json.loads(line)
                       for line in sink.getvalue().splitlines()]
    assert (inner["path"], inner["depth"]) == ("solve/chunk", 1)
    assert outer_ev["path"] == "solve" and outer_ev["per_sec"]["sweeps"] > 0
    assert outer_ev["dur_s"] >= inner["dur_s"] >= 0
