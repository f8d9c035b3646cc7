"""The port's state-sharded solvers (`cpr_tpu_torch.parallel.state_shard`,
the plain twins of K16-state and K16-grid) against `cpr_tpu` on the CPU.

The reference runs its sharded functions on the conftest's forced host
devices (`jax.devices()[:n]`, as tests/test_state_shard.py does); the
port runs on `default_mesh(devices=["cpu"] * n)`. Both solve the very
same tables: the reference's TensorMDP arrays, through
`convert.tensor_mdp`.

Tolerance: none. The partition's columns, slot map and t_blk are held
array for array; the state-sharded fixpoint (value, progress, policy,
sweep count and residuals) bit for bit against `cpr_tpu`'s at 4 shards
and against the port's own single-device chunked solve at 1 and 4 (the
tables: FC'16 and AFT'20 at cutoff 6, horizon 20, and a GhostDAG compile
at cutoff 5, horizon 10, those of tests/test_state_shard.py:177); grid x
state at 2 x 2 bit for bit against `cpr_tpu` and the port's 1-D grid
solve. The RTDP handoff, whose walks follow XLA's default optimization
level and not the suite's, is held as the reference's test holds it: to
the cold fixpoint within 1e-5.

`python tests/test_torch_state_shard.py` writes the fixture
`tests/fixtures/torch_port_shard_golden.npz` (`cpr_tpu`'s tables and
results for these cases and the transition-sharded solves of
tests/test_torch_parallel.py's tables), which `chip_smoke.py` phase 80
replays through the kernels on the card, where jax is absent;
`test_fixture_is_current` checks it against the live reference.
"""

from __future__ import annotations

import hashlib
import io
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_shard_golden.npz")
ALPHA, GAMMA = 0.35, 0.5
TABLES = ("fc16", "aft20", "gd5")
GRID_ALPHAS, GRID_GAMMAS = (0.3, 0.4), (0.25, 0.75)
STOP = 1e-6
# the handoff's walk: the reference test's 2000 steps of 128 walkers take
# ~90 s through the plain twin of K6 on one CPU core
RTDP_STEPS, RTDP_BATCH = 300, 64
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_pm(model):
    from cpr_tpu.mdp.grid import compile_protocol, param_ptmdp
    return param_ptmdp(compile_protocol(model, cutoff=6), horizon=20)


def ref_table(name):
    """The reference's float32 TensorMDP of one of TABLES."""
    import jax.numpy as jnp

    from cpr_tpu.mdp.explicit import MDP, ptmdp
    if name == "gd5":
        from cpr_tpu.mdp.generic.native import compile_native
        table = compile_native("ghostdag", k=2, alpha=ALPHA, gamma=GAMMA,
                               collect_garbage="simple", dag_size_cutoff=5)
        return ptmdp(table, horizon=10).tensor(jnp.float32)
    pm = ref_pm(name)
    m = pm.mdp
    sv = pm._monomial(pm.start_coef, pm.start_expo, ALPHA, GAMMA)
    return MDP(n_states=m.n_states, n_actions=m.n_actions,
               start={int(s): float(v) for s, v in zip(pm.start_ids, sv)},
               src=m.src, act=m.act, dst=m.dst,
               prob=pm.revalue(ALPHA, GAMMA), reward=m.reward,
               progress=m.progress).tensor(jnp.float32)


def table_arrays(jt):
    return {f: np.asarray(getattr(jt, f)) for f in (
        "start", "src", "act", "dst", "prob", "reward", "progress")}


def port_table(arrays, S, A, device=CPU):
    from cpr_tpu_torch import convert
    return convert.tensor_mdp(S, A, *(arrays[f] for f in (
        "start", "src", "act", "dst", "prob", "reward", "progress")),
        device=device)


def ref_mesh(n):
    import jax

    from cpr_tpu.parallel import default_mesh
    return default_mesh(devices=jax.devices()[:n])


def ref_grid_mesh():
    import jax
    return jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("g", "s"))


def port_mesh(n):
    from cpr_tpu_torch.parallel import default_mesh
    return default_mesh(devices=[CPU] * n)


def port_grid_mesh():
    from cpr_tpu_torch.parallel import Mesh
    return Mesh(np.array([[CPU] * 2] * 2, dtype=object), ("g", "s"))


def digest(*arrays):
    h = hashlib.sha256()
    for x in arrays:
        h.update(np.ascontiguousarray(x).tobytes())
    return np.frombuffer(h.digest(), np.uint8)


@pytest.fixture(scope="module")
def tables():
    """name -> (reference TensorMDP, port TensorMDP)."""
    out = {}
    for name in TABLES:
        jt = ref_table(name)
        out[name] = (jt, port_table(table_arrays(jt), jt.n_states,
                                    jt.n_actions))
    return out


@pytest.fixture(scope="module")
def ref_state(tables):
    """cpr_tpu's state-sharded solve of each table at 4 shards."""
    from cpr_tpu.parallel import sharded_state_value_iteration
    return {name: sharded_state_value_iteration(
        jt, ref_mesh(4), stop_delta=STOP, pad_states=True)
        for name, (jt, _) in tables.items()}


@pytest.fixture(scope="module")
def ref_grid():
    from cpr_tpu.mdp.grid import grid_value_iteration
    return grid_value_iteration(ref_pm("aft20"), GRID_ALPHAS, GRID_GAMMAS,
                                stop_delta=STOP, mesh=ref_grid_mesh(),
                                axis="g", state_axis="s")


def port_pm(model):
    from cpr_tpu_torch.mdp.grid import compile_protocol, param_ptmdp
    return param_ptmdp(compile_protocol(model, cutoff=6), horizon=20)


# -- the partition -----------------------------------------------------------


@pytest.mark.parametrize("name", TABLES)
def test_partition_matches_reference(tables, name):
    """Columns, slot map and t_blk equal to the reference's on its own
    (compiled-order, so the argsort path) columns, and on the port's
    sorted table (the split path) a round trip with inert padding."""
    from cpr_tpu.parallel import partition_by_state_block as j_partition
    from cpr_tpu_torch.parallel import partition_by_state_block
    jt, tm = tables[name]
    cols = types.SimpleNamespace(n_states=jt.n_states, **{
        f: np.asarray(getattr(jt, f)) for f in (
            "src", "act", "dst", "prob", "reward", "progress")})
    S = jt.n_states
    for n in (1, 2, 4):
        for S_pad in ((S + (-S % n),) if S % n else (None, S + n)):
            got = partition_by_state_block(cols, n, S_pad)
            want = j_partition(jt, n, S_pad)
            for g, w in zip(got[0], want[0]):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2] == want[2]
            (src_l, *rest), slot, t_blk = partition_by_state_block(
                tm, n, S_pad)
            s_blk = (S_pad or S) // n
            src = tm.src.numpy().astype(np.int64)
            np.testing.assert_array_equal(
                src_l[slot] + (src // s_blk) * s_blk, src)
            pad = np.ones(n * t_blk, bool)
            pad[slot] = False
            assert (src_l[pad] == s_blk).all() and (rest[2][pad] == 0).all()


def test_partition_refuses_uneven_and_short_pad(tables):
    from cpr_tpu_torch.parallel import partition_by_state_block
    tm = tables["fc16"][1]
    assert tm.n_states == 89
    with pytest.raises(ValueError, match="cannot shard 89 states"):
        partition_by_state_block(tm, 4)
    with pytest.raises(ValueError, match="cannot shard 88 states"):
        partition_by_state_block(tm, 4, S_pad=88)


@pytest.mark.parametrize("S,n", [(100, 1), (100, 4), (92, 4), (94, 2)])
def test_halo_bytes_match_reference(S, n):
    from cpr_tpu.parallel import state_halo_bytes as j_halo
    from cpr_tpu_torch.parallel import state_halo_bytes
    for dt in (np.float32, np.float64):
        assert state_halo_bytes(S, n, dt) == j_halo(S, n, dt)
    assert state_halo_bytes(S, n, torch.float32) == j_halo(S, n, np.float32)


# -- refusals ------------------------------------------------------------------


def test_refusals_name_their_values(tables):
    from cpr_tpu_torch.mdp.grid import grid_value_iteration
    from cpr_tpu_torch.parallel import (Mesh, make_grid_state_chunk_step,
                                        sharded_state_value_iteration)
    tm = tables["fc16"][1]
    with pytest.raises(ValueError, match=r"cannot shard 89 states"):
        sharded_state_value_iteration(tm, port_mesh(4), stop_delta=STOP)
    with pytest.raises(ValueError, match="impl='chunked'"):
        sharded_state_value_iteration(tm, port_mesh(1), impl="while",
                                      stop_delta=STOP)
    T = tm.src.shape[0]
    wide = Mesh(np.array([[CPU] * 4] * 2, dtype=object), ("g", "s"))
    with pytest.raises(ValueError, match=r"cannot shard 89 states"):
        make_grid_state_chunk_step(tm, 4, np.zeros((4, T), np.float32),
                                   discount=1.0, mesh=wide)
    with pytest.raises(ValueError, match=r"cannot shard 3 grid points"):
        make_grid_state_chunk_step(tm, 3, np.zeros((3, T), np.float32),
                                   discount=1.0, mesh=port_grid_mesh())
    pm = port_pm("fc16")
    with pytest.raises(ValueError, match=r"cannot shard 89 states"):
        grid_value_iteration(pm, (0.25, 0.4), (0.5,), stop_delta=STOP,
                             mesh=port_grid_mesh(), axis="g",
                             state_axis="s")
    with pytest.raises(ValueError, match="2-D mesh"):
        grid_value_iteration(pm, (0.25,), (0.5,), stop_delta=STOP,
                             mesh=None, state_axis="s", device=CPU)


# -- bit identity --------------------------------------------------------------


@pytest.mark.parametrize("name", TABLES)
def test_state_sharded_bit_identical(tables, ref_state, name):
    """At 1 and 4 shards (padded where 4 does not divide S) the port's
    sharded solve equals cpr_tpu's and the port's own chunked solve bit
    for bit, sweep count and residuals included."""
    from cpr_tpu_torch.parallel import (sharded_state_value_iteration,
                                        state_halo_bytes)
    _, tm = tables[name]
    want = ref_state[name]
    solo = tm.value_iteration(stop_delta=STOP, impl="chunked")
    for n in (1, 4):
        got = sharded_state_value_iteration(tm, port_mesh(n),
                                            stop_delta=STOP, pad_states=True)
        assert got["vi_iter"] == want["vi_iter"] == solo["vi_iter"]
        for k in ("vi_value", "vi_progress", "vi_policy", "vi_residuals"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
            np.testing.assert_array_equal(got[k], solo[k], k)
        S = tm.n_states
        assert got["vi_state_shards"] == n
        assert got["vi_halo_bytes"] == state_halo_bytes(S + (-S % n), n,
                                                        np.float32)
    if tm.n_states % 2 == 0:  # aft20: 94 states, no padding at 2
        got = sharded_state_value_iteration(tm, port_mesh(2),
                                            stop_delta=STOP)
        np.testing.assert_array_equal(got["vi_value"], solo["vi_value"])
        assert got["vi_iter"] == solo["vi_iter"]


def test_grid_state_2x2_bit_identical(ref_grid):
    """The grid x state 2-D mesh equals cpr_tpu's and the port's 1-D grid
    solve bit for bit: per-point fixpoints, freeze sweeps, sweep count."""
    from cpr_tpu_torch.mdp.grid import grid_value_iteration
    pm = port_pm("aft20")
    got = grid_value_iteration(pm, GRID_ALPHAS, GRID_GAMMAS,
                               stop_delta=STOP, mesh=port_grid_mesh(),
                               axis="g", state_axis="s")
    solo = grid_value_iteration(pm, GRID_ALPHAS, GRID_GAMMAS,
                                stop_delta=STOP, device=CPU)
    assert got["vi_iter"] == ref_grid["vi_iter"] == solo["vi_iter"]
    for k in ("grid_value", "grid_progress", "grid_policy", "grid_iter",
              "vi_residuals", "grid_revenue"):
        np.testing.assert_array_equal(got[k], np.asarray(ref_grid[k]), k)
        np.testing.assert_array_equal(got[k], solo[k], k)


def test_rtdp_sharded_polish_handoff(tables):
    """Explore, then polish sharded: the handoff reaches the cold
    fixpoint within 1e-5 in no more sweeps, with the rtdp_* entries, as
    cpr_tpu's does (tests/test_state_shard.py:355)."""
    import jax

    from cpr_tpu.mdp.rtdp_graph import rtdp_sharded_polish as j_polish
    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.mdp.rtdp_graph import rtdp_sharded_polish
    jt, tm = tables["fc16"]
    cold = tm.value_iteration(stop_delta=1e-7, impl="chunked")
    vi = rtdp_sharded_polish(tm, port_mesh(4), rnd.PRNGKey(0, device=CPU),
                             rtdp_steps=RTDP_STEPS, batch=RTDP_BATCH,
                             stop_delta=1e-7, pad_states=True)
    assert vi["vi_iter"] <= cold["vi_iter"]
    assert np.allclose(vi["vi_value"], cold["vi_value"], atol=1e-5)
    assert vi["vi_state_shards"] == 4
    assert vi["rtdp_steps"] == RTDP_STEPS and vi["rtdp_batch"] == RTDP_BATCH
    want = j_polish(jt, ref_mesh(4), jax.random.PRNGKey(0),
                    rtdp_steps=RTDP_STEPS, batch=RTDP_BATCH,
                    stop_delta=1e-7, pad_states=True)
    assert np.allclose(vi["vi_value"], np.asarray(want["vi_value"]),
                       atol=1e-5)


def test_working_set_guard_names_the_sharded_solver(tables, monkeypatch):
    """A CPR_VI_BYTES ceiling between the 4-shard and single-device
    working sets: the single-device solve refuses by name, naming the
    port's state-sharded solver, which completes it (the fixpoint of an
    unguarded solve), as tests/test_state_shard.py:258 shows for
    cpr_tpu."""
    from cpr_tpu_torch.mdp.explicit import (ViWorkingSetTooLarge,
                                            vi_working_set_bytes)
    from cpr_tpu_torch.parallel import (partition_by_state_block,
                                        sharded_state_value_iteration)
    tm = tables["gd5"][1]
    S, A, T, n = tm.n_states, tm.n_actions, int(tm.src.shape[0]), 4
    S_pad = S + (-S % n)
    _, _, t_blk = partition_by_state_block(tm, n, S_pad)
    single = vi_working_set_bytes(T, S, A, tm.prob.dtype)
    sharded = vi_working_set_bytes(t_blk, S_pad, A, tm.prob.dtype, shards=n)
    assert sharded < single
    monkeypatch.setenv("CPR_VI_BYTES", str((sharded + single) // 2))
    with pytest.raises(ViWorkingSetTooLarge, match="CPR_VI_BYTES") as ei:
        tm.value_iteration(stop_delta=STOP, impl="chunked")
    assert ("cpr_tpu_torch.parallel.sharded_state_value_iteration"
            in str(ei.value))
    got = sharded_state_value_iteration(tm, port_mesh(n), stop_delta=STOP,
                                        pad_states=True)
    monkeypatch.delenv("CPR_VI_BYTES")
    ref = tm.value_iteration(stop_delta=STOP, impl="chunked")
    for k in ("vi_value", "vi_progress", "vi_policy"):
        np.testing.assert_array_equal(got[k], ref[k])


def test_solve_event_carries_shard_extras(tables):
    from cpr_tpu_torch import telemetry
    from cpr_tpu_torch.parallel import sharded_state_value_iteration
    sink = io.StringIO()
    telemetry.configure(stream=sink)
    try:
        sharded_state_value_iteration(tables["fc16"][1], port_mesh(4),
                                      stop_delta=STOP, pad_states=True,
                                      protocol="fc16", cutoff=6)
    finally:
        telemetry.configure(None)
    events = [json.loads(line) for line in sink.getvalue().splitlines()]
    (ev,) = [e for e in events if e.get("name") == "mdp_solve"]
    assert ev["protocol"] == "fc16" and ev["cutoff"] == 6
    assert ev["state_shards"] == 4 and ev["n_devices"] == 4
    assert ev["halo_bytes"] > 0 and ev["states_per_sec"] > 0
    assert ev["sweeps"] > 0 and ev["converged"] == 1


# -- the fixture the smoke replays on the card ---------------------------------


def build_golden(tables=None, ref_state=None, ref_grid=None, psum=None):
    """cpr_tpu's tables and results: the state-sharded solves at 4
    shards, the grid x state solve, the transition-sharded solves of
    tests/test_torch_parallel.py's tables at 4 shards."""
    from cpr_tpu.parallel import sharded_value_iteration
    import test_torch_parallel as tp

    out = {}
    for name in TABLES:
        jt = tables[name][0] if tables else ref_table(name)
        for f, a in table_arrays(jt).items():
            out[f"{name}_{f}"] = a
        out[f"{name}_shape"] = np.array([jt.n_states, jt.n_actions])
        r = ref_state[name] if ref_state else None
        if r is None:
            from cpr_tpu.parallel import sharded_state_value_iteration
            r = sharded_state_value_iteration(jt, ref_mesh(4),
                                              stop_delta=STOP,
                                              pad_states=True)
        for k in ("value", "progress", "policy", "iter", "residuals"):
            out[f"{name}_state_{k}"] = np.asarray(r[f"vi_{k}"])
    pm = ref_pm("aft20")
    out["grid_digest"] = digest(*pm.mdp.arrays(), pm.coef, pm.expo,
                                pm.start_ids, pm.start_coef, pm.start_expo)
    g = ref_grid
    if g is None:
        from cpr_tpu.mdp.grid import grid_value_iteration
        g = grid_value_iteration(pm, GRID_ALPHAS, GRID_GAMMAS,
                                 stop_delta=STOP, mesh=ref_grid_mesh(),
                                 axis="g", state_axis="s")
    for k in ("grid_value", "grid_progress", "grid_policy", "grid_iter",
              "vi_residuals"):
        out[f"grid_{k}"] = np.asarray(g[k])
    out["grid_vi_iter"] = np.array(g["vi_iter"])
    for name in tp.PSUM_TABLES:
        jt = tp.ref_psum_table(name)
        for f, a in table_arrays(jt).items():
            out[f"psum_{name}_{f}"] = a
        out[f"psum_{name}_shape"] = np.array([jt.n_states, jt.n_actions])
        out[f"psum_{name}_gap"] = tp.q_gap(jt)
        for impl in ("while", "chunked"):
            r = (psum or {}).get((name, impl)) or sharded_value_iteration(
                jt, ref_mesh(4), stop_delta=tp.PSUM_STOP, impl=impl)
            for k in ("value", "progress", "policy", "iter"):
                out[f"psum_{name}_{impl}_{k}"] = np.asarray(r[f"vi_{k}"])
    return out


def test_fixture_is_current(tables, ref_state, ref_grid):
    """The committed fixture holds what cpr_tpu computes now for the
    state and grid cases (the transition-sharded ones are held in
    tests/test_torch_parallel.py)."""
    with np.load(FIXTURE) as f:
        fx = {k: f[k] for k in f.files}
    for name in TABLES:
        for f, a in table_arrays(tables[name][0]).items():
            np.testing.assert_array_equal(fx[f"{name}_{f}"], a)
        for k in ("value", "progress", "policy", "iter", "residuals"):
            np.testing.assert_array_equal(
                fx[f"{name}_state_{k}"],
                np.asarray(ref_state[name][f"vi_{k}"]), f"{name} {k}")
    pm = port_pm("aft20")
    np.testing.assert_array_equal(
        fx["grid_digest"], digest(*pm.mdp.arrays(), pm.coef, pm.expo,
                                  pm.start_ids, pm.start_coef,
                                  pm.start_expo))
    for k in ("grid_value", "grid_progress", "grid_policy", "grid_iter",
              "vi_residuals"):
        np.testing.assert_array_equal(fx[f"grid_{k}"],
                                      np.asarray(ref_grid[k]), k)


if __name__ == "__main__":
    import os
    import sys

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=8"
                               " --xla_backend_optimization_level=0")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import jax
    jax.config.update("jax_platforms", "cpu")
    arrays = build_golden()
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes, "
          f"{len(arrays)} arrays)")
