"""The committed JAX fixture for the port's kernels K6 and K7.

`tests/fixtures/torch_port_grid_rtdp_golden.npz` holds what `cpr_tpu`
(JAX on the CPU) computes on two small tables:

- grid ("g_"): the parametric FC'16 compile at maximum_fork_length 6 with
  PT horizon 30 — a digest of its columns, coefficients and exponents —
  and `grid_value_iteration` over alpha in {0.25, 0.35} x gamma in
  {0.25, 0.75}, float32, stop_delta 1e-6, chunk 64: value, progress,
  policy, per-point sweeps, total sweeps, residual plane and revenue;
- RTDP ("r_"): the FC'16 table at maximum_fork_length 6, alpha 0.3,
  gamma 0.5, PT horizon 20, float32 — its digest — and per case of
  RTDP_CASES the scan loop `_rtdp_loop` (V, P) or the while loop
  `_rtdp_graph_loop` (V, P, visits, buffer ids, buffer priorities,
  steps, residual): 200 steps of 16 walkers, eps 0.5, buffer 64,
  restart_p 0.5, decay 0.95, for keys PRNGKey(0..2), and variants
  (discount 0.9, a buffer of 8, the residual stop, a warm start); each
  case's options are stored beside it as "r_<name>_args" (ARGS order).

JAX's RTDP results depend on XLA's optimization level: by default
XLA:CPU contracts `(prob * (reward + discount * V[dst])).sum(-1)` into
fused multiply-adds, at `--xla_backend_optimization_level=0` (the level
tests/conftest.py sets for the whole suite, to compile faster) it does
not, values move by a few ULP, and through the priority buffer's order
the walks part. The port follows JAX as users run it, at the default
level. So the fixture is computed by a process of its own, and the live
comparison below runs JAX in a subprocess without the suite's flag.

`chip_smoke.py` holds K6 and K7 against the fixture on the card, where
jax is absent. `python tests/test_torch_grid_rtdp_golden.py` regenerates
it; the tests here never do. They check that the port compiles the
fixture's tables and that its plain twins on the CPU reproduce the
fixture: the grid solve bit for bit, the walkers' visits, buffers and
steps exactly and their values within 1e-6.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import pytest

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_grid_rtdp_golden.npz")
GRID_MFL, GRID_HORIZON = 6, 30
GRID_ALPHAS, GRID_GAMMAS = (0.25, 0.35), (0.25, 0.75)
STOP, CHUNK = 1e-6, 64
RTDP_MFL, RTDP_HORIZON, RTDP_ALPHA, RTDP_GAMMA = 6, 20, 0.3, 0.5
STEPS, BATCH, BUFFER, EPS, RESTART_P, DECAY = 200, 16, 64, 0.5, 0.5, 0.95
# name -> (seed, graph mode, options beside the defaults above); "warm"
# starts from the table's VI values at stop_delta 1e-3
RTDP_CASES = {
    **{f"s{seed}_{mode}": (seed, mode == "graph", {})
       for seed in (0, 1, 2) for mode in ("scan", "graph")},
    "discount": (5, False, dict(discount=0.9, eps=0.2)),
    "small_buffer": (5, True, dict(cap=8, batch=24, restart_p=1.0)),
    "early_exit": (11, True, dict(steps=400, stop_delta=0.05, decay=0.5)),
    "warm_scan": (3, False, dict(warm=True)),
    "warm_graph": (3, True, dict(warm=True)),
}
ARGS = ("seed", "graph", "steps", "batch", "cap", "eps", "restart_p",
        "discount", "stop_delta", "decay", "warm")
GRID_KEYS = ("value", "progress", "policy", "iter", "residuals",
             "revenue")


def digest(*arrays) -> np.ndarray:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def param_digest(pm) -> np.ndarray:
    return digest(*pm.mdp.arrays(), pm.coef, pm.expo, pm.start_ids,
                  pm.start_coef, pm.start_expo)


def rtdp_table(pkg: str):
    """The RTDP fixture's PT table from the JAX package or the port."""
    if pkg == "jax":
        from cpr_tpu.mdp import Compiler, ptmdp
        from cpr_tpu.mdp.models import Fc16BitcoinSM
    else:
        from cpr_tpu_torch.mdp import Compiler, ptmdp
        from cpr_tpu_torch.mdp.models import Fc16BitcoinSM
    return ptmdp(Compiler(Fc16BitcoinSM(
        alpha=RTDP_ALPHA, gamma=RTDP_GAMMA,
        maximum_fork_length=RTDP_MFL)).mdp(), horizon=RTDP_HORIZON)


def grid_pm(pkg: str):
    if pkg == "jax":
        from cpr_tpu.mdp.grid import compile_protocol, param_ptmdp
    else:
        from cpr_tpu_torch.mdp.grid import compile_protocol, param_ptmdp
    return param_ptmdp(compile_protocol("fc16", cutoff=GRID_MFL),
                       horizon=GRID_HORIZON)


def build_golden() -> dict[str, np.ndarray]:
    """Every array of the fixture, computed by cpr_tpu on this host."""
    from cpr_tpu.mdp.grid import grid_value_iteration

    out = {}
    pm = grid_pm("jax")
    out["g_digest"] = param_digest(pm)
    vi = grid_value_iteration(pm, GRID_ALPHAS, GRID_GAMMAS,
                              stop_delta=STOP, chunk=CHUNK)
    for k in GRID_KEYS[:3]:
        out[f"g_{k}"] = np.asarray(vi[f"grid_{k}"])
    out["g_iter"] = np.asarray(vi["grid_iter"], np.int64)
    out["g_vi_iter"] = np.array(vi["vi_iter"], np.int64)
    out["g_residuals"] = np.asarray(vi["vi_residuals"])
    out["g_revenue"] = np.asarray(vi["grid_revenue"])

    out.update(jax_rtdp(RTDP_CASES))
    return out


def case_args(kw: dict) -> dict:
    """A case's options over the defaults."""
    return dict(dict(steps=STEPS, batch=BATCH, cap=BUFFER, eps=EPS,
                     restart_p=RESTART_P, discount=1.0, stop_delta=0.0,
                     decay=DECAY), **{k: v for k, v in kw.items()
                                      if k != "warm"})


def jax_rtdp(cases: dict) -> dict[str, np.ndarray]:
    """The JAX loops on the RTDP table for `cases`, as "r_<name>_<key>"
    arrays, with jax_threefry_partitionable on."""
    import jax
    import jax.numpy as jnp

    from cpr_tpu.mdp.explicit import _rtdp_loop
    from cpr_tpu.mdp.rtdp_graph import _rtdp_graph_loop

    jax.config.update("jax_threefry_partitionable", True)
    mdp = rtdp_table("jax")
    out = {"r_digest": digest(*mdp.arrays())}
    tm = mdp.tensor(jnp.float32)
    Tdst, Tpack, _ = tm.padded_layout()
    S, A = tm.n_states, tm.n_actions
    cdf = jnp.cumsum(jnp.asarray(tm.start, jnp.float32))
    z = jnp.zeros(S, jnp.float32)
    vi = tm.value_iteration(stop_delta=1e-3)
    f = jnp.float32
    for name, (seed, graph, kw) in cases.items():
        a = case_args(kw)
        v0, p0 = ((jnp.asarray(vi["vi_value"]), jnp.asarray(vi["vi_progress"]))
                  if kw.get("warm") else (z, z))
        key = jax.random.PRNGKey(seed)
        pre = f"r_{name}_"
        out[pre + "args"] = np.array(
            [seed, graph, a["steps"], a["batch"], a["cap"], a["eps"],
             a["restart_p"], a["discount"], a["stop_delta"], a["decay"],
             bool(kw.get("warm"))], np.float64)
        if not graph:
            V, P = _rtdp_loop(Tdst, Tpack, cdf, key, S, A, a["steps"],
                              a["batch"], f(a["eps"]), f(a["discount"]),
                              v0, p0)
            out[pre + "V"], out[pre + "P"] = np.asarray(V), np.asarray(P)
            continue
        V, P, visits, buf_s, buf_pri, t, resid = _rtdp_graph_loop(
            Tdst, Tpack, cdf, key, S, A, a["steps"], a["batch"], a["cap"],
            f(a["eps"]), f(a["restart_p"]), f(a["discount"]),
            f(a["stop_delta"]), f(a["decay"]), v0, p0)
        out[pre + "V"], out[pre + "P"] = np.asarray(V), np.asarray(P)
        out[pre + "visits"] = np.asarray(visits)
        out[pre + "buf_s"] = np.asarray(buf_s)
        out[pre + "buf_pri"] = np.asarray(buf_pri)
        out[pre + "t"] = np.array(int(t), np.int64)
        out[pre + "resid"] = np.array(float(resid), np.float32)
    return out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small ops in many steps; beside the suite's other workers an
    intra-op thread pool only contends."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def committed():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def test_fixture_stores_each_case_options(committed):
    for name, (seed, graph, kw) in RTDP_CASES.items():
        a = dict(case_args(kw), seed=seed, graph=graph,
                 warm=bool(kw.get("warm")))
        assert committed[f"r_{name}_args"].tolist() == [
            float(a[k]) for k in ARGS]


def test_port_compiles_the_fixture_tables(committed):
    np.testing.assert_array_equal(param_digest(grid_pm("torch")),
                                  committed["g_digest"])
    np.testing.assert_array_equal(digest(*rtdp_table("torch").arrays()),
                                  committed["r_digest"])


def test_grid_twin_reproduces_the_fixture(committed):
    # bit for bit: the plain twin of K7 sums each segment in row order
    # with one rounding per operation, as XLA:CPU's segment_sum does
    from cpr_tpu_torch.mdp.grid import grid_value_iteration

    vi = grid_value_iteration(grid_pm("torch"), GRID_ALPHAS, GRID_GAMMAS,
                              stop_delta=STOP, chunk=CHUNK, device="cpu")
    for k in GRID_KEYS[:3]:
        np.testing.assert_array_equal(vi[f"grid_{k}"], committed[f"g_{k}"])
    np.testing.assert_array_equal(vi["grid_iter"], committed["g_iter"])
    assert vi["vi_iter"] == int(committed["g_vi_iter"])
    np.testing.assert_array_equal(vi["vi_residuals"],
                                  committed["g_residuals"])
    np.testing.assert_array_equal(vi["grid_revenue"], committed["g_revenue"])


def port_rtdp(tm, name: str) -> dict:
    """The plain twin of K6 on the RTDP table for one case."""
    import torch

    from cpr_tpu_torch import random as rnd
    from cpr_tpu_torch.mdp.explicit import _rtdp_walk

    seed, graph, kw = RTDP_CASES[name]
    a = case_args(kw)
    v0 = p0 = None
    if kw.get("warm"):
        vi = tm.value_iteration(stop_delta=1e-3)
        v0, p0 = vi["vi_value"], vi["vi_progress"]
    return _rtdp_walk(tm, rnd.PRNGKey(seed, device=torch.device("cpu")),
                      graph=graph, max_steps=a["steps"], batch=a["batch"],
                      cap=a["cap"] if graph else 0, eps=a["eps"],
                      restart_p=a["restart_p"], discount=a["discount"],
                      stop_delta=a["stop_delta"], decay=a["decay"],
                      value0=v0, prog0=p0)


def assert_same_walk(got: dict, want: dict, name: str):
    """The same walk: visits, buffer ids and steps exactly; V, P and the
    buffer's priorities within 1e-6 (the twin emulates XLA's fused
    multiply-adds and matches bit for bit on these cases; torch.log and
    XLA's log differ by an ULP in some gumbel draws, which could only
    matter at a near-tie of an argmax)."""
    pre = f"r_{name}_"
    for k in ("V", "P"):
        np.testing.assert_allclose(got[k].cpu().numpy(), want[pre + k],
                                   rtol=0, atol=1e-6, err_msg=k)
    if RTDP_CASES[name][1]:
        np.testing.assert_array_equal(got["visits"].cpu().numpy(),
                                      want[pre + "visits"])
        np.testing.assert_array_equal(got["buf_s"].cpu().numpy(),
                                      want[pre + "buf_s"])
        np.testing.assert_allclose(got["buf_pri"].cpu().numpy(),
                                   want[pre + "buf_pri"], rtol=0, atol=1e-6)
        assert got["t"] == int(want[pre + "t"])
        assert abs(got["resid"] - float(want[pre + "resid"])) <= 1e-6


@pytest.fixture(scope="module")
def rtdp_tm():
    import torch

    return rtdp_table("torch").tensor(torch.float32, device="cpu")


@pytest.mark.parametrize("name", sorted(RTDP_CASES))
def test_rtdp_twin_reproduces_the_fixture(committed, rtdp_tm, name):
    assert_same_walk(port_rtdp(rtdp_tm, name), committed, name)


LIVE = """
import os, sys
import numpy as np
sys.path[:0] = [{tests!r}, {root!r}]
import test_torch_grid_rtdp_golden as g
np.savez(sys.argv[1], **g.jax_rtdp({{k: g.RTDP_CASES[k] for k in {names!r}}}))
"""


def test_rtdp_twin_walks_like_live_jax(tmp_path, rtdp_tm):
    # JAX computed now, in a process at XLA's default optimization level
    # (the module docstring): the committed fixture is not stale
    import os
    import subprocess
    import sys

    names = ["s1_graph", "early_exit"]
    flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                     if "xla_backend_optimization_level" not in f)
    env = {**os.environ, "XLA_FLAGS": flags, "JAX_PLATFORMS": "cpu"}
    out = tmp_path / "live.npz"
    here = Path(__file__).resolve().parent
    code = LIVE.format(tests=str(here), root=str(here.parent), names=names)
    run = subprocess.run([sys.executable, "-c", code, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(out) as f:
        live = {k: f[k] for k in f.files}
    for name in names:
        assert_same_walk(port_rtdp(rtdp_tm, name), live, name)


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    arrays = build_golden()
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes, "
          f"{len(arrays)} arrays)")
