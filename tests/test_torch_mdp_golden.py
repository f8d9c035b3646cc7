"""The committed JAX fixture for the port's MDP kernels K4 and K5.

`tests/fixtures/torch_port_mdp_golden.npz` holds what `cpr_tpu` (JAX on
the CPU) computes for two attack MDPs: FC'16 bitcoin selfish mining at
maximum_fork_length 20 ("fc16") and the native GhostDAG k=2 compile at
dag_size_cutoff 6 ("gd6"), both alpha=0.3, gamma=0.5 and PT horizon 100.
Per model: a sha256 digest of the compiled table, its sizes, and for
float32 and float64 the value iteration results (stop_delta 1e-6) of
the while impl, JAX's Q-gap per state (best minus second-best action
value at the while fixpoint, +inf with one action) and the policy
evaluation of the VI policy (theta 1e-6); for float32 also the chunked
impl with accel_m 0 and 3. JAX's chunked impl does not run in 64-bit
mode: argmax then gives int64 and its scan carry's policy (int32) no
longer matches. So the float32 results come with 64-bit mode off, the
float64 ones with it on, and the port's float64 chunked solves are held
to the float64 while fixpoint. `chip_smoke.py` holds K4 and K5 against
the fixture on the card, where jax is absent.

`python tests/test_torch_mdp_golden.py` regenerates the fixture (JAX
with 64-bit mode on, for the float64 results); the tests here never do.
They check that the port's own compiles give the fixture's tables and
that the port's plain twins on the CPU reproduce its float32 while-loop
and policy-evaluation results.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import pytest

FIXTURE = (Path(__file__).resolve().parent / "fixtures"
           / "torch_port_mdp_golden.npz")
ALPHA, GAMMA, HORIZON, STOP = 0.3, 0.5, 100, 1e-6
MODELS = ("fc16", "gd6")
DTYPES = ("f32", "f64")
IMPLS = (("while", "while", 0), ("chunk0", "chunked", 0),
         ("chunk3", "chunked", 3))


def table_digest(mdp) -> np.ndarray:
    """sha256 of a compiled table: the six COO columns in their compiled
    order and dtypes, then the start distribution, as uint8 [32]."""
    h = hashlib.sha256()
    for col in mdp.arrays():
        h.update(np.ascontiguousarray(col).tobytes())
    for s in sorted(mdp.start):
        h.update(np.array([s], np.int64).tobytes())
        h.update(np.array([mdp.start[s]], np.float64).tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def q_gap(mdp, value, discount=1.0) -> np.ndarray:
    """Per state, the best minus the second-best action value of one
    Bellman backup of `value` (+inf where a state has one action), in
    float64 on the host."""
    src, act, dst, prob, reward, _ = mdp.arrays()
    S, A = mdp.n_states, mdp.n_actions
    q = np.zeros(S * A)
    np.add.at(q, src.astype(np.int64) * A + act,
              prob * (reward + discount * np.asarray(value, np.float64)[dst]))
    present = np.zeros(S * A, bool)
    present[src.astype(np.int64) * A + act] = True
    q = np.where(present, q, -np.inf).reshape(S, A)
    top2 = -np.sort(-q, axis=1)[:, :2]
    with np.errstate(invalid="ignore"):  # action-less states: inf - inf
        gap = top2[:, 0] - (top2[:, 1] if A > 1 else -np.inf)
    return np.where(np.isfinite(gap), gap, np.inf)


def compile_model(pkg: str, model: str):
    """The model's PT table from the JAX package (pkg "jax") or the port
    ("torch")."""
    if pkg == "jax":
        from cpr_tpu.mdp import Compiler, ptmdp
        from cpr_tpu.mdp.generic.native import compile_native
        from cpr_tpu.mdp.models import Fc16BitcoinSM
    else:
        from cpr_tpu_torch.mdp import Compiler, ptmdp
        from cpr_tpu_torch.mdp.generic import compile_native
        from cpr_tpu_torch.mdp.models import Fc16BitcoinSM
    if model == "fc16":
        table = Compiler(Fc16BitcoinSM(alpha=ALPHA, gamma=GAMMA,
                                       maximum_fork_length=20)).mdp()
    else:
        table = compile_native("ghostdag", k=2, alpha=ALPHA, gamma=GAMMA,
                               collect_garbage="simple", dag_size_cutoff=6)
    return ptmdp(table, horizon=HORIZON)


def build_golden() -> dict[str, np.ndarray]:
    """Every array of the fixture, computed by cpr_tpu on this host."""
    import jax
    import jax.numpy as jnp

    from cpr_tpu.mdp.explicit import vi_chunked

    old = jax.config.jax_enable_x64
    try:
        out = {}
        for model in MODELS:
            mdp = compile_model("jax", model)
            out[f"{model}_digest"] = table_digest(mdp)
            out[f"{model}_sizes"] = np.array(
                [mdp.n_states, mdp.n_actions, mdp.n_transitions], np.int64)
            for dt_name, dt in zip(DTYPES, (jnp.float32, jnp.float64)):
                jax.config.update("jax_enable_x64", dt_name == "f64")
                tm = mdp.tensor(dt)
                for tag, impl, accel in IMPLS:
                    if impl != "while" and dt_name == "f64":
                        continue  # see the module docstring
                    if impl == "while":
                        vi = tm.value_iteration(stop_delta=STOP)
                        v, p, pol, it = (vi["vi_value"], vi["vi_progress"],
                                         vi["vi_policy"], vi["vi_iter"])
                    else:
                        v, p, pol, _, it, _ = vi_chunked(
                            tm.src, tm.act, tm.dst, tm.prob, tm.reward,
                            tm.progress, tm.n_states, tm.n_actions,
                            jnp.asarray(1.0, dt), jnp.asarray(STOP, dt),
                            1 << 30, accel_m=accel)
                    pre = f"{model}_{dt_name}_{tag}_"
                    out[pre + "value"] = np.asarray(v)
                    out[pre + "progress"] = np.asarray(p)
                    out[pre + "policy"] = np.asarray(pol, np.int32)
                    out[pre + "iter"] = np.array(int(it), np.int64)
                pre = f"{model}_{dt_name}_"
                out[pre + "gap"] = q_gap(mdp, out[pre + "while_value"])
                pe = tm.policy_evaluation(out[pre + "while_policy"],
                                          theta=STOP)
                out[pre + "pe_reward"] = np.asarray(pe["pe_reward"])
                out[pre + "pe_progress"] = np.asarray(pe["pe_progress"])
                out[pre + "pe_iter"] = np.array(pe["pe_iter"], np.int64)
        return out
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain twins run thousands of sweeps of small ops; beside the
    suite's other workers an intra-op thread pool only contends."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def committed():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("model", MODELS)
def test_port_compiles_the_fixture_tables(committed, model):
    mdp = compile_model("torch", model)
    np.testing.assert_array_equal(table_digest(mdp),
                                  committed[f"{model}_digest"])
    assert [mdp.n_states, mdp.n_actions, mdp.n_transitions] == \
        committed[f"{model}_sizes"].tolist()


def test_plain_twins_reproduce_the_fixture(committed):
    # fc16 float32 on the CPU: the plain twins sum each segment in row
    # order, as XLA:CPU's segment_sum does, so the while loop and policy
    # evaluation reproduce JAX's results and sweep counts exactly
    import torch

    tm = compile_model("torch", "fc16").tensor(torch.float32, device="cpu")
    vi = tm.value_iteration(stop_delta=STOP)
    pre = "fc16_f32_"
    np.testing.assert_array_equal(vi["vi_value"], committed[pre + "while_value"])
    np.testing.assert_array_equal(vi["vi_progress"],
                                  committed[pre + "while_progress"])
    np.testing.assert_array_equal(vi["vi_policy"],
                                  committed[pre + "while_policy"])
    assert vi["vi_iter"] == committed[pre + "while_iter"]
    pe = tm.policy_evaluation(vi["vi_policy"], theta=STOP)
    np.testing.assert_array_equal(pe["pe_reward"], committed[pre + "pe_reward"])
    assert pe["pe_iter"] == committed[pre + "pe_iter"]


def test_fixture_is_complete(committed):
    for model in MODELS:
        for dt in DTYPES:
            pre = f"{model}_{dt}_"
            assert committed[pre + "while_value"].dtype == (
                np.float32 if dt == "f32" else np.float64)
            for tag, _, _ in IMPLS[:1 if dt == "f64" else 3]:
                assert committed[pre + tag + "_iter"] > 0
            assert committed[pre + "pe_iter"] > 0
            assert np.isfinite(committed[pre + "gap"]).any()


if __name__ == "__main__":
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    arrays = build_golden()
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes, "
          f"{len(arrays)} arrays)")
