"""Device metrics (`cpr_tpu_torch.device_metrics`, K17's plain fold on the
CPU) against cpr_tpu's `device_metrics` on the same numpy-made inputs.

  * the cell algebra: counters over masks and ints (int32 sums that wrap
    at 2^32), masked and empty stats cells, histograms with under- and
    overflow, merge and the axis merge, `enabled()`;
  * the crafted cases of the committed fixture
    (tests/fixtures/torch_port_metrics_golden.npz), applied by both
    packages: NaN and +-inf in min/max (NaN propagates, a masked-out NaN
    stays out), values on histogram edges (the bin above), NaN and +inf
    in the overflow bin, empty and all-masked cells, int masks, row
    sentinels over a strided view, transposed tensors and inputs large
    enough for K17 to cut into several blocks;
  * the producers: the episode-stats drivers chunked and unchunked
    (Nakamoto live against cpr_tpu, and a Tailstorm ring against the
    fixture), `rollout(with_metrics=True)`, PPO's `ppo_spec` cells (and
    the KL stop's skipped minibatches; the off path has no key), the
    serve engine's cells against the reference engine (64 lanes, burst
    16, the warm-up excluded);
  * the faults this port had: `make_train`'s accumulator, `train()` and
    `train_from_config` emitting `ppo_update`, `make_experience_update`'s
    four values, `AttackEngine.run` under CPR_DEVICE_METRICS=1, and the
    port's `device_metrics` events passing tools/trace_summary.py's
    validator.

Tolerance: float32 sums (and means) within rtol 1e-5 (the fold's order
is not XLA's); counters, histogram counts, min, max and count exact.
Path cells from float inputs the two packages compute apart (PPO's
approx_kl) within 1e-5 absolute.

`PYTHONPATH=. python tests/test_torch_device_metrics.py` rewrites the
fixture (~1 min): the crafted cases with cpr_tpu's summaries, and the
short paths' (Nakamoto SM1 unchunked and chunked, a Tailstorm ring
stream chunked, a batched rollout, one tiny PPO step from JAX's params)
that `chip_smoke.py` holds K17 and the card's paths against.
"""

from __future__ import annotations

import importlib.util
import io
import json
import math
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpr_tpu import device_metrics as jdm
from cpr_tpu.envs import registry as jregistry
from cpr_tpu.params import make_params as jmake
from cpr_tpu_torch import convert, kernels, telemetry
from cpr_tpu_torch import device_metrics as tdm
from cpr_tpu_torch import random as rnd
from cpr_tpu_torch.envs import registry as tregistry
from cpr_tpu_torch.params import make_params as tmake

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = Path(__file__).parent / "fixtures" / \
    "torch_port_metrics_golden.npz"
SUM_RTOL = 1e-5
SM1 = "sapirshtein-2016-sm1"


@pytest.fixture(autouse=True)
def partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


# -- summaries ----------------------------------------------------------------

def _same(a, b):
    return a == b or (a is not None and b is not None
                      and math.isnan(a) and math.isnan(b))


def _close(a, b, rtol, atol=0.0):
    if _same(a, b):
        return True
    if a is None or b is None or math.isnan(a) or math.isnan(b):
        return False
    return abs(a - b) <= rtol * abs(b) + atol


def assert_summary(got, want, what, atol=0.0):
    """Counters, bins and counts exact; min/max exact (or within `atol`);
    sums and means within SUM_RTOL."""
    assert list(got) == list(want), what
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict) and "counts" in w:
            assert g == w, (what, k, g, w)
        elif isinstance(w, dict):
            assert g["count"] == w["count"], (what, k, g, w)
            for f in ("min", "max"):
                assert _close(g[f], w[f], 0.0, atol), (what, k, f, g, w)
            for f in ("sum", "mean"):
                assert _close(g[f], w[f], SUM_RTOL, atol), (what, k, f, g, w)
        else:
            assert g == w, (what, k, g, w)


# -- the crafted cases (shared with chip_smoke.py through the fixture) -------

def _gen(a: dict) -> np.ndarray:
    """A fixture array made by integer arithmetic (so numpy makes the same
    one on any host): f32 ((i * mul) % mod) / div with NaN and inf at
    fixed strides, bool (i % mod) != 0, int32 (i * mul) % mod."""
    n = int(np.prod(a["shape"]))
    i = np.arange(n, dtype=np.int64)
    if a["gen"] == "mask":
        out = (i % a["mod"]) != 0
    elif a["gen"] == "i32":
        out = ((i * a["mul"]) % a["mod"]).astype(np.int32)
    else:
        out = ((i * a["mul"]) % a["mod"]).astype(np.float32) \
            / np.float32(a["div"])
        if a.get("nan_every"):
            out[::a["nan_every"]] = np.nan
        if a.get("inf_every"):
            out[1::a["inf_every"]] = np.inf
    return out.reshape(a["shape"])


def _f32(*v):
    return np.asarray(v, np.float32)


EDGES = [16.0, 32.0, 64.0]
INF, NAN = float("inf"), float("nan")


def crafted_cases() -> dict:
    """name -> (spec cells, ops, arrays): each op a dict (op, name, x,
    where, scale, n, value, rows, nonfinite), x/where naming arrays."""
    def op(kind, name, x=None, where=None, scale=1, n=1, value=0.0,
           rows=False, nonfinite=None):
        return dict(op=kind, name=name, x=x, where=where, scale=scale, n=n,
                    value=value, rows=rows, nonfinite=nonfinite)

    big_f = dict(gen="f32", shape=[40000], mul=2654435761, mod=100003,
                 div=7.0, nan_every=997)
    return {
        "counters": (
            [["counter", "c"], ["counter", "w"], ["counter", "k"]],
            [op("count", "c", "b"), op("count", "c", "i"),
             op("count", "w", n=131072, scale=2200),
             op("count", "w", n=131072, scale=2200),
             op("count", "w", n=131072, scale=2200),
             op("count", "k", n=3, scale=2 ** 30), op("count", "k", "big")],
            {"b": np.array([True, False, True, True]),
             "i": np.array([-5, 7, 0, 2], np.int32),
             "big": np.array([2 ** 30] * 3, np.int32)}),
        "stats": (
            [["counter", "nf"], ["stats", "masked"], ["stats", "poisoned"],
             ["stats", "infs"], ["stats", "intmask"], ["stats", "imm"]],
            [op("observe", "masked", "v", "m", nonfinite="nf"),
             op("observe", "poisoned", "v"),
             op("observe", "infs", "w"),
             op("observe", "intmask", "v", "ne"),
             op("observe", "imm", value=0.75), op("observe", "imm",
                                                  value=-2.5)],
            {"v": _f32(1.0, NAN, 3.0, INF, -INF, 2.0),
             "m": np.array([True, False, True, False, False, True]),
             "w": _f32(1.0, INF, -INF, 4.0),
             "ne": np.array([2, 0, 1, 0, 0, 3], np.int32)}),
        "hist": (
            [["hist", "h", EDGES], ["hist", "hm", EDGES]],
            [op("hist", "h", "x"), op("hist", "hm", "x", "m")],
            {"x": _f32(NAN, INF, -INF, 16.0, 15.9, 64.0, 32.0, 31.999,
                       63.0, 0.0),
             "m": np.array([True, True, False, True, True, False, True,
                            True, True, False])}),
        "empty": (
            [["counter", "c"], ["stats", "never"], ["stats", "masked"],
             ["hist", "h", EDGES]],
            [op("observe", "masked", "x", "m"), op("hist", "h", "x", "m")],
            {"x": _f32(NAN, 1.0, 2.0), "m": np.zeros(3, bool)}),
        "rows": (
            [["counter", "nonfinite_loss"], ["stats", "approx_kl"],
             ["counter", "minibatches"]],
            [op("nonfinite", "nonfinite_loss", "loss", rows=True),
             op("observe", "approx_kl", "kl"),
             op("count", "minibatches", n=6)],
            {"st": _f32(*[0.5, 1.0, 2.0, 0.01, NAN, 1.0, 2.0, 0.02,
                          0.5, 1.0, 2.0, 0.03, 0.5, 1.0, INF, 0.04,
                          0.5, 1.0, 2.0, NAN, 0.5, 1.0, 2.0, 0.05]
                        ).reshape(6, 4),
             # views of the stacked minibatch metrics, as PPO folds them
             "loss": dict(of="st", cols=[0, 3]),
             "kl": dict(of="st", col=3)}),
        "big": (
            [["counter", "c"], ["counter", "nf"], ["stats", "s"],
             ["stats", "t"], ["hist", "h", list(jdm._EP_LEN_EDGES)]],
            [op("observe", "s", "x", "ne", nonfinite="nf"),
             op("observe", "t", "y", "my"), op("hist", "h", "y", "my"),
             op("count", "c", "m"), op("count", "c", "ne"),
             op("nonfinite", "nf", "y")],
            {"x": big_f,
             "y": dict(big_f, shape=[200, 300], nan_every=0, inf_every=4999,
                       transpose=True),
             "m": dict(gen="mask", shape=[40000], mod=3),
             "my": dict(gen="mask", shape=[200, 300], mod=5,
                        transpose=True),
             "ne": dict(gen="i32", shape=[40000], mul=7, mod=4)}),
    }


def case_arrays(arrays: dict, device=None) -> dict:
    """A case's arrays: numpy values, or with `device` tensors there; a
    transposed one is a transposed view of its made array, `of` a view
    of another (a column, or a range of columns)."""
    out = {}
    for k, a in arrays.items():
        if not isinstance(a, dict):
            out[k] = a if device is None else \
                torch.from_numpy(a).to(device)
        elif "of" in a:
            base = out[a["of"]]
            out[k] = base[:, a["col"]] if "col" in a else \
                base[:, a["cols"][0]:a["cols"][1]]
        else:
            v = _gen(a)
            if device is not None:
                v = torch.from_numpy(v).to(device)
            if a.get("transpose"):
                v = v.T
            out[k] = v
    return out


def ref_spec(cells):
    s = jdm.MetricsSpec()
    for c in cells:
        getattr(s, c[0])(*c[1:])
    return s


def port_spec(cells):
    s = tdm.MetricsSpec()
    for c in cells:
        getattr(s, c[0])(*c[1:])
    return s


def ref_fold(spec, ops, arrays):
    """The case's ops through cpr_tpu's MetricsSpec (one lane)."""
    acc = spec.init()
    for o in ops:
        x = None if o["x"] is None else jnp.asarray(arrays[o["x"]])
        # the port reads an int mask as where=(mask != 0) (the episode
        # drivers' has_ep from n_episodes); the reference would weigh it
        w = None if o["where"] is None else \
            jnp.asarray(arrays[o["where"]]) != 0
        name = o["name"]
        if o["op"] == "count":
            if x is None:
                inc = np.array(o["n"] * o["scale"] % 2 ** 32,
                               np.uint32).view(np.int32)
                acc = spec.count(acc, name, inc)
            else:
                acc = spec.count(acc, name, x.astype(jnp.int32) * o["scale"])
        elif o["op"] == "nonfinite":
            bad = ~jnp.isfinite(x)
            acc = spec.count(acc, name, bad.any(-1) if o["rows"] else bad)
        elif o["op"] == "observe":
            acc = spec.observe(acc, name, o["value"] if x is None else x,
                               where=w)
            if o["nonfinite"]:
                acc = spec.count(acc, o["nonfinite"], ~jnp.isfinite(x))
        else:
            acc = spec.observe_hist(acc, name, x, where=w)
    return spec.summarize(acc)


def port_ops(ops, tensors):
    """The case's ops as the port's, over `case_arrays(..., device)`."""
    def t(k):
        return None if k is None else tensors[k]

    out = []
    for o in ops:
        x, w = t(o["x"]), t(o["where"])
        if o["op"] == "count":
            out.append(tdm.count_op(o["name"], o["n"] if x is None else x,
                                    o["scale"]))
        elif o["op"] == "nonfinite":
            out.append(tdm.nonfinite_op(o["name"], x, rows=o["rows"]))
        elif o["op"] == "observe":
            out.append(tdm.observe_op(o["name"], o["value"] if x is None
                                      else x, w, nonfinite=o["nonfinite"]))
        else:
            out.append(tdm.hist_op(o["name"], x, w))
    return out


def port_fold(cells, ops, arrays, device="cpu"):
    spec = port_spec(cells)
    return spec.summarize(spec.fold(spec.init(device), port_ops(
        ops, case_arrays(arrays, device))))


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def _j(fx, key):
    return json.loads(str(fx[key]))


# -- MetricsSpec cell algebra ---------------------------------------------------

def test_counter_sums_masks_and_scalars():
    spec = tdm.MetricsSpec().counter("c")
    acc = spec.init()
    acc = spec.count(acc, "c", torch.tensor([True, False, True]))
    acc = spec.count(acc, "c", 5)
    assert spec.summarize(acc)["c"] == 7
    assert acc.dtype == torch.int32
    # int32 wraps as XLA's sums do
    big = np.array([2 ** 30] * 3, np.int32)
    ref = jdm.MetricsSpec().counter("c")
    want = ref.summarize(ref.count(ref.init(), "c", jnp.asarray(big)))["c"]
    got = spec.summarize(spec.count(spec.init(), "c",
                                    torch.from_numpy(big)))["c"]
    assert got == want == 3 * 2 ** 30 - 2 ** 32


def test_stats_masked_observation_and_empty_cell():
    spec = tdm.MetricsSpec().stats("s")
    acc = spec.observe(spec.init(), "s", torch.tensor([1.0, 2.0, 3.0, 4.0]),
                       where=torch.tensor([True, False, True, False]))
    s = spec.summarize(acc)["s"]
    assert s == {"min": 1.0, "max": 3.0, "sum": 4.0, "count": 2.0,
                 "mean": 2.0}
    empty = spec.summarize(spec.init())["s"]
    assert empty["count"] == 0.0
    assert empty["min"] is None and empty["max"] is None \
        and empty["mean"] is None
    # the flat layout: min, max, sum, count as float32 words
    np.testing.assert_array_equal(acc.view(torch.float32).numpy(),
                                  [1.0, 3.0, 4.0, 2.0])


def test_hist_bins_include_under_and_overflow():
    spec = tdm.MetricsSpec().hist("h", [0.0, 10.0, 20.0])
    acc = spec.observe_hist(spec.init(), "h",
                            torch.tensor([-5.0, 0.0, 5.0, 10.0, 25.0]))
    h = spec.summarize(acc)["h"]
    assert h["edges"] == [0.0, 10.0, 20.0]
    assert h["counts"] == [1, 2, 1, 1]
    masked = spec.observe_hist(spec.init(), "h", torch.tensor([5.0, 15.0]),
                               where=torch.tensor([True, False]))
    assert spec.summarize(masked)["h"]["counts"] == [0, 1, 0, 0]
    with pytest.raises(AssertionError, match="increasing"):
        tdm.MetricsSpec().hist("bad", [1.0, 1.0])
    with pytest.raises(AssertionError, match="at most 31"):
        tdm.MetricsSpec().hist("wide", np.arange(32.0))


def test_merge_and_axis_reduction():
    spec = tdm.MetricsSpec().counter("c").stats("s").hist("h", [2.0])
    a = spec.observe(spec.count(spec.init(), "c", 2), "s", 1.0)
    b = spec.observe(spec.count(spec.init(), "c", 3), "s", 5.0)
    m = spec.summarize(spec.merge(a, b))
    assert m["c"] == 5
    assert m["s"]["min"] == 1.0 and m["s"]["max"] == 5.0 \
        and m["s"]["mean"] == 3.0

    def lane(v):
        acc = spec.count(spec.init(), "c", 1)
        acc = spec.observe(acc, "s", v)
        return spec.observe_hist(acc, "h", torch.tensor([v]))

    s = spec.summarize(spec.merge_axis(torch.stack(
        [lane(v) for v in (1.0, 5.0, 3.0)]), 0))
    assert s["c"] == 3
    assert s["s"] == {"min": 1.0, "max": 5.0, "sum": 9.0, "count": 3.0,
                      "mean": 3.0}
    assert s["h"]["counts"] == [1, 2]
    # NaN propagates through the merges as through jnp.minimum/maximum
    p = spec.observe(spec.init(), "s", float("nan"))
    assert math.isnan(spec.summarize(spec.merge(a, p))["s"]["min"])
    with pytest.raises(ValueError, match="last axis"):
        spec.merge_axis(torch.stack([a, b]), 1)


def test_enabled_reads_env_var(monkeypatch):
    monkeypatch.delenv(tdm.ENV_VAR, raising=False)
    assert not tdm.enabled()
    monkeypatch.setenv(tdm.ENV_VAR, "1")
    assert tdm.enabled()
    monkeypatch.setenv(tdm.ENV_VAR, "0")
    assert not tdm.enabled()
    assert tdm.ENV_VAR == jdm.ENV_VAR == telemetry.DEVICE_METRICS_ENV_VAR


def test_specs_and_edges_are_the_reference():
    for name in ("rollout_spec", "serve_spec", "ppo_spec"):
        t, j = getattr(tdm, name)(), getattr(jdm, name)()
        assert t.names == j.names
        assert [t.kind(n) for n in t.names] == [j.kind(n) for n in j.names]
    keys = ("episode_n_steps", "episode_progress")
    assert tdm.episode_stats_spec(keys).names == \
        jdm.episode_stats_spec(keys).names
    assert tdm._EP_LEN_EDGES == jdm._EP_LEN_EDGES
    assert tdm._BURST_S_EDGES == jdm._BURST_S_EDGES
    want = jdm.serve_spec().summarize(jdm.serve_spec().init())
    assert tdm.serve_spec().summarize(tdm.serve_spec().init()) == want
    obs = _f32(1.0, NAN, INF, 2.0, -INF, 0.0).reshape(3, 2)
    np.testing.assert_array_equal(
        tdm.obs_nonfinite(torch.from_numpy(obs)).numpy(),
        np.asarray(jdm.obs_nonfinite(obs)))


@pytest.mark.parametrize("case", sorted(crafted_cases()))
def test_crafted_cases_against_reference(case, fixture):
    """NaN/inf/edge/empty/row/large cases, applied by both packages; the
    committed fixture holds the reference's summaries that chip_smoke.py
    holds K17 to."""
    cells, ops, arrays = crafted_cases()[case]
    want = ref_fold(ref_spec(cells), ops, case_arrays(arrays))
    got = port_fold(cells, ops, arrays)
    assert_summary(got, want, case)
    assert_summary(got, _j(fixture, f"{case}__want"), f"{case} fixture")
    assert _j(fixture, f"{case}__ops") == ops
    assert _j(fixture, f"{case}__cells") == cells


def test_hist_of_nan_and_infinities_is_searchsorted():
    """jnp.searchsorted(edges, x, side="right") on this host: NaN and +inf
    in the overflow bin, -inf in bin 0, a value on an edge in the bin
    above it."""
    x = _f32(NAN, INF, -INF, 16.0, 15.9, 64.0)
    np.testing.assert_array_equal(
        np.asarray(jnp.searchsorted(jnp.asarray(EDGES), x, side="right")),
        [3, 3, 0, 1, 0, 3])
    spec = tdm.MetricsSpec().hist("h", EDGES)
    s = spec.summarize(spec.observe_hist(spec.init(), "h",
                                         torch.from_numpy(x)))
    assert s["h"]["counts"] == [2, 1, 0, 3]


def test_k17_cells_walk_views_without_copies():
    """K17's table (`MetricsSpec.lower`): a transposed trajectory and its
    mask are walked in memory order without a copy, a strided column
    keeps its stride, row sentinels read row_len elements a row; the
    wrapper takes only CUDA tensors, and its ctypes table is the .cu's
    (2568 bytes, 24 cells of 96)."""
    spec = tdm.rollout_spec()
    base = torch.arange(12.0).reshape(3, 4)
    done = base > 5
    c = spec.lower(tdm.observe_op("episode_length", base.t(), done.t()))
    assert c["x"].data_ptr() == base.data_ptr() and c["stride"] == 1
    assert c["mask"].data_ptr() == done.data_ptr() and c["n"] == 12
    st = torch.zeros(6, 4)
    c = spec.lower(tdm.observe_op("reward", st[:, 3]))
    assert (c["n"], c["stride"], c["row_len"]) == (6, 4, 1)
    c = spec.lower(tdm.nonfinite_op("nonfinite_obs", st[:, :3], rows=True))
    assert (c["n"], c["stride"], c["row_len"]) == (6, 4, 3)
    c = spec.lower(tdm.count_op("env_steps", 131072, 2200))
    assert c["x"] is None and (c["n"], c["scale"]) == (131072, 2200)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.metrics_fold(spec.init(), [c])
    import ctypes
    assert ctypes.sizeof(kernels._FoldTable) == 2568
    assert ctypes.sizeof(kernels._Cell) == 96
    assert kernels.launches["K17"] == 0
    assert "metrics.cu" in kernels.SOURCES


# -- the producers --------------------------------------------------------------

_N_ENVS, _N_STEPS, _CHUNK = 8, 96, 32


@pytest.fixture(scope="module")
def sm1_metrics_fns():
    """The reference's unchunked and chunked metrics-collecting stats fns
    (module-scoped: they compile once for the battery below)."""
    env = jregistry.get("nakamoto")
    params = jmake(alpha=0.35, gamma=0.5, max_steps=64)
    policy = env.policies[SM1]
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        keys = jax.random.split(jax.random.PRNGKey(0), _N_ENVS)
        whole = env.make_episode_stats_fn(params, policy, _N_STEPS,
                                          collect_metrics=True)
        chunked = env.make_episode_stats_fn(params, policy, _N_STEPS,
                                            chunk=_CHUNK,
                                            collect_metrics=True)
        out = {}
        for name, fn in (("whole", whole), ("chunked", chunked)):
            stats, acc = fn(keys)
            out[name] = (jax.tree.map(np.asarray, stats),
                         fn.metrics_spec.summarize(acc))
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    return out


def port_stats_fn(chunk):
    env = tregistry.get("nakamoto")
    params = tmake(alpha=0.35, gamma=0.5, max_steps=64)
    return env.make_episode_stats_fn(params, env.policies[SM1], _N_STEPS,
                                     chunk=chunk, collect_metrics=True)


def test_rollout_metrics_chunked_matches_unchunked(sm1_metrics_fns):
    keys = rnd.split(rnd.PRNGKey(0, "cpu"), _N_ENVS)
    for name, chunk in (("whole", None), ("chunked", _CHUNK)):
        fn = port_stats_fn(chunk)
        stats, acc = fn(keys)
        got = fn.metrics_spec.summarize(acc)
        jstats, want = sm1_metrics_fns[name]
        assert_summary(got, want, name)
        for k, v in jstats.items():
            np.testing.assert_allclose(stats[k].numpy(), v, rtol=1e-5)
        assert got["env_steps"] == _N_ENVS * _N_STEPS
        assert got["episodes"] > 0 and got["nonfinite_stats"] == 0
        assert got["episode_n_steps"]["count"] == _N_ENVS
        assert sum(got["episode_n_steps_hist"]["counts"]) == _N_ENVS


PATHS = {
    # fixture name -> (registry key, window, policy, max_steps, lanes,
    # steps, chunk)
    "sm1": ("nakamoto", None, SM1, 64, 8, 96, None),
    "sm1_chunked": ("nakamoto", None, SM1, 64, 8, 96, 32),
    "ts_chunked": ("tailstorm-8-discount-heuristic", 128, "get-ahead", 32,
                   8, 64, 32),
}


def port_path(name, device="cpu"):
    key, window, policy, max_steps, lanes, steps, chunk = PATHS[name]
    env = tregistry.get(key, **({"window": window} if window else {}))
    params = tmake(alpha=0.35, gamma=0.5, max_steps=max_steps)
    fn = env.make_episode_stats_fn(params, policy, steps, chunk=chunk,
                                   collect_metrics=True)
    _, acc = fn(rnd.split(rnd.PRNGKey(0, device), lanes))
    return fn.metrics_spec.summarize(acc)


@pytest.mark.parametrize("name", sorted(PATHS))
def test_episode_paths_against_fixture(name, fixture):
    """The port's stats drivers with metrics (K2 and K10's plain twins)
    give cpr_tpu's cells on the fixture's paths."""
    assert _j(fixture, "paths")[name] == list(PATHS[name])
    assert_summary(port_path(name), _j(fixture, f"path_{name}__want"), name,
                   atol=1e-6)


def rollout_keys(n):
    return (jax.random.split(jax.random.PRNGKey(3), n),
            rnd.split(rnd.PRNGKey(3, "cpu"), n))


def ref_rollout_summary(n_lanes, n_steps=48):
    env = jregistry.get("nakamoto")
    params = jmake(alpha=0.35, gamma=0.5, max_steps=16)
    jkeys, _ = rollout_keys(n_lanes)
    spec = jdm.rollout_spec()
    _, acc = jax.vmap(lambda k: env.rollout(k, params, env.policies[SM1],
                                            n_steps, True))(jkeys)
    return spec.summarize(spec.merge_axis(acc, 0))


def test_rollout_with_metrics_folds_per_step_cells(fixture):
    env = tregistry.get("nakamoto")
    params = tmake(alpha=0.35, gamma=0.5, max_steps=16)
    _, tkeys = rollout_keys(4)
    traj, acc = env.rollout(tkeys, params, env.policies[SM1], 48,
                            with_metrics=True)
    s = tdm.rollout_spec().summarize(acc)
    _, _, reward, done, _ = traj
    assert s["env_steps"] == 4 * 48
    assert s["episodes"] == int(done.sum()) > 0
    assert s["reward"]["count"] == 4 * 48.0
    assert s["reward"]["sum"] == pytest.approx(float(reward.sum()),
                                               rel=1e-5)
    assert sum(s["episode_length_hist"]["counts"]) == s["episodes"]
    want = ref_rollout_summary(4)
    assert_summary(s, want, "rollout")
    assert_summary(s, _j(fixture, "path_rollout__want"), "rollout fixture")
    # a single key, as the reference's own test
    traj1, acc1 = env.rollout(tkeys[0], params, env.policies[SM1], 48,
                              with_metrics=True)
    s1 = tdm.rollout_spec().summarize(acc1)
    assert s1["env_steps"] == 48 and traj1[2].shape == (48,)
    assert s1["episodes"] == int(traj1[3].sum())


PPO_KW = dict(n_envs=4, n_steps=16, hidden=(8, 8), update_epochs=2,
              n_minibatches=2)


def _ppo_pair(monkeypatch, on=True, **kw):
    from cpr_tpu.train import ppo as J
    from cpr_tpu_torch.train import ppo as P
    if on:
        monkeypatch.setenv(tdm.ENV_VAR, "1")
    else:
        monkeypatch.delenv(tdm.ENV_VAR, raising=False)
    je, te = jregistry.get("nakamoto"), tregistry.get("nakamoto")
    jp = jmake(alpha=0.45, gamma=0.9, max_steps=32)
    tp = tmake(alpha=0.45, gamma=0.9, max_steps=32)
    jinit, jstep = J.make_train(je, jp, J.PPOConfig(**PPO_KW, **kw))
    tinit, tstep = P.make_train(te, tp, P.PPOConfig(**PPO_KW, **kw),
                                device="cpu")
    return (jinit, jstep), (tinit, tstep)


def _ppo_run(j, t):
    jinit, jstep = j
    tinit, tstep = t
    jc = jax.jit(jinit)(jax.random.PRNGKey(0))
    flat = convert.actor_critic_from_flax(
        jax.tree.map(np.asarray, jc[0].params), "cpu")
    _, jm = jax.jit(jstep)(jc)
    _, tm = tstep(tinit(rnd.PRNGKey(0, "cpu"), params=flat))
    return jm, tm, flat


def test_ppo_train_step_accumulates_sentinels(monkeypatch, fixture):
    j, t = _ppo_pair(monkeypatch)
    assert t[1].metrics_spec is not None
    jm, tm, flat = _ppo_run(j, t)
    want = j[1].metrics_spec.summarize(jm.pop("device_metrics"))
    s = t[1].metrics_spec.summarize(tm.pop("device_metrics"))
    assert s["minibatches"] == 4  # update_epochs x n_minibatches
    assert s["nonfinite_advantages"] == 0 and s["nonfinite_loss"] == 0
    assert s["minibatches_skipped"] == 0
    assert s["approx_kl"]["count"] == 4.0
    assert_summary(s, want, "ppo", atol=1e-5)
    # the fixture's params were made at XLA's default optimization level,
    # these at the tests' (tests/conftest.py): the last bit may differ
    np.testing.assert_allclose(fixture["path_ppo__flat"], flat.numpy(),
                               rtol=0, atol=1e-6)
    assert_summary(s, _j(fixture, "path_ppo__want"), "ppo fixture",
                   atol=1e-5)
    assert np.isfinite(float(tm["pg_loss"]))


def test_ppo_kl_stop_counts_skipped_minibatches(monkeypatch):
    """With target_kl the reference's scan runs every minibatch, the
    gated ones as no-ops: all are counted, the gated ones skipped."""
    j, t = _ppo_pair(monkeypatch, target_kl=1e-9)
    jm, tm, _ = _ppo_run(j, t)
    want = j[1].metrics_spec.summarize(jm.pop("device_metrics"))
    s = t[1].metrics_spec.summarize(tm.pop("device_metrics"))
    assert s["minibatches"] == 4 and s["approx_kl"]["count"] == 4.0
    assert s["minibatches_skipped"] == want["minibatches_skipped"] > 0
    assert_summary(s, want, "ppo kl stop", atol=1e-5)


def test_ppo_off_path_has_no_metrics_key(monkeypatch):
    j, t = _ppo_pair(monkeypatch, on=False)
    assert t[1].metrics_spec is None
    jm, tm, _ = _ppo_run(j, t)
    assert "device_metrics" not in tm and "device_metrics" not in jm
    assert set(tm) == set(jm)


def _events(stream, name="device_metrics"):
    return [e for e in map(json.loads, stream.getvalue().splitlines())
            if e.get("name") == name]


@pytest.fixture
def sink():
    stream = io.StringIO()
    telemetry.configure(stream=stream)
    yield stream
    telemetry.configure(None)


def test_train_emits_ppo_update(monkeypatch, sink):
    from cpr_tpu_torch.train import ppo as P
    monkeypatch.setenv(tdm.ENV_VAR, "1")
    env = tregistry.get("nakamoto")
    params = tmake(alpha=0.45, gamma=0.9, max_steps=32)
    _, hist = P.train(env, params, P.PPOConfig(**PPO_KW), n_updates=2,
                      device="cpu")
    ev = _events(sink)
    assert [e["scope"] for e in ev] == ["ppo_update"] * 2
    assert [e["update"] for e in ev] == [0, 1]  # the reference's update=i
    assert all(e["metrics"]["minibatches"] == 4 for e in ev)
    assert "device_metrics" not in hist[0]


def test_train_from_config_emits_ppo_update(monkeypatch, sink):
    from cpr_tpu_torch.train import config as tconfig
    from cpr_tpu_torch.train import driver as tdriver
    monkeypatch.setenv(tdm.ENV_VAR, "1")
    cfg = tconfig.TrainConfig.from_dict(dict(
        protocol="nakamoto", alpha=0.3, gamma=0.5, episode_len=16,
        n_envs=8, total_updates=2,
        ppo=dict(n_steps=16, n_minibatches=2, update_epochs=2,
                 layer_size=8),
        eval=dict(freq=100, start_at_iteration=100, alpha_step=0.1,
                  episodes_per_alpha=8)))
    _, hist, _ = tdriver.train_from_config(cfg, device="cpu")
    ev = _events(sink)
    assert [e["update"] for e in ev] == [1, 2]  # the driver's update=i+1
    assert all(e["scope"] == "ppo_update" for e in ev)
    assert len(hist) == 2 and "device_metrics" not in hist[0]


def test_experience_update_returns_four(monkeypatch):
    from cpr_tpu_torch.train import ppo as P
    cfg = P.PPOConfig(update_epochs=1, n_minibatches=2, hidden=(8, 8))
    monkeypatch.delenv(tdm.ENV_VAR, raising=False)
    net, init_fn, update, mspec = P.make_experience_update(4, 4, cfg,
                                                           device="cpu")
    assert mspec is None
    monkeypatch.setenv(tdm.ENV_VAR, "1")
    *_, mspec = P.make_experience_update(4, 4, cfg, device="cpu")
    assert mspec.names == jdm.ppo_spec().names


def test_attack_engine_runs_with_metrics_var(monkeypatch, sink):
    """The reference's AttackEngine.run runs under CPR_DEVICE_METRICS=1
    and emits no device_metrics event; so does the port's."""
    from cpr_tpu_torch import netsim, network
    monkeypatch.setenv(tdm.ENV_VAR, "1")
    net = network.symmetric_clique(4, activation_delay=30.0,
                                   propagation_delay=1.0)
    eng = netsim.AttackEngine(net, activations=40, device="cpu")
    out = eng.run([0, 1], [30.0, 30.0], [0.3, 0.3], [0, 1])
    assert int(np.sum(out["n_act"])) == 80
    assert not _events(sink)


def test_serve_engine_cells_against_reference(monkeypatch, sink):
    from cpr_tpu.serve.engine import ResidentEngine as JEngine
    from cpr_tpu_torch.serve.engine import ResidentEngine
    monkeypatch.setenv(tdm.ENV_VAR, "1")
    L, B = 64, 16
    jenv = jregistry.get_sized("nakamoto", 16)
    tenv = tregistry.get_sized("nakamoto", 16)
    je = JEngine(jenv, jmake(alpha=0.35, gamma=0.5, max_steps=16),
                 n_lanes=L, burst=B)
    te = ResidentEngine(tenv, tmake(alpha=0.35, gamma=0.5, max_steps=16),
                        n_lanes=L, burst=B, device="cpu")
    je.start()
    te.start()
    seeds = {ln: 100 + ln for ln in range(L)}
    je.splice(seeds)
    te.splice(seeds)
    sm1 = te.policy_ids[SM1]
    assert je.policy_ids[SM1] == sm1
    got_done = 0
    for b, n_live in enumerate((L, 48, 40)):
        lp = {ln: sm1 for ln in range(n_live)}
        jr, tr = je.burst_run(lp), te.burst_run(lp)
        np.testing.assert_array_equal(tr["done"], np.asarray(jr["done"]))
        got_done += int(tr["done"].sum())
    je.record_shed()
    te.record_shed()
    want = je.emit_metrics()
    got = te.emit_metrics()
    for k in ("env_steps", "episodes", "bursts", "shed_sessions"):
        assert got[k] == want[k], k
    assert got["bursts"] == 3 and got["env_steps"] == (64 + 48 + 40) * B
    assert got["episodes"] == got_done > 0
    assert_summary({"o": got["occupancy"]}, {"o": want["occupancy"]},
                   "occupancy")
    assert got["burst_s"]["count"] == 3.0
    assert sum(got["burst_s_hist"]["counts"]) == 3
    assert got["burst_s_hist"]["edges"] == want["burst_s_hist"]["edges"]
    # emitting folds the walls into a copy: a second emit equals the first
    assert te.emit_metrics()["burst_s"]["count"] == 3.0
    ev = _events(sink)
    assert [e["scope"] for e in ev] == ["serve"] * 2
    monkeypatch.delenv(tdm.ENV_VAR)
    off = ResidentEngine(tenv, tmake(alpha=0.35, gamma=0.5, max_steps=16),
                         n_lanes=4, burst=4, device="cpu")
    off.start()
    assert off.emit_metrics() is None


def _trace_summary():
    path = ROOT / "tools" / "trace_summary.py"
    spec = importlib.util.spec_from_file_location("trace_summary", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_events_pass_reference_validator(tmp_path, monkeypatch):
    """A port telemetry stream with device_metrics events (a rollout's, a
    stats driver's, the netsim's) validates under the reference's
    tools/trace_summary.py, and the port declares the event's fields as
    the reference does."""
    from cpr_tpu import telemetry as jtele
    from cpr_tpu_torch import netsim, network
    assert telemetry.EVENT_FIELDS["device_metrics"] == \
        jtele.EVENT_FIELDS["device_metrics"]
    path = tmp_path / "port.jsonl"
    tele = telemetry.configure(str(path))
    try:
        env = tregistry.get("nakamoto")
        params = tmake(alpha=0.35, gamma=0.5, max_steps=16)
        _, acc = env.rollout(rnd.split(rnd.PRNGKey(0, "cpu"), 2), params,
                             env.policies[SM1], 16, with_metrics=True)
        tdm.emit("rollout", tdm.rollout_spec(), acc, lanes=2)
        fn = env.make_episode_stats_fn(params, SM1, 16,
                                       collect_metrics=True)
        _, acc = fn(rnd.split(rnd.PRNGKey(1, "cpu"), 2))
        tdm.emit("nakamoto_sm1", fn.metrics_spec, acc, reps=1)
        monkeypatch.setenv(tdm.ENV_VAR, "1")
        net = network.symmetric_clique(3, activation_delay=30.0,
                                       propagation_delay=1.0)
        netsim.Engine(net, activations=30, device="cpu").run([0], [30.0])
        tele.manifest(config={})
    finally:
        telemetry.configure(None)
    ts = _trace_summary()
    events, bad = ts.read_events(str(path))
    assert ts.validate(events, bad, expect=("device_metrics",)) == []
    scopes = [e["scope"] for e in events
              if e.get("name") == "device_metrics"]
    assert scopes == ["rollout", "nakamoto_sm1", "netsim"]


# -- the fixture ------------------------------------------------------------------

def write_fixture(path=FIXTURE):
    """Recompute every case with cpr_tpu and rewrite the fixture."""
    jax.config.update("jax_threefry_partitionable", True)
    out = {"cases": np.array(json.dumps(sorted(crafted_cases())))}
    for name, (cells, ops, arrays) in crafted_cases().items():
        vals = case_arrays(arrays)
        out[f"{name}__cells"] = np.array(json.dumps(cells))
        out[f"{name}__ops"] = np.array(json.dumps(ops))
        stored = {}
        for k, a in arrays.items():
            if isinstance(a, dict):  # made by _gen, or a view
                stored[k] = a
            else:
                stored[k] = {"file": f"{name}__a__{k}"}
                out[f"{name}__a__{k}"] = a
        out[f"{name}__arrays"] = np.array(json.dumps(stored))
        out[f"{name}__want"] = np.array(json.dumps(
            ref_fold(ref_spec(cells), ops, vals)))
    out["paths"] = np.array(json.dumps({k: list(v)
                                        for k, v in PATHS.items()}))
    for name, (key, window, policy, max_steps, lanes, steps, chunk) in \
            PATHS.items():
        env = jregistry.get(key, **({"window": window} if window else {}))
        params = jmake(alpha=0.35, gamma=0.5, max_steps=max_steps)
        pol = env.policies[policy]
        fn = env.make_episode_stats_fn(params, pol, steps, chunk=chunk,
                                       collect_metrics=True)
        _, acc = fn(jax.random.split(jax.random.PRNGKey(0), lanes))
        out[f"path_{name}__want"] = np.array(json.dumps(
            fn.metrics_spec.summarize(acc)))
    out["path_rollout__want"] = np.array(json.dumps(ref_rollout_summary(4)))

    class _Env(dict):
        def setenv(self, k, v):
            os.environ[k] = v

        def delenv(self, k, raising=True):
            os.environ.pop(k, None)

    j, t = _ppo_pair(_Env())
    jm, _, flat = _ppo_run(j, t)
    os.environ.pop(tdm.ENV_VAR, None)
    out["path_ppo__flat"] = flat.numpy()
    out["path_ppo__want"] = np.array(json.dumps(
        j[1].metrics_spec.summarize(jm["device_metrics"])))
    out["ppo_config"] = np.array(json.dumps(dict(
        PPO_KW, alpha=0.45, gamma=0.9, max_steps=32, seed=0)))
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    sys.exit(write_fixture())
