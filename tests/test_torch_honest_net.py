"""The port's honest-network sweep (`experiments.honest_net_rows`,
engine="jax": the batch netsim) against `cpr_tpu.experiments`' on the
CPU, following the JAX package's own schema test (tests/test_netsim.py
`test_honest_net_rows_jax_schema`).

Both packages run the same grid: a 5-node clique, 200 activations, seed
0 at activation delays 60 and 600, under Nakamoto (the scan path), the
Ethereum Byzantium, Bk and Spar event branches, and Tailstorm, which the
netsim lacks (an error row). The rows must have the same keys and equal
values, except the machine's duration, the git SHA and the backend, and
sim_time, which holds within TIME_RTOL (the scan path's mint times are a
running sum XLA:CPU adds in another order). Also: the oracle engine,
which is not ported, raises before any task runs; `write_tsv` and
`run_task` give the JAX package's text and error rows; and the port's
run manifest states torch's facts.
"""

from __future__ import annotations

import io
import json

import numpy as np
import pytest

from cpr_tpu import experiments as jexp
from cpr_tpu_torch import experiments, telemetry
from test_torch_netsim import (TIME_RTOL, jax_x64,  # noqa: F401
                               one_torch_thread)

KW = dict(activation_delays=(60.0, 600.0), n_nodes=5, n_activations=200)
PROTOCOLS = (("nakamoto", {}), ("ethereum-byzantium", {}),
             ("bk", dict(k=2, scheme="constant")),
             ("spar", dict(k=4, scheme="block")),
             ("tailstorm", dict(k=8, scheme="constant")))
# columns of the machine and the checkout, not of the simulation
UNCOMPARED = ("machine_duration_s", "git_sha", "backend")


@pytest.fixture(scope="module")
def runs():
    """Both packages' rows, made the first time a test asks (under the
    jax_x64 stand-in of the asking test)."""
    return {}


def rows(runs):
    if not runs:
        runs["jax"] = jexp.honest_net_rows(protocols=PROTOCOLS,
                                           engine="jax", **KW)
        runs["port"] = experiments.honest_net_rows(
            protocols=PROTOCOLS, engine="jax", device="cpu", **KW)
    return runs["port"], runs["jax"]


def test_rows_match_reference(runs):
    port, ref = rows(runs)
    assert len(port) == len(ref) == 4 * 2 + 1
    for got, want in zip(port, ref):
        assert list(got) == list(want), (set(got) ^ set(want))
        for k, v in want.items():
            if k in UNCOMPARED:
                continue
            if k == "sim_time":
                np.testing.assert_allclose(got[k], v, rtol=TIME_RTOL,
                                           atol=0)
            else:
                assert got[k] == v, (want["protocol"], k, got[k], v)
            assert type(got[k]) is type(v), (k, type(got[k]), type(v))
    ok = [r for r in port if "error" not in r]
    for r in ok:
        assert r["engine"] == "jax" and r["backend"] == "cpu"
        assert 0.0 <= r["orphan_rate"] < 0.2
        assert r["machine_duration_s"] > 0
        acts = [int(x) for x in r["node_activations"].split("|")]
        assert sum(acts) == r["activations"]
    # the sweep's orphan rate falls with the activation delay
    for proto in ("nakamoto", "ethereum-byzantium", "bk", "spar"):
        o = [r["orphan_rate"] for r in ok if r["protocol"] == proto]
        assert o[0] >= o[1], (proto, o)


def test_unsupported_protocol_is_an_error_row(runs):
    port, ref = rows(runs)
    bad = [r for r in port if "error" in r]
    want = [r for r in ref if "error" in r]
    assert len(bad) == len(want) == 1
    assert bad[0]["protocol"] == "tailstorm"
    assert bad[0]["reason"] == "unsupported-protocol"
    assert bad[0]["error"] == want[0]["error"]
    assert "netsim supports protocols" in bad[0]["error"]
    assert set(bad[0]) == set(want[0])


def test_oracle_engine_raises_before_any_task():
    buf = io.StringIO()
    telemetry.configure(stream=buf)
    try:
        with pytest.raises(NotImplementedError, match="item 9"):
            experiments.honest_net_rows(protocols=PROTOCOLS, **KW)
        with pytest.raises(NotImplementedError, match="item 9"):
            experiments.honest_net_rows(protocols=PROTOCOLS,
                                        engine="oracle", device="cpu", **KW)
    finally:
        telemetry.configure()
    assert buf.getvalue() == ""  # no manifest, no span: nothing ran
    with pytest.raises(ValueError, match="engine must be"):
        experiments.honest_net_rows(engine="warp", device="cpu")


def test_write_tsv_matches_reference(runs, tmp_path):
    port, ref = rows(runs)
    for rs in (ref, port, [{"a": 1.5, "b": None}, {"b": True, "c": "x"}]):
        assert experiments.write_tsv(rs) == jexp.write_tsv(rs)
    path = tmp_path / "rows.tsv"
    text = experiments.write_tsv(port, str(path))
    assert path.read_text() == text
    assert text.splitlines()[0].split("\t")[:3] == ["network", "protocol",
                                                    "k"]


def test_run_task_error_rows_match_reference():
    def fails():
        raise RuntimeError("boom")

    def fails_with_reason():
        err = ValueError("no such thing")
        err.reason = "unsupported-protocol"
        raise err

    ident = {"protocol": "x", "k": 3}
    for task in (fails, fails_with_reason):
        got = experiments.run_task(task, ident)
        want = jexp.run_task(task, ident)
        assert len(got) == len(want) == 1
        for k in want[0]:
            if k != "machine_duration_s":
                assert got[0][k] == want[0][k], k
        assert got[0]["machine_duration_s"] >= 0
    assert experiments.run_task(lambda: {"a": 1}, ident) == [{"a": 1}]
    assert experiments.run_task(lambda: [{"a": 1}, {"a": 2}], ident) == \
        [{"a": 1}, {"a": 2}]
    with pytest.raises(KeyboardInterrupt):
        experiments.run_task(lambda: (_ for _ in ()).throw(
            KeyboardInterrupt()), ident)


def test_run_manifest_states_torch_facts(monkeypatch):
    import torch
    man = telemetry.run_manifest({"sweep": "x"})
    assert man["kind"] == "manifest" and man["config"] == {"sweep": "x"}
    assert man["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert man["torch_version"] == torch.__version__
    assert man["device_count"] >= 1 and man["device_kind"]
    assert not any(k.startswith("jax") for k in man)
    assert man["run"] == telemetry.run_id()
    assert man["schema"] == telemetry.SCHEMA_VERSION
    buf = io.StringIO()
    telemetry.configure(stream=buf)
    try:
        emitted = telemetry.current().manifest(config={"a": 1})
    finally:
        telemetry.configure()
    assert json.loads(buf.getvalue())["run"] == emitted["run"]

    def broken():
        raise RuntimeError("no CUDA runtime")

    # a manifest never kills a run
    monkeypatch.setattr(torch.cuda, "is_available", broken)
    man = telemetry.run_manifest()
    assert "no CUDA runtime" in man["torch_error"] and "backend" not in man
