"""The port's serving planes (`cpr_tpu_torch.latency`, `.monitor`, the
telemetry ring, resilience's retries and fault points, the supervisor's
child side) against cpr_tpu's on the same inputs, on the CPU.

  * LatencyBoard quantiles, snapshots and wire forms equal the
    reference's, and a board rebuilt from the wire form merges back;
  * MetricsRegistry's Prometheus text and JSON equal the reference's, and
    the HTTP exposition serves it;
  * AlertEngine's summaries agree;
  * `dump_blackbox` writes a valid artifact: a manifest, then the
    recorded events;
  * `with_retries`, `parse_fault_specs`/`fault_point` and the supervisor
    heartbeat behave as the reference's.
"""

from __future__ import annotations

import io
import json
import time
import urllib.request

import numpy as np
import pytest

from cpr_tpu import latency as jlatency
from cpr_tpu import resilience as jres
from cpr_tpu.monitor import alerts as jalerts
from cpr_tpu.monitor import registry as jregistry
from cpr_tpu_torch import latency, resilience, supervisor, telemetry
from cpr_tpu_torch.monitor import alerts, registry
from cpr_tpu_torch.monitor.blackbox import dump_blackbox
from cpr_tpu_torch.monitor.expo import MetricsServer


def durations(seed, n=400):
    rng = np.random.default_rng(seed)
    return np.exp(rng.normal(-5.0, 2.0, n)).tolist()


def fill(board_cls, seed):
    b = board_cls()
    fams = ("episode.run", "episode.step", "netsim.query", "device.burst")
    for i, d in enumerate(durations(seed)):
        b.observe(fams[i % len(fams)], d)
    return b


def test_latency_board_equals_reference():
    got, want = fill(latency.LatencyBoard, 1), fill(jlatency.LatencyBoard, 1)
    assert got.snapshot() == want.snapshot()
    assert got.to_dict() == want.to_dict()
    for fam in got.families:
        for q in (0.5, 0.9, 0.99):
            assert got.get(fam).quantile(q) == want.get(fam).quantile(q)
    # the wire form merges: a board rebuilt from it doubles every count
    again = fill(latency.LatencyBoard, 1)
    again.merge_dict(json.loads(json.dumps(got.to_dict())))
    for fam, snap in again.snapshot().items():
        assert snap["count"] == 2 * got.snapshot()[fam]["count"]
    h = latency.LatencyHistogram()
    assert h.quantile(0.5) is None and h.snapshot()["count"] == 0


def fill_registry(mod, board):
    r = mod.MetricsRegistry(namespace="cpr_serve",
                            const_labels={"replica": "0"})
    r.attach_board("latency_seconds", board, help="reply latency")
    for i in range(7):
        r.inc("requests_total", op="episode.run",
              status="ok" if i % 3 else "error", help="requests")
    r.inc("sheds_total", reason="queue_full", tenant='a"b\\c',
          help="refusals")
    r.set("occupancy", 0.75, help="lanes assigned")
    r.set("steps", 123456, help="steps")
    return r


def test_registry_prometheus_text_equals_reference():
    got = fill_registry(registry, fill(latency.LatencyBoard, 2))
    want = fill_registry(jregistry, fill(jlatency.LatencyBoard, 2))
    text = got.render_prometheus()
    assert text == want.render_prometheus()
    assert "cpr_serve_requests_total" in text
    assert json.dumps(got.to_json(), sort_keys=True) == \
        json.dumps(want.to_json(), sort_keys=True)
    srv = MetricsServer(got.render_prometheus)
    port = srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=30) as resp:
            assert resp.read().decode() == text
    finally:
        srv.stop()


def test_alert_summary_equals_reference():
    kw = dict(class_slo={"interactive": 0.2, "normal": 0.1, "batch": 0.05},
              staleness_slo_s=30.0)
    got = alerts.AlertEngine(0.1, **kw)
    want = jalerts.AlertEngine(0.1, **kw)
    for i, d in enumerate(durations(3, 200)):
        for e in (got, want):
            e.record_admission(i % 5 == 0)
            e.record_latency(("interactive", "normal", "batch")[i % 3], d)
    for e in (got, want):
        e.record_staleness(45.0)
    g = [{k: v for k, v in a.items() if k != "window_s"}
         for a in got.evaluate()]
    w = [{k: v for k, v in a.items() if k != "window_s"}
         for a in want.evaluate()]
    assert [a["signal"] for a in g] == [a["signal"] for a in w]
    assert set(got.summary()) == set(want.summary())


def test_blackbox_dump_is_a_valid_artifact(tmp_path, monkeypatch):
    monkeypatch.setenv("CPR_BLACKBOX_DIR", str(tmp_path))
    tele = telemetry.Telemetry()  # no sink: the ring still records
    for i in range(5):
        tele.event("serve", action="heartbeat", session=None,
                   detail={"i": i})
    assert tele.n_emitted == 5
    path = dump_blackbox("test:reason")
    lines = [json.loads(x) for x in open(path).read().splitlines()]
    man = lines[0]
    assert man["kind"] == "manifest" and man["schema"] == 17
    assert man["config"]["entry"] == "blackbox"
    assert man["config"]["reason"] == "test:reason"
    assert man["config"]["n_events"] == len(lines) - 1
    tail = [e for e in lines[1:] if e.get("name") == "serve"][-5:]
    assert [e["detail"]["i"] for e in tail] == list(range(5))
    for e in tail:
        for f in telemetry.EVENT_FIELDS["serve"]:
            assert f in e


def test_retries_and_fault_points_match_reference(monkeypatch):
    for mod in (resilience, jres):
        calls, delays = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise mod.TransientFault("again")
            return "done"

        assert mod.with_retries(flaky, max_attempts=3, sleep=delays.append,
                                rng=lambda: 0.5) == "done"
        assert delays == pytest.approx([0.5625, 1.125])
        with pytest.raises(mod.GuardFailure):
            mod.with_retries(lambda: (_ for _ in ()).throw(
                mod.GuardFailure("no")), sleep=delays.append)
    specs = "kill@update=3,preempt@serve,corrupt@snapshot=2"
    got = [(s.action, s.site, s.index)
           for s in resilience.parse_fault_specs(specs)]
    assert got == [(s.action, s.site, s.index)
                   for s in jres.parse_fault_specs(specs)]
    with pytest.raises(ValueError, match="bad fault"):
        resilience.parse_fault_specs("explode@x")
    monkeypatch.setenv(resilience.FAULT_ENV_VAR, "kill@replica=1")
    assert resilience.fault_point("replica", 0) is None
    with pytest.raises(resilience.InjectedKill):
        resilience.fault_point("replica", 1)
    assert resilience.fault_point("replica", 1) is None  # one-shot
    with resilience.preemption_guard():
        assert not resilience.preempt_requested()
        resilience.request_preempt("test")
        assert resilience.preempt_reason() == "test"
    with resilience.preemption_guard():  # entry clears the flag again
        pass
    assert not resilience.preempt_requested()


def test_supervisor_child_heartbeat():
    out = io.StringIO()
    with supervisor.child_phase("serve:init"):
        assert supervisor.current_phase() == "serve:init"
    assert supervisor.restart_count() == 0
    th = supervisor.maybe_start_heartbeat(period_s=0.01, stream=out)
    assert th is not None and th.is_alive()
    for _ in range(200):
        if out.getvalue().count("\n") >= 2:
            break
        time.sleep(0.01)
    beat = json.loads(out.getvalue().splitlines()[0])
    assert beat["kind"] == "hb" and "n_events" in beat
    out.close()  # the beat thread stops on a closed stream
    th.join(5)
    assert not th.is_alive()
    with pytest.raises(NotImplementedError, match="item 14"):
        supervisor.run_child(["true"])
