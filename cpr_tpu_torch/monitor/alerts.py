"""Multi-window SLO burn-rate alerting for the serving layer.

Port of cpr_tpu/monitor/alerts.py, host only: the same code with its imports
from cpr_tpu_torch.

Classic error-budget alerting (the SRE-workbook shape) adapted to the
serve tick loop: each signal is judged over a FAST and a SLOW window
pair, both scaled from the deployment's own `--slo-s`.  A fast-window
breach at a high burn rate pages (the budget is vanishing in minutes);
a slow-window breach at a low burn rate files a ticket (the budget is
bleeding).  Two signals:

* `shed_rate`     — shed fraction of admission decisions over the
  window, judged against the shed error budget (default 2%).
* `p99_over_slo`  — per-priority-class p99 total latency over the
  window, judged against that class's SLO budget (`slo_s` times the
  server's per-class scale — the same budgets admission control sheds
  against).
* `snapshot_staleness` — age of the serving policy snapshot (v17
  always-on learning, docs/LEARNING.md), judged against
  `staleness_slo_s`.  A gauge, not a rate: the latest recorded
  reading IS the window value (no min-samples floor — one stale
  reading is already a fact), so a dead learner or a wedged publish
  pipeline burns the budget within one heartbeat of breaching.

`burn_rate = value / budget`; an alert fires when it crosses the
window's threshold.  Evaluation is cheap enough for every heartbeat:
samples live in bounded deques, a window evaluation is one pass.
Breaches emit the typed v14 `alert` event (one call site,
`emit_alert`, carrying every EVENT_FIELDS-declared field) and surface
as an `alerts` block in heartbeat/stats/drain-report — the trigger
surface for an autoscaler over the serve fleet (the fleet router,
`serve/router.py`, is not ported yet: ROADMAP item 12).

Re-fire is cooldown-gated per (signal, class, window): an alert
re-emits at most once per window length while the breach persists, so
a sustained breach is a handful of events, not one per tick.  A signal
with no budget, an empty window, or a `None` value is SKIPPED
explicitly — `None` never reaches burn-rate math (the empty-histogram
edge the v14 satellite pins with tests).
"""

from __future__ import annotations

from collections import deque

from cpr_tpu_torch import telemetry

# severity thresholds: a fast-window breach must burn hard to page; a
# slow-window breach files a ticket at any over-budget burn
PAGE_BURN = 4.0
TICKET_BURN = 1.0
# default shed error budget: 2% of admission decisions may shed
# before the budget is considered burning
DEFAULT_SHED_BUDGET = 0.02
# windows need this many samples before a rate/quantile means anything
MIN_SAMPLES = 8
# per-signal sample retention (bounded: the engine's memory is
# O(max_samples) however long the process lives)
MAX_SAMPLES = 4096


def default_windows(slo_s: float) -> tuple:
    """(window_s, severity, burn threshold) pairs scaled from the SLO:
    fast ~10 SLOs (floored at 5 s, capped at 5 min) pages, slow ~60
    SLOs (floored at 30 s, capped at 1 h) tickets."""
    s = float(slo_s)
    fast = min(300.0, max(5.0, 10.0 * s))
    slow = min(3600.0, max(30.0, 60.0 * s))
    return ((fast, "page", PAGE_BURN), (slow, "ticket", TICKET_BURN))


def burn_rate(value, budget):
    """value/budget, or None when either side is missing or the budget
    is non-positive — the one place alert math meets missing data."""
    if value is None or budget is None or budget <= 0:
        return None
    return float(value) / float(budget)


def emit_alert(alert: dict):
    """The one typed v14 `alert` event call site
    (EVENT_FIELDS['alert'])."""
    telemetry.current().event(
        "alert", signal=alert["signal"], severity=alert["severity"],
        window_s=alert["window_s"], value=alert["value"],
        budget=alert["budget"], burn_rate=alert["burn_rate"],
        cls=alert.get("cls"), threshold=alert.get("threshold"),
        slo_s=alert.get("slo_s"))


class AlertEngine:
    """Windowed burn-rate evaluation over shed rate + per-class p99."""

    def __init__(self, slo_s: float | None = None, *,
                 shed_budget: float = DEFAULT_SHED_BUDGET,
                 class_slo: dict | None = None,
                 staleness_slo_s: float | None = None, windows=None,
                 min_samples: int = MIN_SAMPLES,
                 max_samples: int = MAX_SAMPLES, now_fn=telemetry.now):
        self.slo_s = slo_s
        self.shed_budget = shed_budget
        # snapshot-age budget for the always-on-learning deployments;
        # None (the default) skips the signal entirely
        self.staleness_slo_s = staleness_slo_s
        # class -> latency budget in seconds (the server passes its
        # admission-control budgets); classes without one fall back to
        # the raw slo_s, and with neither the signal is skipped
        self.class_slo = dict(class_slo or {})
        self.windows = tuple(windows) if windows is not None else \
            default_windows(slo_s if slo_s else 1.0)
        self.min_samples = min_samples
        self.max_samples = max_samples
        self._now = now_fn
        self._admissions: deque = deque(maxlen=max_samples)
        self._latencies: dict[str, deque] = {}
        self._staleness: deque = deque(maxlen=max_samples)
        self._active: dict[tuple, dict] = {}
        self._last_emit: dict[tuple, float] = {}
        self.n_fired = 0

    # -- feed ------------------------------------------------------------

    def record_admission(self, shed: bool):
        """One admission decision (admit or shed), any op."""
        self._admissions.append((self._now(), 1 if shed else 0))

    def record_latency(self, cls: str, dur_s):
        """One completed request's total latency for priority class
        `cls`.  None durations are dropped here, at the door."""
        if not isinstance(dur_s, (int, float)):
            return
        dq = self._latencies.get(cls)
        if dq is None:
            dq = self._latencies[cls] = deque(maxlen=self.max_samples)
        dq.append((self._now(), float(dur_s)))

    def record_staleness(self, staleness_s):
        """One snapshot-staleness reading (seconds since the serving
        policy last swapped); sampled per heartbeat by the server."""
        if not isinstance(staleness_s, (int, float)):
            return
        self._staleness.append((self._now(), float(staleness_s)))

    # -- evaluation ------------------------------------------------------

    def _signals(self, t: float, window_s: float):
        """(signal, cls, value, budget) readings over one window;
        under-sampled or budget-less signals are skipped, never
        yielded with None."""
        cut = t - window_s
        decisions = [s for ts, s in self._admissions if ts >= cut]
        if len(decisions) >= self.min_samples:
            yield ("shed_rate", None,
                   sum(decisions) / len(decisions), self.shed_budget)
        for cls, dq in sorted(self._latencies.items()):
            budget = self.class_slo.get(cls, self.slo_s)
            if budget is None or budget <= 0:
                continue
            durs = sorted(d for ts, d in dq if ts >= cut)
            if len(durs) < self.min_samples:
                continue
            p99 = durs[min(len(durs) - 1, int(0.99 * len(durs)))]
            yield ("p99_over_slo", cls, p99, budget)
        if self.staleness_slo_s is not None:
            readings = [v for ts, v in self._staleness if ts >= cut]
            if readings:  # gauge: the latest reading is the value
                yield ("snapshot_staleness", None, readings[-1],
                       self.staleness_slo_s)

    def evaluate(self) -> list[dict]:
        """Judge every (window, signal) pair now.  Returns the alerts
        to EMIT this round (breaches past their cooldown); `active`
        tracks every currently-breaching pair regardless."""
        t = self._now()
        out = []
        for window_s, severity, threshold in self.windows:
            for signal, cls, value, budget in self._signals(t, window_s):
                burn = burn_rate(value, budget)
                key = (signal, cls, window_s)
                if burn is None or burn < threshold:
                    self._active.pop(key, None)
                    continue
                alert = {"signal": signal, "cls": cls,
                         "severity": severity, "window_s": window_s,
                         "value": value, "budget": budget,
                         "burn_rate": burn, "threshold": threshold,
                         "slo_s": self.slo_s}
                self._active[key] = alert
                last = self._last_emit.get(key)
                if last is None or t - last >= window_s:
                    self._last_emit[key] = t
                    self.n_fired += 1
                    out.append(alert)
        return out

    def summary(self) -> dict:
        """The `alerts` block for heartbeat/stats/drain-report:
        currently-breaching alerts plus the lifetime fired count."""
        active = sorted(
            self._active.values(),
            key=lambda a: (a["signal"], str(a["cls"]), a["window_s"]))
        return {"active": [dict(a) for a in active],
                "fired": self.n_fired}
