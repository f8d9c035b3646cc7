"""Live fleet health plane (schema v14): metrics registry + exposition,

Port of cpr_tpu/monitor/__init__.py, host only: the same code with its imports
from cpr_tpu_torch.

SLO burn-rate alerts, and the crash flight recorder.

Everything observability built before this package is post-hoc or
request-scoped: telemetry JSONL is read back by tools/trace_summary.py
after the run, latency quantiles surface only in `stats` replies and
drain reports, and the perf ledger judges rows after banking.  This
package is the *live* side — a pull-based signal plane the serving
layer (and eventually the autoscaler / the real-hardware campaign of
ROADMAP items 3 and 5) reads while the run is still in flight:

* `registry`  — process-local MetricsRegistry: counters, gauges, and
  the existing `cpr_tpu_torch.latency` histograms, rendered as Prometheus
  text (stdlib only) or structured JSON.
* `expo`      — the `--metrics-port` HTTP endpoint (daemon-thread
  `http.server`, zero new deps).
* `alerts`    — multi-window SLO burn-rate evaluation over shed rate
  and per-class p99, emitting typed v14 `alert` events.
* `blackbox`  — dumps telemetry's in-process flight-recorder ring to
  an atomic `runs/blackbox-<run_id>-<pid>.jsonl` on crashes, so a
  wedged run leaves a readable last-N-events artifact.

Like telemetry/latency/perf, every module here is jax-free at import
(tests/test_observability.py enforces the pattern).
"""

from cpr_tpu_torch.monitor.alerts import AlertEngine, emit_alert  # noqa: F401
from cpr_tpu_torch.monitor.blackbox import dump_blackbox  # noqa: F401
from cpr_tpu_torch.monitor.expo import MetricsServer  # noqa: F401
from cpr_tpu_torch.monitor.registry import MetricsRegistry  # noqa: F401
