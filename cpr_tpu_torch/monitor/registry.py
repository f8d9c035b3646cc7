"""Process-local live metrics registry with Prometheus-text exposition.

Port of cpr_tpu/monitor/registry.py, host only: the same code with its imports
from cpr_tpu_torch.

One `MetricsRegistry` per process, fed incrementally by the serving
layer's existing telemetry hooks: counters (`inc`), gauges (`set`),
and histograms — which are NOT a new type but the existing
`cpr_tpu_torch.latency.LatencyBoard` attached by reference (`attach_board`),
so the registry renders live bucket counts without a second observe
path.  Exposed two ways, both zero-dependency:

* `render_prometheus()` — text format 0.0.4 for the `--metrics-port`
  HTTP endpoint (cpr_tpu/monitor/expo.py).  Histogram `le` buckets
  are cumulative sums over the board's log-scale bins; the half-open
  `[e_{i-1}, e_i)` bins make `le` an "< edge" approximation, which is
  inside the board's own ~7% quantile-interpolation error.
* `to_json()` — the same data structured, returned by the in-band
  `metrics.scrape` serve op.  Includes each board's raw mergeable
  wire form (`LatencyBoard.to_dict`), which is what the router
  bucket-sums into the fleet board.

Cardinality is bounded exactly like the latency board: at most
`max_series` label combinations per metric name; later novel
combinations fold into one series whose every label value is
`OVERFLOW_FAMILY` — explicit in the exposition, never dropped.
Empty histograms render explicitly (all-zero buckets, `_count 0`,
no quantile-derived values), so a `None` quantile can never leak
into the text format.

Thread-safety: mutations and renders take one lock — the HTTP
exposition thread scrapes while the asyncio loop updates.
"""

from __future__ import annotations

import threading

from cpr_tpu_torch.latency import (DEFAULT_MAX_FAMILIES, OVERFLOW_FAMILY,
                             LatencyBoard)

# Prometheus text format 0.0.4 content type (the version is part of
# the grammar contract the fleet smoke parses against)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _escape_help(v) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v) -> str:
    """A Prometheus-parseable sample value: integral floats print as
    integers, everything else as repr (Go-float parseable)."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(items) -> str:
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + body + "}"


class _Family:
    """One metric name: its kind, help text, and label-keyed series."""

    __slots__ = ("kind", "help", "series")

    def __init__(self, kind: str, help_text: str):
        self.kind = kind
        self.help = help_text
        self.series: dict[tuple, float] = {}


class MetricsRegistry:
    """Counters + gauges + attached latency boards, rendered live."""

    def __init__(self, namespace: str = "cpr",
                 const_labels: dict | None = None,
                 max_series: int = DEFAULT_MAX_FAMILIES):
        if max_series <= 0:
            raise ValueError(f"max_series must be positive, "
                             f"got {max_series}")
        self.namespace = namespace
        self.const_labels = {str(k): str(v)
                             for k, v in (const_labels or {}).items()}
        self.max_series = max_series
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        # name -> (board, help, label name for the board's family key)
        self._boards: dict[str, tuple] = {}

    # -- feed ------------------------------------------------------------

    def _series_key(self, family: _Family, labels: dict) -> tuple:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        if key in family.series or len(family.series) < self.max_series:
            return key
        # past the cap: fold the label VALUES into the explicit
        # overflow marker (same escape hatch as LatencyBoard) — the
        # folded series aggregates everything novel, visibly
        return tuple((k, OVERFLOW_FAMILY) for k, _ in key)

    def _family(self, name: str, kind: str, help_text) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(
                kind, str(help_text or f"{kind} {name}"))
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} is a {fam.kind}, not a {kind}")
        return fam

    def inc(self, name: str, n: float = 1.0, help: str | None = None,
            **labels):
        """Increment a counter series (monotonic by contract)."""
        with self._lock:
            fam = self._family(name, "counter", help)
            key = self._series_key(fam, labels)
            fam.series[key] = fam.series.get(key, 0.0) + n

    def set(self, name: str, value, help: str | None = None, **labels):
        """Set a gauge series.  `value=None` UNSETS the series — the
        explicit no-data path, so an unknown reading (e.g. a quantile
        of an empty histogram) disappears from the exposition instead
        of rendering as a bogus number or a `None` literal."""
        with self._lock:
            fam = self._family(name, "gauge", help)
            key = self._series_key(fam, labels)
            if value is None:
                fam.series.pop(key, None)
            else:
                fam.series[key] = float(value)

    def attach_board(self, name: str, board,
                     help: str | None = None, label: str = "family"):
        """Expose a live LatencyBoard as the histogram metric `name`,
        one series per board family under the `label` label.  Held by
        reference: the board keeps observing, the scrape reads the
        current counts.  `board` may also be a zero-arg callable
        returning the current board, for holders that REPLACE their
        board wholesale (the router rebuilds its fleet board from
        replica payloads each refresh)."""
        if not (callable(board) or isinstance(board, LatencyBoard)):
            raise TypeError(f"board must be a LatencyBoard or a "
                            f"callable returning one, got {type(board)}")
        with self._lock:
            if name in self._families:
                raise ValueError(f"metric {name!r} already registered")
            self._boards[name] = (board, str(help or f"histogram {name}"),
                                  str(label))

    # -- exposition ------------------------------------------------------

    def _full_labels(self, key: tuple) -> list:
        return sorted(list(self.const_labels.items()) + list(key))

    def render_prometheus(self) -> str:
        """The whole registry in text format 0.0.4."""
        with self._lock:
            out: list[str] = []
            for name in sorted(self._families):
                fam = self._families[name]
                full = f"{self.namespace}_{name}"
                out.append(f"# HELP {full} {_escape_help(fam.help)}")
                out.append(f"# TYPE {full} {fam.kind}")
                for key in sorted(fam.series):
                    out.append(
                        f"{full}{_label_str(self._full_labels(key))} "
                        f"{_fmt_value(fam.series[key])}")
            for name in sorted(self._boards):
                board, help_text, label = self._boards[name]
                if callable(board):
                    board = board()
                full = f"{self.namespace}_{name}"
                out.append(f"# HELP {full} {_escape_help(help_text)}")
                out.append(f"# TYPE {full} histogram")
                for family in board.families:
                    h = board.get(family)
                    base = self._full_labels(((label, family),))
                    cum = 0
                    for i, edge in enumerate(h.edges):
                        cum += h.counts[i]
                        items = base + [("le", repr(float(edge)))]
                        out.append(
                            f"{full}_bucket"
                            f"{_label_str(sorted(items))} {cum}")
                    items = base + [("le", "+Inf")]
                    out.append(f"{full}_bucket"
                               f"{_label_str(sorted(items))} {h.count}")
                    out.append(f"{full}_sum{_label_str(base)} "
                               f"{_fmt_value(h.sum_s)}")
                    out.append(f"{full}_count{_label_str(base)} "
                               f"{h.count}")
            return "\n".join(out) + "\n"

    def to_json(self) -> dict:
        """The same data structured: counters/gauges as
        {name: [{labels, value}]}, histograms as both the quantile
        snapshot and the raw mergeable wire form."""
        with self._lock:
            counters: dict = {}
            gauges: dict = {}
            for name, fam in self._families.items():
                dst = counters if fam.kind == "counter" else gauges
                dst[name] = [
                    {"labels": dict(self._full_labels(key)),
                     "value": fam.series[key]}
                    for key in sorted(fam.series)]
            resolved = {name: (board() if callable(board) else board)
                        for name, (board, _, _) in self._boards.items()}
            hists = {name: b.snapshot() for name, b in resolved.items()}
            raw = {name: b.to_dict() for name, b in resolved.items()}
            return {"namespace": self.namespace,
                    "const_labels": dict(self.const_labels),
                    "counters": counters, "gauges": gauges,
                    "histograms": hists, "histograms_raw": raw}
