"""Host-side latency histograms for the serving SLO plane.

Port of cpr_tpu/latency.py, host only: the same code with its imports
from cpr_tpu_torch.

The serving layer (cpr_tpu/serve) needs per-op-family latency
quantiles — p50/p95/p99 queue wait, service and total time — cheap
enough to update on every request and to snapshot on every heartbeat.
Like telemetry/ and perf/, this module is jax-free at import and
allocation-free on the observe path: a histogram is one fixed vector
of integer bucket counts over log-scale edges, so `observe` is a
bisect + increment and `snapshot` is a single pass.

Quantiles are estimated by log-linear interpolation inside the owning
bucket, clamped to the observed min/max.  With the default edges
(16 buckets per decade over 1 microsecond .. 1000 seconds) the
estimate is within ~7% of the true value anywhere in range, which is
far inside the verdict bands the perf gate applies to the banked
`serve_p50_s` / `serve_p99_s` rows (cpr_tpu/perf/gate.py).

`LatencyBoard` maps op families ("episode.run", "netsim.query", ...)
to histograms and is what the server embeds in its `stats` reply,
`heartbeat` event and drain `report` (docs/SERVING.md).
"""

from __future__ import annotations

import math
from bisect import bisect_right

# default edges: log-scale, _PER_DECADE buckets per decade spanning
# [10**_LO_EXP, 10**_HI_EXP) seconds — wide enough for a sub-10us
# device dispatch and a multi-minute break-even sweep alike
_LO_EXP = -6
_HI_EXP = 3
_PER_DECADE = 16


def default_edges() -> tuple:
    """The shared log-scale bucket edges (seconds), increasing."""
    n = (_HI_EXP - _LO_EXP) * _PER_DECADE + 1
    return tuple(10.0 ** (_LO_EXP + i / _PER_DECADE) for i in range(n))


class LatencyHistogram:
    """Fixed-bucket log-scale histogram of durations in seconds.

    Buckets are `len(edges) + 1` counts: (-inf, e0), [e0, e1), ...,
    [eN, inf) — underflow and overflow included, like the
    device_metrics hist cells."""

    __slots__ = ("edges", "counts", "count", "sum_s", "min_s", "max_s")

    def __init__(self, edges=None):
        self.edges = tuple(edges) if edges is not None else default_edges()
        if not self.edges or any(b <= a for a, b in
                                 zip(self.edges, self.edges[1:])):
            raise ValueError("edges must be non-empty and increasing")
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.sum_s = 0.0
        self.min_s = math.inf
        self.max_s = -math.inf

    def observe(self, dur_s: float):
        """Fold one duration (seconds; negatives clamp to 0 — clock
        skew between stamps must never corrupt the board)."""
        d = float(dur_s)
        if not math.isfinite(d):
            return
        d = max(0.0, d)
        self.counts[bisect_right(self.edges, d)] += 1
        self.count += 1
        self.sum_s += d
        self.min_s = min(self.min_s, d)
        self.max_s = max(self.max_s, d)

    def merge(self, other: "LatencyHistogram"):
        """Fold another histogram (same edges) into this one."""
        if other.edges != self.edges:
            raise ValueError("cannot merge histograms with differing edges")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum_s += other.sum_s
        self.min_s = min(self.min_s, other.min_s)
        self.max_s = max(self.max_s, other.max_s)

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile (0..1) in seconds, or None when empty.
        Log-linear interpolation inside the owning bucket, clamped to
        the observed [min, max] so a one-sample histogram reports the
        sample, not a bucket edge."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                frac = 0.0 if c == 0 else min(1.0, max(
                    0.0, (rank - seen) / c))
                val = self._interp(i, frac)
                return min(self.max_s, max(self.min_s, val))
            seen += c
        return self.max_s

    def _interp(self, bucket: int, frac: float) -> float:
        # underflow/overflow buckets have one open side: report the
        # closed edge (clamping to min/max refines it anyway)
        if bucket == 0:
            return self.edges[0]
        if bucket == len(self.edges):
            return self.edges[-1]
        lo, hi = self.edges[bucket - 1], self.edges[bucket]
        if lo <= 0:
            return lo + frac * (hi - lo)
        return lo * (hi / lo) ** frac

    def snapshot(self) -> dict:
        """JSON-ready summary: count/sum/min/max/mean + p50/p95/p99."""
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum_s": self.sum_s,
            "min_s": self.min_s,
            "max_s": self.max_s,
            "mean_s": self.sum_s / self.count,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
        }

    # -- wire form (v14 fleet merge) ------------------------------------
    #
    # A snapshot() carries quantile ESTIMATES, which cannot be merged
    # (quantile-of-quantiles is wrong in general); the wire form below
    # carries the raw bucket counts, so a router can reconstruct a
    # replica's histogram and bucket-sum it into a fleet board exactly.
    # Buckets ship sparse ([index, count] pairs over the nonzero cells)
    # — with the default 145 edges a lightly-loaded family is a handful
    # of pairs, not a 146-zero vector per heartbeat.

    def to_dict(self) -> dict:
        """Raw mergeable form: sparse nonzero buckets + exact moments.
        `n_edges` guards the merge — histograms only combine when built
        over the same edge vector (from_dict re-checks)."""
        return {
            "n_edges": len(self.edges),
            "count": self.count,
            "sum_s": self.sum_s,
            "min_s": None if self.count == 0 else self.min_s,
            "max_s": None if self.count == 0 else self.max_s,
            "buckets": [[i, c] for i, c in enumerate(self.counts) if c],
        }

    @classmethod
    def from_dict(cls, raw: dict, edges=None) -> "LatencyHistogram":
        """Rebuild a histogram from `to_dict` output onto `edges`
        (default shared edges).  Raises ValueError on an edge-count or
        bucket-index mismatch — a silent misalignment here would corrupt
        every fleet quantile downstream."""
        h = cls(edges)
        if int(raw.get("n_edges", -1)) != len(h.edges):
            raise ValueError(
                f"histogram wire form built over {raw.get('n_edges')} "
                f"edges, expected {len(h.edges)}")
        for i, c in raw.get("buckets", ()):
            i, c = int(i), int(c)
            if not 0 <= i < len(h.counts):
                raise ValueError(f"bucket index {i} out of range "
                                 f"[0, {len(h.counts)})")
            if c < 0:
                raise ValueError(f"negative bucket count {c}")
            h.counts[i] += c
        h.count = int(raw.get("count", 0))
        h.sum_s = float(raw.get("sum_s", 0.0))
        if h.count != sum(h.counts):
            raise ValueError(
                f"bucket counts sum to {sum(h.counts)}, header says "
                f"{h.count}")
        if h.count:
            h.min_s = float(raw["min_s"])
            h.max_s = float(raw["max_s"])
        return h


# family-cardinality bound: per-tenant / per-class labels make the
# family space attacker-controlled under multi-tenant traffic, so a
# board never allocates more than `max_families` histograms — later
# novel families fold into one shared overflow bucket instead
OVERFLOW_FAMILY = "__overflow__"
DEFAULT_MAX_FAMILIES = 64


class LatencyBoard:
    """Per-op-family latency histograms, lazily created on first
    observe (families are dynamic: every serve op plus the engine's
    device families land here).  Cardinality is bounded: once
    `max_families` distinct families exist, observations for novel
    families land in the shared `OVERFLOW_FAMILY` histogram — memory
    stays O(max_families) however many labels clients invent."""

    def __init__(self, edges=None, max_families: int = DEFAULT_MAX_FAMILIES):
        if max_families <= 0:
            raise ValueError(f"max_families must be positive, "
                             f"got {max_families}")
        self._edges = tuple(edges) if edges is not None else default_edges()
        self.max_families = max_families
        self._hists: dict[str, LatencyHistogram] = {}

    def observe(self, family: str, dur_s: float):
        h = self._hists.get(family)
        if h is None:
            if (len(self._hists) >= self.max_families
                    and family != OVERFLOW_FAMILY):
                # the overflow family itself may be minted past the cap
                # (it IS the cap's escape hatch)
                return self.observe(OVERFLOW_FAMILY, dur_s)
            h = self._hists[family] = LatencyHistogram(self._edges)
        h.observe(dur_s)

    def get(self, family: str) -> LatencyHistogram | None:
        return self._hists.get(family)

    @property
    def families(self) -> tuple:
        return tuple(sorted(self._hists))

    def snapshot(self) -> dict:
        """{family: histogram snapshot} over every family observed."""
        return {k: self._hists[k].snapshot() for k in self.families}

    def to_dict(self) -> dict:
        """{family: raw histogram wire form} — the mergeable companion
        to `snapshot()` (v14: replicas ship this to the router, which
        bucket-sums it into the fleet board via `merge_dict`)."""
        return {k: self._hists[k].to_dict() for k in self.families}

    def merge_dict(self, raw: dict):
        """Exact bucket-sum merge of a `to_dict` payload into this
        board.  Families novel past `max_families` fold into
        `OVERFLOW_FAMILY` (merged there, not dropped) — the same
        cardinality bound `observe` applies, so a hostile replica
        payload cannot blow up router memory."""
        for family in sorted(raw):
            h = LatencyHistogram.from_dict(raw[family], self._edges)
            dst = self._hists.get(family)
            if dst is None:
                if (len(self._hists) >= self.max_families
                        and family != OVERFLOW_FAMILY):
                    family = OVERFLOW_FAMILY
                    dst = self._hists.get(family)
            if dst is None:
                dst = self._hists[family] = LatencyHistogram(self._edges)
            dst.merge(h)
