"""Runtime telemetry for the port: spans, point events, memory watermarks,
run manifests.

The part of `cpr_tpu.telemetry` that the port's paths call, over torch: a
JSONL event sink (`Telemetry`, `configure`, `current`), `Span` timers
that fence on the card with `torch.cuda.synchronize()` so device work
lands in the span that launched it, `MemoryWatermark`, which reads
PyTorch's CUDA allocator (`memory_allocated`, `max_memory_allocated`) or,
on the CPU, the process RSS, and run manifests (`run_manifest`,
`Telemetry.manifest`) that state torch's backend, card and versions.
Event names and fields are the JAX package's (`vi_residuals`, `memory`,
`manifest`), so one report reads the streams of either package.

With no sink configured (`configure(path)`, or the `CPR_TELEMETRY` env
var) spans still time and events go nowhere. Interval timing goes
through `now()` (`time.perf_counter`).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
from datetime import datetime, timezone
from time import perf_counter as now  # noqa: F401 — re-exported

TELEMETRY_ENV_VAR = "CPR_TELEMETRY"
# the JAX package's artifact schema (cpr_tpu/telemetry.py SCHEMA_VERSION)
SCHEMA_VERSION = 17
# a run id minted by a parent process, shared by its children's streams
RUN_ID_ENV_VAR = "CPR_RUN_ID"

# one lock serializes writes: two interleaved partial lines would
# corrupt the JSONL stream
_emit_lock = threading.Lock()


class Span:
    """One timed region (`Telemetry.span`). Values passed to `fence`
    that are CUDA tensors make the span synchronize the card before its
    end timestamp is read. Counters become `per_sec` rates."""

    def __init__(self, tele: "Telemetry", name: str, counters: dict):
        self._tele = tele
        self.name = name
        self.counters = dict(counters)
        self._fenced = False
        self.path = name
        self.depth = 0
        self.t_start = self.t_end = self.dur_s = None

    def fence(self, value):
        """Synchronize the card at span exit if `value` (a tensor or a
        sequence or dict of them) holds a CUDA tensor; returns `value`."""
        import torch

        vals = (value.values() if isinstance(value, dict)
                else value if isinstance(value, (list, tuple)) else (value,))
        if any(isinstance(v, torch.Tensor) and v.is_cuda for v in vals):
            self._fenced = True
        return value

    def __enter__(self):
        stack = self._tele._stack
        self.depth = len(stack)
        self.path = "/".join([s.name for s in stack] + [self.name])
        stack.append(self)
        self.t_start = now()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self._fenced:
            import torch

            torch.cuda.synchronize()
        self.t_end = now()
        self.dur_s = self.t_end - self.t_start
        if self._tele._stack and self._tele._stack[-1] is self:
            self._tele._stack.pop()
        event = {"kind": "span", "name": self.name, "path": self.path,
                 "depth": self.depth, "t_start": self.t_start,
                 "t_end": self.t_end, "dur_s": self.dur_s}
        if self.counters:
            event["counters"] = self.counters
            if self.dur_s > 0:
                event["per_sec"] = {
                    k: v / self.dur_s for k, v in self.counters.items()
                    if isinstance(v, (int, float))}
        if exc_type is not None:
            event["error"] = f"{exc_type.__name__}: {exc}"
        self._tele.emit(event)
        return False


class Telemetry:
    """A JSONL event sink plus the span stack; `path=None` disables
    emission (spans still time)."""

    def __init__(self, path: str | None = None, stream=None):
        self.path = path
        self._own = stream is None and path is not None
        self._sink = stream if stream is not None else (
            open(path, "a") if path else None)
        self._stack: list[Span] = []

    def emit(self, event: dict):
        """Write one event line, flushed (no-op when disabled)."""
        line = (json.dumps(event, default=str) + "\n"
                if self._sink is not None else None)
        with _emit_lock:
            sink = self._sink
            if line is None or sink is None:
                return
            sink.write(line)
            sink.flush()

    def span(self, name: str, **counters) -> Span:
        return Span(self, name, counters)

    def event(self, name: str, **fields):
        self.emit({"kind": "event", "name": name, "ts": now(), **fields})

    def manifest(self, config: dict | None = None) -> dict:
        """Emit (and return) a run manifest (`run_manifest`)."""
        man = run_manifest(config)
        self.emit(man)
        return man

    def close(self):
        if self._sink is not None and self._own:
            self._sink.close()
        self._sink = None


_NULL = Telemetry()
_default: Telemetry | None = None


def configure(path: str | None = None, stream=None) -> Telemetry:
    """Install the process-wide sink (closing any previous one);
    `configure(None)` disables emission."""
    global _default
    if _default is not None and _default is not _NULL:
        _default.close()
    _default = Telemetry(path, stream)
    return _default


def current() -> Telemetry:
    """The configured sink, else one opened from $CPR_TELEMETRY, else a
    disabled instance."""
    global _default
    if _default is None:
        path = os.environ.get(TELEMETRY_ENV_VAR)
        _default = Telemetry(path) if path else _NULL
    return _default


# -- memory watermarks ---------------------------------------------------------


def process_memory() -> tuple[int, int] | None:
    """(rss_bytes, peak_rss_bytes) of this process, or None."""
    try:
        with open("/proc/self/status") as f:
            fields = dict(line.split(":", 1) for line in f if ":" in line)
        return (int(fields["VmRSS"].split()[0]) * 1024,
                int(fields["VmHWM"].split()[0]) * 1024)
    except (OSError, KeyError, ValueError):
        pass
    try:
        import resource

        peak = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
        return peak, peak
    except Exception:  # noqa: BLE001 — memory stats are best-effort
        return None


def device_memory_stats() -> dict | None:
    """Per-card allocator stats from PyTorch's CUDA caching allocator
    (`bytes_in_use`, `peak_bytes_in_use`, `bytes_limit`); without a card,
    one process-RSS entry tagged `source: "rss"`. None when neither
    exists."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out = {}
        for i in range(torch.cuda.device_count()):
            out[f"cuda:{i}"] = {
                "bytes_in_use": int(torch.cuda.memory_allocated(i)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
                "bytes_limit": int(torch.cuda.get_device_properties(i)
                                   .total_memory)}
        return out
    pm = process_memory()
    if pm is None:
        return None
    rss, peak = pm
    return {"process:rss": {"bytes_in_use": rss, "peak_bytes_in_use": peak,
                            "source": "rss"}}


class MemoryWatermark:
    """The memory high-water mark over a scope, sampled on enter, on
    each `sample()` and on exit; exit emits one `memory` event (scope,
    peak_bytes, source, in_use_bytes, delta_bytes, limit_bytes,
    n_samples, devices + extras), on the failure path too. Devices are
    never summed: the limit is per card."""

    def __init__(self, scope: str, tele: Telemetry | None = None, **extra):
        self.scope = str(scope)
        self._tele = tele
        self.extra = dict(extra)
        self.source: str | None = None
        self.peak_bytes: int | None = None
        self.in_use_bytes: int | None = None
        self.limit_bytes: int | None = None
        self.baseline_bytes: int | None = None
        self.n_samples = 0
        self.devices: dict = {}

    def sample(self) -> dict | None:
        """Fold one allocator read into the watermark; never raises."""
        try:
            stats = device_memory_stats()
        except Exception:  # noqa: BLE001 — a probe must not kill its scope
            return None
        if not stats:
            return None
        self.n_samples += 1
        in_use_max: int | None = None
        for dev, ms in stats.items():
            self.source = ("rss" if ms.get("source") == "rss"
                           else self.source or "device")
            rec = self.devices.setdefault(dev, {})
            peak = max(ms.get("peak_bytes_in_use", 0),
                       ms.get("bytes_in_use", 0))
            rec["peak_bytes"] = max(rec.get("peak_bytes", 0), peak)
            self.peak_bytes = max(self.peak_bytes or 0, peak)
            if "bytes_in_use" in ms:
                rec["in_use_bytes"] = ms["bytes_in_use"]
                in_use_max = max(in_use_max or 0, ms["bytes_in_use"])
            if "bytes_limit" in ms:
                rec["limit_bytes"] = ms["bytes_limit"]
                self.limit_bytes = min(self.limit_bytes or ms["bytes_limit"],
                                       ms["bytes_limit"])
        if in_use_max is not None:
            self.in_use_bytes = in_use_max
            if self.baseline_bytes is None:
                self.baseline_bytes = in_use_max
        return stats

    @property
    def delta_bytes(self) -> int | None:
        if self.in_use_bytes is None or self.baseline_bytes is None:
            return None
        return self.in_use_bytes - self.baseline_bytes

    def emit(self, **extra):
        tele = self._tele if self._tele is not None else current()
        tele.event("memory", scope=self.scope, peak_bytes=self.peak_bytes,
                   source=self.source, in_use_bytes=self.in_use_bytes,
                   delta_bytes=self.delta_bytes,
                   limit_bytes=self.limit_bytes, n_samples=self.n_samples,
                   devices=self.devices or None, **{**self.extra, **extra})

    def __enter__(self) -> "MemoryWatermark":
        self.sample()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.sample()
        self.emit()
        return False


def memory_watermark(scope: str, tele: Telemetry | None = None,
                     **extra) -> MemoryWatermark:
    return MemoryWatermark(scope, tele, **extra)


# -- run manifests -------------------------------------------------------------

_run_id: str | None = None


def run_id() -> str:
    """This process tree's run id: inherited from $CPR_RUN_ID when a
    parent minted one, else minted here and exported so every child
    spawned after this call lands in the same trace."""
    global _run_id
    if _run_id is None:
        rid = os.environ.get(RUN_ID_ENV_VAR)
        if not rid:
            import uuid

            rid = uuid.uuid4().hex[:16]
            os.environ[RUN_ID_ENV_VAR] = rid
        _run_id = rid
    return _run_id


def git_sha() -> str | None:
    """HEAD SHA of this checkout, or None outside a work tree."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except Exception:  # noqa: BLE001 — manifests are best-effort metadata
        pass
    return None


def run_manifest(config: dict | None = None) -> dict:
    """Self-describing snapshot of this process's runtime, so an artifact
    row can be read with no other context: torch's backend (`cuda` when
    a card is present, else `cpu`), the card's name and count, the torch
    and CUDA versions, the git SHA and the resolved config. A failure to
    read the runtime lands in `torch_error`; a manifest never kills a
    run."""
    man: dict = {
        "kind": "manifest",
        "schema": SCHEMA_VERSION,
        "run": run_id(),
        "time_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "argv": list(sys.argv),
        "hostname": socket.gethostname(),
        "python": sys.version.split()[0],
        "git_sha": git_sha(),
    }
    try:
        import torch

        cuda = torch.cuda.is_available()
        man["backend"] = "cuda" if cuda else "cpu"
        man["device_kind"] = (torch.cuda.get_device_name(0) if cuda
                              else "cpu")
        man["device_count"] = torch.cuda.device_count() if cuda else 1
        man["torch_version"] = torch.__version__
        man["cuda_version"] = torch.version.cuda
        mem = device_memory_stats()
        if mem:
            man["memory_before"] = mem
    except Exception as e:  # noqa: BLE001 — a manifest must never kill a run
        man["torch_error"] = repr(e)
    if config is not None:
        man["config"] = config
    return man
