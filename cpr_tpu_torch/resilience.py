"""Failure taxonomy, retries, fault injection, preemption, and atomic and
sealed artifact writes.

Reference counterpart: `cpr_tpu/resilience.py`. Ported:

* the failure taxonomy (`GuardFailure`, `TransientFault`,
  `InjectedFault`, `InjectedKill`), `default_classify` and
  `with_retries` (exponential backoff, additive or full jitter, one
  `retry` event per re-attempt), which the serve client's shed retries
  run on;
* the deterministic fault injector: `CPR_FAULT_INJECT` specs
  `action@site[=index]` (`FaultSpec`, `parse_fault_specs`,
  `FaultInjector`, `fault_point`, `artifact_fault_point`), one-shot,
  each firing one `fault_injected` event;
* the preemption flag and `preemption_guard` (SIGTERM/SIGINT request a
  cooperative stop that the serve and learner loops poll);
* `atomic_write_bytes`/`atomic_write_json`/`atomic_write_text` (tmp
  file in the destination directory, fsync, `os.replace`) and the
  sealed seam `sealed_write`/`sealed_write_json`/`sealed_read`/
  `sealed_read_json`/`reject_undecodable` over `cpr_tpu_torch.
  integrity`'s envelope. A damaged envelope is quarantined with one
  typed `integrity` event and raises `IntegrityError` for the caller's
  policy (a cache recomputes). `sealed_write(site=...)` passes the
  written file to the artifact fault point of its site.

Not ported (ROADMAP item 6): the resumable train snapshots and the VI,
grid and compile checkpoints built on these pieces.
"""

from __future__ import annotations

import json
import os
import random
import signal
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Callable

from cpr_tpu_torch import integrity, telemetry
from cpr_tpu_torch.integrity import IntegrityError

__all__ = ["FAULT_ENV_VAR", "FaultInjector", "FaultSpec", "GuardFailure",
           "InjectedFault", "InjectedKill", "IntegrityError",
           "TransientFault", "artifact_fault_point", "atomic_write_bytes",
           "atomic_write_json", "atomic_write_text", "default_classify",
           "fault_point", "injector", "parse_fault_specs",
           "preempt_reason", "preempt_requested", "preemption_guard",
           "reject_undecodable", "request_preempt", "sealed_read",
           "sealed_read_json", "sealed_write", "sealed_write_json",
           "with_retries"]

FAULT_ENV_VAR = "CPR_FAULT_INJECT"


# -- failure taxonomy --------------------------------------------------------


class GuardFailure(Exception):
    """A deterministic correctness-guard violation, distinct from
    AssertionError so an assertion raised inside library code cannot
    masquerade as one. Never retried: the same inputs fail the same
    way."""


class TransientFault(Exception):
    """A failure worth re-attempting: an I/O hiccup, a loaded server, a
    recovering worker. Raisers may attach context (e.g. `.rc`)."""


class InjectedFault(Exception):
    """Base for faults raised by the CPR_FAULT_INJECT harness."""


class InjectedKill(InjectedFault):
    """Simulated hard kill at a fault point. Classified fatal (a real
    SIGKILL cannot be retried from inside the process), so it unwinds
    the whole loop like the crash it stands in for."""


def default_classify(exc: BaseException) -> bool:
    """Shared retry classifier: True = transient, worth retrying.
    GuardFailure and simulated kills are fatal; everything else derived
    from Exception is presumed transient. with_retries only catches
    Exception, so KeyboardInterrupt/SystemExit always propagate."""
    return not isinstance(exc, (GuardFailure, InjectedKill))


def with_retries(fn: Callable, *, classify: Callable | None = None,
                 max_attempts: int = 3, base_delay_s: float = 0.5,
                 max_delay_s: float = 30.0, jitter_frac: float = 0.25,
                 jitter: str = "additive",
                 sleep: Callable = time.sleep, rng=None,
                 on_retry: Callable | None = None, name: str | None = None):
    """Call `fn()` with exponential backoff on transient failures.

    `jitter="additive"`: the delay before attempt k+1 is
    `min(base * 2**(k-1), max) * (1 + j)`, j uniform in
    [0, jitter_frac). `jitter="full"`: uniform in
    [0, min(base * 2**(k-1), max)] (a fleet retrying one shed spreads
    over the whole window). Each re-attempt emits a `retry` event
    (attempt, delay_s, error) and calls `on_retry(attempt, exc,
    delay_s)` if given; `classify(exc) -> bool` decides retryability
    (default `default_classify`); a fatal exception or the last
    attempt's failure re-raises."""
    classify = classify or default_classify
    if jitter not in ("additive", "full"):
        raise ValueError(f"jitter must be 'additive' or 'full', "
                         f"got {jitter!r}")
    rand = rng if rng is not None else random.random
    label = name or getattr(fn, "__name__", "fn")
    for attempt in range(1, max_attempts + 1):
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 — classifier decides
            if attempt >= max_attempts or not classify(exc):
                raise
            cap = min(base_delay_s * (2.0 ** (attempt - 1)), max_delay_s)
            if jitter == "full":
                delay = cap * rand()
            else:
                delay = cap * (1.0 + jitter_frac * rand())
            telemetry.current().event(
                "retry", attempt=attempt, delay_s=round(delay, 3),
                error=f"{type(exc).__name__}: {exc}", site=label)
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)


def atomic_write_bytes(path: str, data: bytes):
    """Write `data` to `path` atomically: tmp file in the same
    directory, fsync, rename. On any failure the tmp file is removed
    and `path` is untouched."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    # best-effort directory fsync so the rename itself is durable
    try:
        dfd = os.open(d or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def atomic_write_text(path: str, text: str, encoding: str = "utf-8"):
    atomic_write_bytes(path, text.encode(encoding))


def atomic_write_json(path: str, obj):
    atomic_write_bytes(path, (json.dumps(obj, indent=2, default=str)
                              + "\n").encode())


def sealed_write(path: str, data: bytes, *, site: str | None = None,
                 schema: int = integrity.SEAL_SCHEMA):
    """Atomically write `data` wrapped in the checksummed envelope.
    `site` names the artifact-damage fault site armed by chaos specs
    (checkpoint, snapshot, cache...)."""
    atomic_write_bytes(path, integrity.seal(data, schema=schema))
    if site is not None:
        artifact_fault_point(site, path)


def sealed_write_json(path: str, obj, *, site: str | None = None):
    sealed_write(path, (json.dumps(obj, indent=2, default=str)
                        + "\n").encode(), site=site)


def sealed_read(path: str, *, kind: str = "artifact",
                action: str = "quarantined",
                sidecars: tuple = (".json",)) -> tuple[bytes, str]:
    """Read and verify a sealed artifact: (payload, tag), tag
    "verified" or "unverified" (an unsealed file). A damaged envelope
    moves the artifact to `<path>.quarantine/`, fires one `integrity`
    event with the caller's recovery `action`, and raises
    IntegrityError."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return integrity.unseal(data, artifact=path, kind=kind)
    except IntegrityError as exc:
        integrity.quarantine(path, kind=kind, reason=exc.reason,
                             action=action, sidecars=sidecars)
        raise


def sealed_read_json(path: str, *, kind: str = "artifact",
                     action: str = "quarantined") -> tuple[dict, str]:
    """`sealed_read` + JSON decode; a payload that does not decode is
    handled as a torn envelope (quarantine, event, IntegrityError)."""
    payload, tag = sealed_read(path, kind=kind, action=action)
    try:
        return json.loads(payload.decode("utf-8", "replace")), tag
    except ValueError:
        integrity.quarantine(path, kind=kind, reason="truncated",
                             action=action)
        raise IntegrityError(
            f"{kind} {path}: payload is not valid JSON",
            artifact=path, kind=kind, reason="truncated") from None


def reject_undecodable(path: str, *, kind: str, err,
                       action: str = "quarantined") -> IntegrityError:
    """A payload that cleared (or predates) the envelope but does not
    deserialize: quarantine it, fire one event, and return the
    IntegrityError for the caller to raise."""
    integrity.quarantine(path, kind=kind, reason="truncated",
                         action=action)
    return IntegrityError(
        f"{kind} {path}: payload does not deserialize ({err})",
        artifact=path, kind=kind, reason="truncated")


# -- deterministic fault injection -------------------------------------------

_ACTIONS = ("kill", "io_error", "fault", "nan", "preempt", "hang",
            "slow") + integrity.ARTIFACT_ACTIONS
# artifact-damage actions fire at write sites through
# `artifact_fault_point(site, path)` and keep their own per-site counters
_ARTIFACT_ACTIONS = integrity.ARTIFACT_ACTIONS

# how long an injected `hang` blocks (a wedged process the supervisor's
# watchdog must kill) and an injected `slow` sleeps before returning
HANG_DURATION_ENV_VAR = "CPR_FAULT_HANG_S"
_DEFAULT_HANG_S = 3600.0
SLOW_DURATION_ENV_VAR = "CPR_FAULT_SLOW_S"
_DEFAULT_SLOW_S = 0.75


class FaultSpec:
    """One armed fault: `action@site=index` (e.g. `kill@update=7`), or
    bare `action@site` for index 1. Sites with an explicit loop index
    match that index; occurrence-counted sites match the n-th pass.
    One-shot: fires once, then disarms."""

    def __init__(self, raw: str):
        self.raw = raw.strip()
        try:
            if "=" in self.raw:
                action_site, idx = self.raw.split("=")
                self.index = int(idx)
            else:
                action_site = self.raw
                self.index = 1
            self.action, self.site = action_site.split("@")
        except ValueError:
            raise ValueError(
                f"bad fault spec {raw!r}: want action@site[=index] "
                f"(e.g. kill@update=7, hang@probe)") from None
        if self.action not in _ACTIONS:
            raise ValueError(f"bad fault action {self.action!r}: "
                             f"one of {_ACTIONS}")
        self.armed = True


def parse_fault_specs(spec: str) -> list[FaultSpec]:
    """Parse a comma-separated CPR_FAULT_INJECT value."""
    return [FaultSpec(part) for part in spec.split(",") if part.strip()]


class FaultInjector:
    """Holds the armed specs and the per-site occurrence counters."""

    def __init__(self, specs):
        self.specs = list(specs)
        self.counts: dict[str, int] = {}

    def fire(self, site: str, index: int | None = None) -> str | None:
        """Called at a fault point. Returns the action name for the
        cooperative actions ("nan", "preempt", "hang", "slow"), None when
        nothing fires; raises for "kill"/"io_error"/"fault". Artifact
        specs never fire here (`fire_artifact`)."""
        if index is None:
            index = self.counts.get(site, 0) + 1
            self.counts[site] = index
        for s in self.specs:
            if s.action in _ARTIFACT_ACTIONS:
                continue
            if not (s.armed and s.site == site and s.index == index):
                continue
            s.armed = False
            telemetry.current().event(
                "fault_injected", spec=s.raw, site=site, index=index)
            if s.action == "kill":
                raise InjectedKill(s.raw)
            if s.action == "io_error":
                raise OSError(f"injected I/O error ({s.raw})")
            if s.action == "fault":
                raise TransientFault(f"injected device fault ({s.raw})")
            if s.action == "preempt":
                request_preempt(f"injected ({s.raw})")
            if s.action == "hang":
                time.sleep(float(os.environ.get(
                    HANG_DURATION_ENV_VAR, _DEFAULT_HANG_S)))
            if s.action == "slow":
                time.sleep(float(os.environ.get(
                    SLOW_DURATION_ENV_VAR, _DEFAULT_SLOW_S)))
            return s.action
        return None

    def fire_artifact(self, site: str, path: str,
                      index: int | None = None) -> str | None:
        """Called right after an artifact lands at `path` on a write
        site: matches only the artifact-damage specs, counted in a
        namespace of their own (`<site>#artifact`), damages the file in
        place and returns the action name (None when nothing fires)."""
        key = site + "#artifact"
        if index is None:
            index = self.counts.get(key, 0) + 1
            self.counts[key] = index
        for s in self.specs:
            if s.action not in _ARTIFACT_ACTIONS:
                continue
            if not (s.armed and s.site == site and s.index == index):
                continue
            s.armed = False
            telemetry.current().event(
                "fault_injected", spec=s.raw, site=site, index=index,
                artifact=path)
            integrity.damage_artifact(path, s.action)
            return s.action
        return None


_injector: FaultInjector | None = None
_injector_src: str | None = None


def injector() -> FaultInjector:
    """The process-wide injector, rebuilt (counters and armed state
    reset) whenever the CPR_FAULT_INJECT value changes."""
    global _injector, _injector_src
    src = os.environ.get(FAULT_ENV_VAR, "")
    if _injector is None or src != _injector_src:
        _injector = FaultInjector(parse_fault_specs(src))
        _injector_src = src
    return _injector


def fault_point(site: str, index: int | None = None) -> str | None:
    """Mark a named fault-injection site (one dict lookup when
    CPR_FAULT_INJECT is unset)."""
    return injector().fire(site, index)


def artifact_fault_point(site: str, path: str,
                         index: int | None = None) -> str | None:
    """Mark a named artifact-write site, right after the artifact is
    durably at `path`."""
    return injector().fire_artifact(site, path, index)


# -- preemption --------------------------------------------------------------

_PREEMPT = {"requested": False, "reason": None}


def request_preempt(reason: str = "signal"):
    _PREEMPT["requested"] = True
    _PREEMPT["reason"] = reason


def preempt_requested() -> bool:
    return _PREEMPT["requested"]


def preempt_reason() -> str | None:
    return _PREEMPT["reason"]


@contextmanager
def preemption_guard(signals=(signal.SIGTERM, signal.SIGINT)):
    """Install SIGTERM/SIGINT handlers that request a cooperative stop
    instead of unwinding mid-work. The flag is cleared on entry and
    polled by the loops; previous handlers are restored on exit. Off the
    main thread (where Python forbids signal handlers) it is a plain
    flag guard."""
    _PREEMPT["requested"] = False
    _PREEMPT["reason"] = None
    prev = {}
    if threading.current_thread() is threading.main_thread():
        def handler(signum, frame):
            request_preempt(signal.Signals(signum).name)
        for s in signals:
            prev[s] = signal.signal(s, handler)
    try:
        yield _PREEMPT
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
