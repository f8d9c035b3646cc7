"""The child side of supervised subprocesses (port of the child half of
cpr_tpu/supervisor.py).

A supervised child (the serve and learner mains) marks its phases with
`child_phase(...)` and, when its parent asked for one by setting
`CPR_SUPERVISOR_HEARTBEAT_S`, runs a daemon thread that writes one JSON
beat a period to stderr: `{"kind": "hb", "t", "phase", "n_events",
"pid"}`, `phase` the innermost `child_phase` marker or open telemetry
span, `n_events` the telemetry emit counter (the parent's progress
signal). `restart_count()` reads how many warm restarts preceded this
process (`CPR_SUPERVISOR_RESTART`).

The parent side (`run_child`, `supervise`, `probe`, the heartbeat
monitor and its warm-restart retry) is ROADMAP item 14 and raises.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager

from cpr_tpu_torch import telemetry
from cpr_tpu_torch.telemetry import now

HEARTBEAT_ENV_VAR = "CPR_SUPERVISOR_HEARTBEAT_S"
RESTART_ENV_VAR = "CPR_SUPERVISOR_RESTART"

_child_phases: list[str] = []
_beat_thread: threading.Thread | None = None


@contextmanager
def child_phase(name: str):
    """Mark a named phase for the heartbeat to report, around regions
    that hold no telemetry span but may be slow and silent (start-up,
    kernel builds)."""
    _child_phases.append(name)
    try:
        yield
    finally:
        _child_phases.pop()


def current_phase() -> str | None:
    """What the next beat reports: the innermost `child_phase` marker,
    else the innermost open telemetry span path, else None."""
    try:
        return _child_phases[-1]
    except IndexError:
        return telemetry.current().span_path()


def restart_count() -> int:
    """How many warm restarts preceded this (child) process; 0 for a
    first attempt."""
    try:
        return int(os.environ.get(RESTART_ENV_VAR) or 0)
    except ValueError:
        return 0


def maybe_start_heartbeat(period_s: float | None = None, stream=None):
    """Start the child-side beat thread if the parent asked for one
    (CPR_SUPERVISOR_HEARTBEAT_S in the environment, or an explicit
    period). Idempotent; returns the thread or None. The thread writes
    to stderr (or `stream`) and stops when the stream closes."""
    global _beat_thread
    if period_s is None:
        raw = os.environ.get(HEARTBEAT_ENV_VAR, "")
        try:
            period_s = float(raw) if raw else 0.0
        except ValueError:
            period_s = 0.0
    if period_s <= 0:
        return None
    if _beat_thread is not None and _beat_thread.is_alive():
        return _beat_thread

    def beat():
        while True:
            line = json.dumps({
                "kind": "hb", "t": round(now(), 3),
                "phase": current_phase(),
                "n_events": telemetry.current().n_emitted,
                "pid": os.getpid()})
            try:
                out = stream if stream is not None else sys.stderr
                out.write(line + "\n")
                out.flush()
            except (OSError, ValueError):
                return  # parent gone / stream closed: stop beating
            time.sleep(period_s)

    _beat_thread = threading.Thread(target=beat, name="cpr-heartbeat",
                                    daemon=True)
    _beat_thread.start()
    return _beat_thread


def _parent_side(what):
    return NotImplementedError(
        f"supervisor.{what}: the supervisor's parent side is not ported "
        "to cpr_tpu_torch yet (ROADMAP item 14)")


def run_child(*args, **kwargs):
    raise _parent_side("run_child")


def supervise(*args, **kwargs):
    raise _parent_side("supervise")


def probe(*args, **kwargs):
    raise _parent_side("probe")
