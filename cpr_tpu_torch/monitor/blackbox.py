"""Crash flight recorder: dump telemetry's in-process event ring.

Port of cpr_tpu/monitor/blackbox.py, host only: the same code with its imports
from cpr_tpu_torch.

`cpr_tpu_torch.telemetry` keeps the last N emitted events in a bounded ring
(always on — one deque.append riding the emit path, sink or no sink).
This module turns that ring into a post-mortem artifact: one atomic
JSONL file, `blackbox-<run_id>-<pid>.jsonl`, whose first line is a
fresh run manifest (backend-bearing, so `tools/trace_summary.py
--validate` accepts the dump standalone) followed by the recorded
events oldest-first.  The write goes through
`resilience.atomic_write_text` — a dump can be torn by a second crash
mid-write, but the published file never can.

Dump triggers (wired in this PR): preemption drains, supervisor
escalations, unhandled exceptions unwinding the serve/router mains,
and `CPR_FAULT_INJECT` kills (InjectedKill unwinds like the crash it
stands in for, so the main-wrapper trigger catches it).  `dump_blackbox`
itself never raises — a broken dump on a crash path must not mask the
original failure — and returns the path written, or None.

The ring lives in telemetry and the dump here because of the import
order: resilience imports telemetry, so telemetry cannot import
resilience back for the atomic write.
"""

from __future__ import annotations

import json
import logging
import os

from cpr_tpu_torch import resilience, telemetry

log = logging.getLogger(__name__)

# where dumps land: $CPR_BLACKBOX_DIR, else ./runs (next to the perf
# ledger and the smoke artifacts)
BLACKBOX_DIR_ENV_VAR = "CPR_BLACKBOX_DIR"
DEFAULT_BLACKBOX_DIR = "runs"


def blackbox_dir() -> str:
    return os.environ.get(BLACKBOX_DIR_ENV_VAR) or DEFAULT_BLACKBOX_DIR


def blackbox_path(dest_dir: str | None = None) -> str:
    """This process's dump path: one file per (run, pid), so a fleet's
    replicas never clobber each other's blackboxes."""
    d = dest_dir or blackbox_dir()
    return os.path.join(
        d, f"blackbox-{telemetry.run_id()}-{os.getpid()}.jsonl")


def dump_blackbox(reason: str, dest_dir: str | None = None) -> str | None:
    """Write the flight-recorder ring to the blackbox file.  Header
    manifest first (its config carries the dump reason + ring stats),
    then the recorded tail oldest-first.  Never raises; returns the
    written path or None."""
    try:
        events = telemetry.blackbox_events()
        man = telemetry.run_manifest(config=dict(
            entry="blackbox", reason=str(reason), pid=os.getpid(),
            n_events=len(events),
            capacity=telemetry.blackbox_capacity()))
        lines = [json.dumps(man, default=str)]
        lines += [json.dumps(e, default=str) for e in events]
        path = blackbox_path(dest_dir)
        resilience.atomic_write_text(path, "\n".join(lines) + "\n")
        return path
    except Exception as e:  # noqa: BLE001 — the dump rides crash
        # paths: it must never mask the failure it is recording
        log.warning("blackbox dump failed: %r", e)
        return None
