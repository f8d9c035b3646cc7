"""TSV sweep output (port of cpr_tpu/experiments/sweep.py).

Reference counterpart: the csv_runner row collection and `Info.pp_rows`
TSV printer (experiments/simulate/csv_runner.ml:16-29, lib/info.ml:26-60):
rows are typed key-value dicts; the writer unions all keys into one
header and prints row-major TSV, empty cells for missing keys.
"""

from __future__ import annotations

import io
from typing import Callable, Iterable

from cpr_tpu_torch.resilience import atomic_write_text
from cpr_tpu_torch.telemetry import now


def _fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def write_tsv(rows: Iterable[dict], path: str | None = None) -> str:
    """Serialize dict rows to TSV (union of keys, first-seen order).
    Writes to `path` when given; returns the TSV text either way."""
    rows = list(rows)
    cols: list[str] = []
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    buf = io.StringIO()
    buf.write("\t".join(cols) + "\n")
    for r in rows:
        buf.write("\t".join(_fmt(r.get(c)) for c in cols) + "\n")
    text = buf.getvalue()
    if path is not None:
        atomic_write_text(path, text)
    return text


def run_task(task: Callable[[], list[dict] | dict], ident: dict) -> list[dict]:
    """Run one sweep task, capturing failures as rows instead of raising.

    The reference's task farm records a failing simulation's error in its
    TSV row and carries on with the rest of the sweep
    (experiments/simulate/csv_runner.ml:83-102): one bad grid point must
    not kill a sweep. `ident` carries the identifying columns (protocol,
    alpha, ...) for the error row; successful tasks return their row(s)
    untouched. A task can attach a machine-readable `reason` to the
    exception it raises (default "runtime-error").
    """
    t0 = now()
    try:
        out = task()
        return out if isinstance(out, list) else [out]
    except KeyboardInterrupt:
        raise
    except Exception as e:  # noqa: BLE001 — a sweep degrades per task
        return [{**ident,
                 "error": f"{type(e).__name__}: {e}",
                 "reason": getattr(e, "reason", "runtime-error"),
                 "machine_duration_s": now() - t0}]
