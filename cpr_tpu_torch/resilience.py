"""Atomic and sealed artifact writes.

Reference counterpart: `cpr_tpu/resilience.py`, the part the solve
caches use: `atomic_write_bytes`/`atomic_write_json` (tmp file in the
destination directory, fsync, `os.replace`), `atomic_write_text` (the
GraphML topology batches) and the sealed seam `sealed_write`/
`sealed_write_json`/`sealed_read`/`sealed_read_json`/
`reject_undecodable` over `cpr_tpu_torch.integrity`'s envelope. A
damaged envelope is quarantined with one typed `integrity` event and
raises `IntegrityError` for the caller's policy (a cache recomputes).

Not ported (ROADMAP item 6): fault injection and the artifact-damage
fault points (`site=` is accepted and names the write site, but no
fault is ever armed), retries with backoff, preemption handling, and
the VI, grid and compile checkpoints built on them.
"""

from __future__ import annotations

import json
import os
import tempfile

from cpr_tpu_torch import integrity
from cpr_tpu_torch.integrity import IntegrityError

__all__ = ["IntegrityError", "atomic_write_bytes", "atomic_write_json",
           "atomic_write_text",
           "reject_undecodable", "sealed_read", "sealed_read_json",
           "sealed_write", "sealed_write_json"]


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
    `site` names the write site (no fault injection in the port)."""
    del site
    atomic_write_bytes(path, integrity.seal(data, schema=schema))


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
