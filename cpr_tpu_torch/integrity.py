"""Artifact integrity: checksummed envelopes and corruption quarantine.

Reference counterpart: `cpr_tpu/integrity.py`, its sealed-envelope
subset (`IntegrityError`, `integrity_event`, `seal`/`is_sealed`/
`unseal`, `quarantine_dir`/`quarantine`), copied. The envelope is byte
for byte the reference's, so an artifact sealed by either package
unseals in the other:

    b"CPRSEAL1 <schema> <length> <sha256hex>\\n" + payload

A damaged artifact is never deserialized: `quarantine` moves it (and
its sidecars) to `<path>.quarantine/` and emits one typed `integrity`
event. `damage_artifact` is the fault injector's storage-corruption
stand-in (`resilience.artifact_fault_point`); the chaos schedules are not
ported (ROADMAP item 6).
"""

from __future__ import annotations

import hashlib
import os

from cpr_tpu_torch import telemetry

SEAL_MAGIC = b"CPRSEAL1"
SEAL_SCHEMA = 1

REASONS = ("checksum", "truncated", "version", "sidecar_missing")
ACTIONS = ("quarantined", "regenerated", "refused")
# the fault grammar's artifact-damage actions (resilience.FaultSpec)
ARTIFACT_ACTIONS = ("corrupt", "truncate", "garble_json")


class IntegrityError(Exception):
    """A persisted artifact failed verification; carries the artifact
    path, its kind and the typed reason (one of REASONS)."""

    def __init__(self, message: str, *, artifact: str, kind: str,
                 reason: str):
        super().__init__(message)
        self.artifact = artifact
        self.kind = kind
        self.reason = reason


def integrity_event(*, artifact: str, kind: str, reason: str,
                    action: str, **extra):
    """Emit one typed `integrity` event. The artifact family travels as
    `artifact_kind`: `kind` is the telemetry envelope's discriminator."""
    telemetry.current().event("integrity", artifact=artifact,
                              artifact_kind=kind, reason=reason,
                              action=action, **extra)


# -- sealed envelope ---------------------------------------------------------


def seal(payload: bytes, *, schema: int = SEAL_SCHEMA) -> bytes:
    """Wrap payload bytes in the checksummed envelope."""
    digest = hashlib.sha256(payload).hexdigest()
    header = b"%s %d %d %s\n" % (SEAL_MAGIC, schema, len(payload),
                                 digest.encode())
    return header + payload


def is_sealed(data: bytes) -> bool:
    return data.startswith(SEAL_MAGIC + b" ")


def unseal(data: bytes, *, artifact: str = "<bytes>",
           kind: str = "artifact") -> tuple[bytes, str]:
    """Verify and strip the envelope. Returns (payload, tag): tag
    "verified" for an intact envelope, "unverified" for an unsealed
    (older) artifact, passed through for its deserializer to judge.
    Raises IntegrityError with a typed reason when the envelope is
    present but the bytes behind it are damaged."""
    if not is_sealed(data):
        return data, "unverified"
    nl = data.find(b"\n")
    if nl < 0:
        raise IntegrityError(
            f"{kind} {artifact}: sealed header is torn (no payload)",
            artifact=artifact, kind=kind, reason="truncated")
    try:
        _, schema_s, length_s, digest = data[:nl].decode().split(" ")
        schema, length = int(schema_s), int(length_s)
    except ValueError:
        raise IntegrityError(
            f"{kind} {artifact}: sealed header is malformed",
            artifact=artifact, kind=kind, reason="truncated") from None
    if schema > SEAL_SCHEMA:
        raise IntegrityError(
            f"{kind} {artifact}: sealed with schema {schema}, this "
            f"build reads <= {SEAL_SCHEMA}",
            artifact=artifact, kind=kind, reason="version")
    payload = data[nl + 1:]
    if len(payload) != length:
        raise IntegrityError(
            f"{kind} {artifact}: payload is {len(payload)} bytes, "
            f"header promises {length} (truncated or torn write)",
            artifact=artifact, kind=kind, reason="truncated")
    got = hashlib.sha256(payload).hexdigest()
    if got != digest:
        raise IntegrityError(
            f"{kind} {artifact}: sha256 mismatch — header has "
            f"{digest[:12]}…, payload hashes to {got[:12]}… (bytes "
            f"corrupted on disk)",
            artifact=artifact, kind=kind, reason="checksum")
    return payload, "verified"


# -- quarantine --------------------------------------------------------------


def quarantine_dir(path: str) -> str:
    return path + ".quarantine"


def quarantine(path: str, *, kind: str, reason: str,
               action: str = "quarantined", sidecars=(".json",),
               emit: bool = True) -> str | None:
    """Move a corrupt artifact (and any existing sidecars) into
    `<path>.quarantine/`, where it is kept for inspection and never
    read again, and emit the typed `integrity` event. Returns the
    quarantined path (None when the artifact vanished meanwhile; the
    event still fires)."""
    qdir = quarantine_dir(path)
    dest = None
    base = os.path.basename(path)
    try:
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, base)
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = os.path.join(qdir, f"{base}.{n}")
        os.replace(path, dest)
    except OSError:
        dest = None
    for ext in sidecars:
        side = path + ext
        if os.path.exists(side):
            try:
                os.replace(side, os.path.join(
                    qdir, os.path.basename(dest or side) + ext))
            except OSError:
                pass
    if emit:
        integrity_event(artifact=path, kind=kind, reason=reason,
                        action=action, quarantine=dest)
    return dest


def damage_artifact(path: str, action: str):
    """Deterministically damage an on-disk artifact in place — the
    storage-corruption stand-ins the fault grammar arms (`corrupt@`,
    `truncate@`, `garble_json@`). Deliberately not atomic: real
    corruption isn't."""
    size = os.path.getsize(path)
    if action == "corrupt":
        # flip the last byte — always inside the sealed payload, so the
        # digest check (not just a decode error) is what must catch it
        with open(path, "r+b") as f:
            f.seek(max(size - 1, 0))
            tail = f.read(1) or b"\0"
            f.seek(max(size - 1, 0))
            f.write(bytes([tail[0] ^ 0xFF]))
    elif action == "truncate":
        os.truncate(path, size // 2)
    elif action == "garble_json":
        with open(path, "r+b") as f:
            f.write(b'{"garbled": ')
            f.truncate()
    else:
        raise ValueError(f"unknown artifact damage action {action!r}")
