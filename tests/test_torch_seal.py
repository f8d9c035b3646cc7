"""The port's sealed artifacts against the JAX package's: the envelope
is byte-identical, so an artifact sealed by either package unseals in
the other; damage is detected, typed, quarantined and reported."""

import io
import json
import os

import pytest

from cpr_tpu import integrity as J_integrity
from cpr_tpu import resilience as J_resilience
from cpr_tpu_torch import integrity, resilience, telemetry

PAYLOADS = [b"", b"x", b'{"a": [1, 2, 3]}\n', bytes(range(256)) * 7]


@pytest.mark.parametrize("payload", PAYLOADS, ids=["empty", "byte",
                                                   "json", "binary"])
def test_envelopes_cross_both_ways(payload):
    ours, theirs = integrity.seal(payload), J_integrity.seal(payload)
    assert ours == theirs
    assert integrity.unseal(theirs) == (payload, "verified")
    assert J_integrity.unseal(ours) == (payload, "verified")
    # an unsealed (older) artifact passes through, tagged unverified
    assert integrity.unseal(payload)[1] == "unverified"


def test_sealed_files_cross_both_ways(tmp_path):
    obj = {"key": {"kind": "mdp_grid"}, "value": {"revenue": [0.25, 0.3]}}
    a, b = tmp_path / "port.json", tmp_path / "jax.json"
    resilience.sealed_write_json(str(a), obj, site="cache")
    J_resilience.sealed_write_json(str(b), obj, site="cache")
    assert a.read_bytes() == b.read_bytes()
    assert J_resilience.sealed_read_json(str(a)) == (obj, "verified")
    assert resilience.sealed_read_json(str(b)) == (obj, "verified")


@pytest.mark.parametrize("damage", ["flip", "truncate", "garble",
                                    "schema"])
def test_damage_raises_quarantines_and_reports(tmp_path, damage):
    path = tmp_path / "entry.json"
    J_resilience.sealed_write_json(str(path), {"value": [1, 2, 3]})
    data = bytearray(path.read_bytes())
    if damage == "flip":
        data[-1] ^= 0xFF
        reason = "checksum"
    elif damage == "truncate":
        data = data[:len(data) // 2]
        reason = "truncated"
    elif damage == "garble":
        body = b'{"garbled": '
        data = bytearray(integrity.seal(body))
        reason = "truncated"
    else:
        data = bytearray(data.replace(b"CPRSEAL1 1 ", b"CPRSEAL1 9 ", 1))
        reason = "version"
    path.write_bytes(bytes(data))
    sink = io.StringIO()
    telemetry.configure(stream=sink)
    try:
        with pytest.raises(integrity.IntegrityError) as err:
            resilience.sealed_read_json(str(path), kind="mdp_grid_cache",
                                        action="regenerated")
    finally:
        telemetry.configure(None)
    assert err.value.reason == reason
    assert err.value.artifact == str(path)
    assert not path.exists()
    qdir = integrity.quarantine_dir(str(path))
    assert os.listdir(qdir) == ["entry.json"]
    events = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert [(e["name"], e["artifact_kind"], e["reason"], e["action"])
            for e in events] == [("integrity", "mdp_grid_cache", reason,
                                  "regenerated")]


def test_atomic_write_replaces_whole_files(tmp_path):
    path = tmp_path / "sub" / "f.json"
    resilience.atomic_write_json(str(path), {"a": 1})
    resilience.atomic_write_bytes(str(path), b"second")
    assert path.read_bytes() == b"second"
    assert os.listdir(path.parent) == ["f.json"]


def test_reject_undecodable_quarantines(tmp_path):
    path = tmp_path / "old.bin"
    path.write_bytes(b"not a pickle")
    err = resilience.reject_undecodable(str(path), kind="snapshot",
                                        err="bad magic")
    assert isinstance(err, integrity.IntegrityError)
    assert err.reason == "truncated" and not path.exists()
